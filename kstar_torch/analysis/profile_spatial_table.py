"""Where a block of the spatial-table kernel's fast instance spends its time.

    python -m kstar_torch.analysis.profile_spatial_table
        [--widths flagship|demo|full_frame|f32] [--crop px] [--frames T] [--seed 0]
        [--baseline path/to/spatial_table.cu]

Profilers that read a kernel's inside do not run on every machine, so this
builds throw-away variants of ``csrc/spatial_table.cu`` and reads them at
one of the fast instance's widths (21 offsets, depth 2, bf16, random
weights from --seed), on the card it runs on: ``flagship`` (N 65, D 128, 4
heads x 64, MLP 1024, 4096 frames by default), ``demo``
(``exp/demo_vivit.sh``'s ViViT: N 17, D 64, 4 heads x 32, MLP 256, 2520
frames by default) or ``full_frame`` (the flagship widths at image_size
256: N 257, one frame per two-block cluster, or with ``--crop`` a smaller
crop of it, 160 px for N 101 on one block; 512 frames by default), or
``f32`` (the flagship widths in f32 on the f32 instance, products in split
TF32; 4096 frames by default; with ``--crop`` 144 .. 256 one frame over an
f32 cluster, N 82 .. 257; variants only, its source has no phase stamps):

* the phase profile: a ``-DKSTAR_PROFILE`` build in which thread 0 of every
  block adds its ``clock64()`` cycles per phase to a counter (the phases are
  ``enum Phase`` in the source); printed as mean cycles per block and share.
  It is warp 0's view, and a phase's time includes the wait at the barrier
  that ends it;
* variants: whole-kernel CUDA-event times of builds with one piece of work
  taken out by a one-line source substitution (results then differ, only the
  time is read), of the other row schemes the width could have (for the f32
  cluster its other register schemes), and of
  ``--baseline`` (another version of the source, an earlier commit's say),
  taken round-robin ``REPEATS`` times so that they share the card's
  state. A phase's share in the profile is what warp 0 waits for it; an
  ablation says what the kernel gains without it. The two differ where
  other warps' work hides behind a phase.

Prints one JSON line per reading and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

PHASES = ("other", "panel wait + barrier", "layer norm", "attention", "residual + barrier",
          "all rows: q|k", "all rows: v + barrier", "all rows: out-projection",
          "all rows: FF1 + GELU", "all rows: FF2",
          "last layer: k + cls q", "last layer: cls out-projection", "last layer: cls FF1",
          "last layer: cls FF2")
# name -> (source line, its replacement): each takes one piece of work out
ABLATIONS = {
    "GELU as identity": ("  return __fdividef(x, 1.f + __expf(-2.f * u));",
                         "  return x + 0.f * u;"),
    "no LayerNorm": (
        "  for (int r0 = warp * kPerWarp; r0 < rows; r0 += S::kWarps * kPerWarp) {",
        "  for (int r0 = warp * kPerWarp; r0 < rows && scale == nullptr; "
        "r0 += S::kWarps * kPerWarp) {"),
    "no attention in the all-row layers": (
        "        for (int s = warp; s < n_strips; s += kWarps) {",
        "        for (int s = warp; s < n_strips && p.T < 0; s += kWarps) {"),
}
# the f32 instance's: the split (three TF32 products per product, in
# attn_core.cuh, which the source includes), its attention, its GELU, and
# every product summed a k step at a time (from zero on the tensor core,
# then an f32 add)
F32_ABLATIONS = {
    "one TF32 product (hi hi) instead of three": (
        "  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", ""),
    "GELU as identity": (
        "  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x))));",
        "  return x;"),
    "every product summed by k step": (
        "  mma_tf32x3(c, ah, al, b.hi[2 * s], b.hi[2 * s + 1], b.lo[2 * s], b.lo[2 * s + 1]);\n",
        "  float d[4] = {0.f, 0.f, 0.f, 0.f};\n"
        "  mma_tf32x3(d, ah, al, b.hi[2 * s], b.hi[2 * s + 1], b.lo[2 * s], b.lo[2 * s + 1]);\n"
        "  for (int i = 0; i < 4; ++i) c[i] += d[i];\n"),
}
# packed frames (N <= 80) only: its all-row attention, and the attention
# scores summed by k step
F32_PACKED_ABLATIONS = {
    "no attention in the all-row layers": (
        "          for (int s = warp; s < strips; s += kWarps) {",
        "          for (int s = warp; s < strips && p.T < 0; s += kWarps) {"),
    "attention scores summed by k step (kStepSums)": (
        "  attn_strip_block_f32<S::kDh, KT16, true, false>(q_rows,",
        "  attn_strip_block_f32<S::kDh, KT16, true, true>(q_rows,"),
}
# one frame over a cluster (N > 80) only: its all-row attention, its scores
# kept in the MMA's accumulator, the last layer's cls attention, and the keys
# read from the block's own shared memory instead of the other blocks' (what
# distributed shared memory costs; wrong results, the same work)
F32_CLUSTER_ABLATIONS = {
    "no attention in the all-row layers": (
        "          const bool active = s < strips;\n",
        "          const bool active = s < strips && p.T < 0;\n"),
    "cluster scores in the accumulator (running sums)": (
        "      attn_strip_block_f32<S::kDh, kClusterKeyTiles, false, true, true>(",
        "      attn_strip_block_f32<S::kDh, kClusterKeyTiles, false, false, true>("),
    "no attention in the last layer": (
        "          cls_attend_cluster();\n", "          if (p.T < 0) cls_attend_cluster();\n"),
    "keys from the block's own shared memory": (
        "  return reinterpret_cast<T*>(a);\n", "  return p;\n"),
}
# the f32 cluster's other register schemes (same results): a block's keys
# in one call of the attention core (64 keys: four times the scores in
# registers), with all of V's loads of a tile in flight or four of them,
# and two k blocks of each product in flight
_KEYS64 = ("constexpr int kClusterKeyTiles = 1;", "constexpr int kClusterKeyTiles = 4;")
_V4 = ("#pragma unroll\n      for (int dn = 0; dn < DH / 8; ++dn) {\n"
       "        const Split4 b = split4(ld4(vp + dn * 8 * ldvt + kt * 16));",
       "#pragma unroll 4\n      for (int dn = 0; dn < DH / 8; ++dn) {\n"
       "        const Split4 b = split4(ld4(vp + dn * 8 * ldvt + kt * 16));")
F32_CLUSTER_SCHEMES = {
    "keys 64 a call": [_KEYS64],
    "keys 64 a call, four V loads in flight": [_KEYS64, _V4],
    "two k blocks of each product in flight": [(
        "#pragma unroll 1\n    for (int kb = 0; kb < K / 16; ++kb) k_block(kb);",
        "#pragma unroll 2\n    for (int kb = 0; kb < K / 16; ++kb) k_block(kb);")],
}
# the widths, and the other row schemes each could be compiled with (same
# results, another number of frames per block)
WIDTHS = {"flagship": dict(), "demo": dict(image_size=64, dim=64, n_heads=4, d_head=32,
                                           scale_dim=4),
          "full_frame": dict(image_size=256), "f32": dict()}
DEFAULT_FRAMES = {"flagship": 4096, "demo": 2520, "full_frame": 512, "f32": 4096}
ROW_SCHEMES = {
    "flagship": {}, "f32": {},
    "demo": {"four wgmma warpgroups (F = 15 at N 17, one block per SM)": (
        "using Demo = Shape<64, 32, 64, 2, 0>;", "using Demo = Shape<64, 32, 64, 4, 0>;")},
    "full_frame": {
        "two-block cluster from N 81 (no one-block instance)": (
            "constexpr int kOneBlockMaxN = 144;", "constexpr int kOneBlockMaxN = 80;"),
        "two-pass key blocks of 32": (
            "constexpr int kKeyTiles = 4;", "constexpr int kKeyTiles = 2;"),
    },
}
REPEATS = 5
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def event_ms(fn, iters: int = 3) -> float:
    """Mean device time of fn() over iters launches, queued behind a device
    busy-wait so that the host's enqueueing is not what is timed."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def substituted(source: str, name: str, line: str, repl: str) -> str:
    if source.count(line) != 1:
        raise RuntimeError(f"variant {name!r}: the line it replaces occurs "
                           f"{source.count(line)} times in spatial_table.cu: {line!r}")
    return source.replace(line, repl)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--widths", choices=list(WIDTHS), default="flagship")
    parser.add_argument("--crop", type=int, default=None,
                        help="crop of the widths' image size (patch 16), N = (crop/16)^2 + 1")
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another spatial_table.cu to time beside the shipped one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_spatial_table: CUDA is not available", file=sys.stderr)
        return 1
    from kstar_torch.config import ViViTConfig
    from kstar_torch.models import build_video_model
    from kstar_torch.ops import _build
    from kstar_torch.ops import spatial_table as st

    frames = args.frames or DEFAULT_FRAMES[args.widths]
    cfg, n_off, dev = ViViTConfig(**WIDTHS[args.widths]), 21, torch.device("cuda")
    if args.crop and args.crop > cfg.image_size:
        # a positional embedding that covers the crop's tokens
        cfg = ViViTConfig(**{**WIDTHS[args.widths], "image_size": args.crop})
    f32 = args.widths == "f32"
    cd = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator().manual_seed(args.seed)
    model = build_video_model("ViViT", cfg, dtype=cd, generator=gen).to(dev)
    n_tok = ((args.crop or cfg.image_size) // cfg.patch_size) ** 2 + 1
    M = cfg.dim * cfg.scale_dim
    tokens = F.pad(torch.randn(frames, n_tok - 1, cfg.dim, generator=gen), (0, 0, 1, 0))
    tokens = tokens.to(dev, cd)
    w = st.extract_spatial_weights(model, n_off, cfg.depth, cd)
    wmat = {0: st.pack_general(w, cfg.depth, cd).to(dev)}
    wln = st.pack_layer_norms(w, cfg.depth).to(dev)
    base = w.base[:n_off, :n_tok].to(dev, cd).contiguous()
    out = torch.empty(n_off, frames, cfg.dim, device=dev, dtype=cd)
    inst = st.fast_instance(cfg.dim, cfg.d_head, n_tok, cd)
    frames_per_block = st.fast_frames_per_block(n_tok, cfg.dim, cfg.d_head, cd)
    blocks = -(-frames // frames_per_block) * n_off * inst.cluster
    widths = dict(widths=args.widths, frames=frames, N=n_tok, D=cfg.dim,
                  d_head=cfg.d_head, mlp=M, dtype=str(cd).split(".")[1])

    def runner(lib):
        fn = lib.spatial_table_f32 if f32 else lib.spatial_table_bf16
        fn.argtypes = ARGTYPES
        plan = lib.spatial_table_plan
        plan.argtypes = [ctypes.c_int] * 6
        dims = (n_tok, cfg.dim, cfg.n_heads, cfg.d_head, M, 4 if f32 else 2)
        # an earlier source may take these widths on its general instance,
        # or pack its stream in the one MLP chunk of its width
        chunk = 0
        if plan(*dims) > 0:
            chunk = st.fast_instance(cfg.dim, cfg.d_head, dtype=cd).mlp_chunk
            if hasattr(lib, "spatial_table_mlp_chunk"):
                lib.spatial_table_mlp_chunk.argtypes = [ctypes.c_int] * 6
                chunk = lib.spatial_table_mlp_chunk(*dims)
        if chunk not in wmat:
            wmat[chunk] = st.pack_fast(w, cfg.depth, cfg.n_heads, cd, mlp_chunk=chunk,
                                       layout=inst.layout).to(dev)
        packed = wmat[chunk]

        def run():
            err = fn(tokens.data_ptr(), base.data_ptr(), packed.data_ptr(), wln.data_ptr(),
                     out.data_ptr(), frames, n_off, n_tok, cfg.dim, cfg.depth,
                     cfg.n_heads, cfg.d_head, M, cfg.d_head ** -0.5, None)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        return run

    source = (_build.CSRC / "spatial_table.cu").read_text()
    variants = {"as shipped": source}
    if f32:
        # the source with attn_core.cuh written out in place, so that a line
        # of the header can be substituted too
        include = '#include "attn_core.cuh"'
        inlined = source.replace(include, (_build.CSRC / "attn_core.cuh").read_text())
        more = F32_CLUSTER_ABLATIONS if n_tok > st.PACKED_MAX_N else F32_PACKED_ABLATIONS
        for name, (line, repl) in {**F32_ABLATIONS, **more}.items():
            variants[name] = substituted(inlined, name, line, repl)
        if n_tok > st.PACKED_MAX_N:
            for name, pairs in F32_CLUSTER_SCHEMES.items():
                text = inlined
                for line, repl in pairs:
                    text = substituted(text, name, line, repl)
                variants[name] = text
    else:
        for name, (line, repl) in {**ABLATIONS, **ROW_SCHEMES[args.widths]}.items():
            variants[name] = substituted(source, name, line, repl)
    if args.baseline is not None:
        variants[f"baseline {args.baseline}"] = args.baseline.read_text()
    # one nvcc per variant and the profile build (none for the f32 instance,
    # which has no phase stamps), all at once
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        built = [pool.submit(_build.build_variant, "spatial_table", f"variant{i}",
                             source_text=text) for i, text in enumerate(variants.values())]
        profile_build = None if f32 else pool.submit(
            _build.build_variant, "spatial_table", "profile", ("-DKSTAR_PROFILE",))
        runs = {name: runner(ctypes.CDLL(str(b.result()))) for name, b in zip(variants, built)}
    readings = {name: [] for name in runs}
    for _ in range(REPEATS):
        for name, run in runs.items():
            readings[name].append(event_ms(run))
    for name, ms in readings.items():
        print(json.dumps({"reading": "kernel_ms", "variant": name, "ms": ms, **widths}),
              flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if profile_build is None:
        print(smi)
        return 0
    lib = ctypes.CDLL(str(profile_build.result()))
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
    lib.spatial_table_set_profile.argtypes = [ctypes.c_void_p]
    lib.spatial_table_set_profile(prof.data_ptr())
    run = runner(lib)
    run()
    torch.cuda.synchronize()
    prof.zero_()
    run()
    torch.cuda.synchronize()
    cycles = prof.tolist()
    total = sum(cycles)
    print(json.dumps({"reading": "phase_profile", **widths,
                      "frames_per_block": frames_per_block, "cluster": inst.cluster,
                      "blocks": blocks, "cycles_per_block": total / blocks,
                      "phases": {name: {"cycles_per_block": c / blocks, "share": c / total}
                                 for name, c in zip(PHASES, cycles)}}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
