"""Where a block of the spatial-table kernel's fast instance spends its time.

    python -m kstar_torch.analysis.profile_spatial_table [--frames 4096] [--seed 0]

Profilers that read a kernel's inside do not run on every machine, so this
builds throw-away variants of ``csrc/spatial_table.cu`` and reads two things
at the flagship widths (21 offsets, N 65, D 128, 4 heads x 64, MLP 1024,
depth 2, bf16, random weights from --seed), on the card it runs on:

* the phase profile: a ``-DKSTAR_PROFILE`` build in which thread 0 of every
  block adds its ``clock64()`` cycles per phase to a counter (the phases are
  ``enum Phase`` in the source); printed as mean cycles per block and share.
  It is warp 0's view, and a phase's time includes the wait at the barrier
  that ends it;
* ablations: whole-kernel CUDA-event times of builds with one piece of work
  taken out by a one-line source substitution (results then differ, only the
  time is read). A phase's share in the profile is what warp 0 waits for it;
  an ablation says what the kernel gains without it. The two differ where
  other warps' work hides behind a phase.

Prints one JSON line per reading and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

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
    "no LayerNorm": ("  for (int r0 = warp * 4; r0 < rows; r0 += kWarps * 4) {",
                     "  for (int r0 = warp * 4; r0 < rows && scale == nullptr; r0 += kWarps * 4) {"),
    "no attention in the all-row layers": (
        "        for (int s = warp; s < F * spf; s += kWarps) {",
        "        for (int s = warp; s < F * spf && p.T < 0; s += kWarps) {"),
}
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def event_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_spatial_table: CUDA is not available", file=sys.stderr)
        return 1
    from kstar_torch.config import ViViTConfig
    from kstar_torch.models import build_video_model
    from kstar_torch.ops import _build
    from kstar_torch.ops import spatial_table as st

    cfg, n_off, dev = ViViTConfig(), 21, torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    model = build_video_model("ViViT", cfg, dtype=torch.bfloat16, generator=gen).to(dev)
    n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
    M = cfg.dim * cfg.scale_dim
    tokens = F.pad(torch.randn(args.frames, n_tok - 1, cfg.dim, generator=gen), (0, 0, 1, 0))
    tokens = tokens.to(dev, torch.bfloat16)
    w = st.extract_spatial_weights(model, n_off, cfg.depth, torch.bfloat16)
    wmat = st.pack_fast(w, cfg.depth, cfg.n_heads).to(dev)
    wln = st.pack_layer_norms(w, cfg.depth).to(dev)
    base = w.base[:n_off, :n_tok].to(dev, torch.bfloat16).contiguous()
    out = torch.empty(n_off, args.frames, cfg.dim, device=dev, dtype=torch.bfloat16)
    frames_per_block = st.fast_frames_per_block(n_tok)
    blocks = -(-args.frames // frames_per_block) * n_off

    def runner(lib):
        fn = lib.spatial_table_bf16
        fn.argtypes = ARGTYPES

        def run():
            err = fn(tokens.data_ptr(), base.data_ptr(), wmat.data_ptr(), wln.data_ptr(),
                     out.data_ptr(), args.frames, n_off, n_tok, cfg.dim, cfg.depth,
                     cfg.n_heads, cfg.d_head, M, cfg.d_head ** -0.5, None)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        return run

    source = (_build.CSRC / "spatial_table.cu").read_text()
    variants = {"as shipped": source}
    for name, (line, repl) in ABLATIONS.items():
        if source.count(line) != 1:
            raise RuntimeError(f"ablation {name!r}: the line it replaces occurs "
                               f"{source.count(line)} times in spatial_table.cu: {line!r}")
        variants[name] = source.replace(line, repl)
    for i, (name, text) in enumerate(variants.items()):
        lib = ctypes.CDLL(str(_build.build_variant("spatial_table", f"ablate{i}",
                                                   source_text=text)))
        print(json.dumps({"reading": "kernel_ms", "variant": name,
                          "ms": event_ms(runner(lib)), "frames": args.frames}), flush=True)

    lib = ctypes.CDLL(str(_build.build_variant("spatial_table", "profile", ("-DKSTAR_PROFILE",))))
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
    print(json.dumps({"reading": "phase_profile", "frames_per_block": frames_per_block,
                      "blocks": blocks, "cycles_per_block": total / blocks,
                      "phases": {name: {"cycles_per_block": c / blocks, "share": c / total}
                                 for name, c in zip(PHASES, cycles)}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
