#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (kstar_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--frames 4096]

Builds the hand-written kernels from kstar_torch/csrc, holds each against
its plain PyTorch version on the card, then drives the port's main path:
the stride-1 whole-shot sweep of the flagship ViViT (dim 128, depth 2,
4 heads x 64, MLP 1024, 128 px crop, 21-frame windows, bf16, random
weights from --seed) over a synthetic 4096-frame shot, followed by the
probability curve and its alarm. Every phase prints one JSON line and any
failure exits non-zero. Then come the per-kernel summary line, the card's
name and power limit as nvidia-smi reports them, and the result line
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

SEQ_LEN, CROP, RESIZE, BATCH = 21, 128, 256, 128
SMALL_CROP = 64                   # 16 patches + cls = 17 tokens
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor cores
                  "float32": 67e12}     # f32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events), after
    one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, atol: float, rtol: float, mean_tol: float) -> dict:
    """Elementwise |got - want| <= atol + rtol*|want| and a mean-error bound."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all() and (err <= atol + rtol * want.abs()).all()
              and err.mean() <= mean_tol)
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / want.abs().max().clamp_min(1e-30)),
            "mean_abs_err": float(err.mean()), "atol": atol, "rtol": rtol,
            "mean_tol": mean_tol, "ok": ok}


def bound(ops: float, nbytes: float, dtype: str) -> tuple:
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def table_work(T, n_off, N, D, depth, H, dh, M, elem):
    """Operations and bytes of one spatial-table call, counting only what
    the output needs: the table keeps the cls row after the final LN, so
    the last layer needs K and V for all N rows but the query, attention,
    out-projection and FF for row 0 alone. Each input read once, output
    once."""
    inner = H * dh
    full_layer = 2 * N * (D * 3 * inner + inner * D + D * M + M * D) + 4 * H * N * N * dh
    last_layer = (2 * N * D * 2 * inner                       # K, V: all rows
                  + 2 * (D * inner + inner * D + D * M + M * D)  # Q, out, FF: cls
                  + 4 * H * N * dh)                           # cls scores and AV
    ops = ((depth - 1) * full_layer + last_layer) * n_off * T
    weights = depth * (3 * inner * D + inner * D + D * M + M * D + 2 * D + M) * elem \
        + depth * 4 * D * 4 + 2 * D * 4
    nbytes = (T * N * D + n_off * N * D + n_off * T * D) * elem + weights
    return ops, nbytes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=4096)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from kstar_torch.config import FPS, PIXEL_MEAN_BGR, ViViTConfig
    from kstar_torch.infer import (VideoSweeper, alarm_times,
                                   predict_video_shot, warning_time)
    from kstar_torch.models import ViViT, build_video_model
    from kstar_torch.ops import _build
    from kstar_torch.ops.attention import (fused_attention,
                                           fused_attention_reference)
    from kstar_torch.ops.spatial_table import (extract_spatial_weights,
                                               spatial_table,
                                               spatial_table_reference)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    # ---- env ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("env", device=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build ----
    t0 = time.perf_counter()
    reports = _build.build()
    ptxas = [line.strip() for text in reports.values() for line in text.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         ptxas=ptxas)

    # ---- flagship model, shot and its tokens ----
    cfg = ViViTConfig()
    gen = torch.Generator().manual_seed(args.seed)
    model = build_video_model("ViViT", cfg, dtype=torch.bfloat16, generator=gen).to(dev)
    frames = np.random.default_rng(args.seed).integers(
        0, 255, size=(args.frames, RESIZE, RESIZE, 3), dtype=np.uint8)
    sweeper = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16, device=dev)
    frames_dev = sweeper.upload_shot(frames)
    tokens = F.pad(sweeper.embed_tokens(frames_dev), (0, 0, 1, 0))   # (T, 65, D)
    small = VideoSweeper(model, SEQ_LEN, SMALL_CROP, BATCH, torch.bfloat16, device=dev)
    tokens_small = F.pad(small.embed_tokens(small.upload_shot(frames[:64])),
                         (0, 0, 1, 0))                               # (64, 17, D)
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    M = cfg.dim * cfg.scale_dim

    # ---- kernels: each against its plain version ----
    checks = []
    # bf16 tolerance: kernel and plain version round to bf16 (8 significant
    # bits) at the same points but sum in another order, so an intermediate
    # may land one bf16 ulp (2^-8 relative) apart and carry that through two
    # layers; after the final LayerNorm the outputs are O(1), so isolated
    # elements may differ by a few 2^-8 while the mean error stays below one
    # ulp at 1.0. f32: the same algorithm, differing only in summation order.
    TOL = {"bfloat16": (6.25e-2, 6.25e-2, 2 ** -8), "float32": (1e-4, 1e-4, 1e-5)}
    for label, toks, cd, iters in (
            ("flagship T=4096 bf16 (main path)", tokens, torch.bfloat16, 3),
            ("flagship T=64 f32", tokens[:64], torch.float32, 5),
            ("flagship T=64 bf16", tokens[:64], torch.bfloat16, 10),
            ("small crop N=17 T=64 bf16", tokens_small, torch.bfloat16, 10)):
        w = extract_spatial_weights(model, SEQ_LEN, cfg.depth, cd)
        x = toks.to(cd)
        run = lambda: spatial_table(x, w, SEQ_LEN, compute_dtype=cd, **hp)
        plain = lambda: spatial_table_reference(x, w, SEQ_LEN, compute_dtype=cd, **hp)
        got, want = run(), plain()
        torch.cuda.synchronize()
        dt = str(cd).split(".")[1]
        res = compare(got, want, *TOL[dt])
        T, N, D = x.shape
        ops, nbytes = table_work(T, SEQ_LEN, N, D, cfg.depth, cfg.n_heads,
                                 cfg.d_head, M, x.element_size())
        bound_ms, bound_by = bound(ops, nbytes, dt)
        checks.append(dict(
            name="spatial_table", case=label, dtype=dt, shape=list(x.shape),
            route="cuda", source="kstar_torch/csrc/spatial_table.cu",
            replaces="kstar_tpu/ops/spatial_table.py:371", **res,
            ms=time_ms(run, iters), plain_ms=time_ms(plain, max(iters // 3, 1)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        emit("kernel_check", **checks[-1])

    g = torch.Generator(device=dev).manual_seed(args.seed)
    for shape in ((8 * SEQ_LEN, cfg.n_heads, 65, cfg.d_head),
                  (8, cfg.n_heads, SEQ_LEN + 1, cfg.d_head)):
        for cd in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(cd)
                       for _ in range(3))
            scale = cfg.d_head ** -0.5
            dt = str(cd).split(".")[1]
            got = fused_attention(q, k, v, scale)
            want = fused_attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            # f32: online vs two-pass softmax, summation order only; bf16:
            # both compute in f32 and round once, so at most one bf16 ulp
            tol = (2e-5, 2e-5, 1e-6) if dt == "float32" else (1e-2, 1e-2, 1e-3)
            res = compare(got, want, *tol)
            BH, N, D = shape[0] * shape[1], shape[2], shape[3]
            bound_ms, bound_by = bound(4.0 * BH * N * N * D, 4.0 * BH * N * D * q.element_size(), dt)
            checks.append(dict(
                name="fused_attention", case=f"{list(shape)} {dt}", dtype=dt,
                shape=list(shape), route="cuda", source="kstar_torch/csrc/attention.cu",
                replaces="kstar_tpu/ops/attention.py:60", **res,
                ms=time_ms(lambda: fused_attention(q, k, v, scale), 50),
                plain_ms=time_ms(lambda: fused_attention_reference(q, k, v, scale), 50),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 50)))
            emit("kernel_check", **checks[-1])
    failures += [f"{c['name']} {c['case']}" for c in checks if not c["ok"]]

    # ---- sweep: the main path ----
    n_windows = args.frames - SEQ_LEN - 1
    starts = np.arange(n_windows, dtype=np.int64)
    sweeper.sweep_device(frames_dev, starts)                 # warm-up
    torch.cuda.synchronize()
    spatial_table.launches = fused_attention.launches = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs = sweeper.sweep_device(frames_dev, starts)    # ends in a host copy
        walls.append(time.perf_counter() - t0)
    launches = {"spatial_table": spatial_table.launches,
                "fused_attention": fused_attention.launches}
    sweep_s = float(np.median(walls))

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    w_main = extract_spatial_weights(model, SEQ_LEN, cfg.depth, torch.bfloat16)
    table = sweeper.embed_all(frames_dev)
    phases = {"embed_ms": wall_ms(lambda: sweeper.embed_tokens(frames_dev)),
              "table_ms": wall_ms(lambda: spatial_table(
                  tokens, w_main, SEQ_LEN, compute_dtype=torch.bfloat16, **hp)),
              "windows_ms": wall_ms(lambda: sweeper.sweep_table(table, starts))}

    plain_sweeper = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16,
                                 use_fused_table=False, device=dev)
    probs_plain = plain_sweeper.sweep_device(frames_dev, starts)
    curve_err = float(np.abs(probs - probs_plain).max())
    curve_mean_err = float(np.abs(probs - probs_plain).mean())
    # the two curves differ only through the table's bf16 rounding (above)
    curve_ok = (probs.shape == (n_windows,) and bool(np.isfinite(probs).all())
                and curve_err <= 5e-2 and curve_mean_err <= 5e-3)

    frame_end = args.frames - int(FPS)          # the curve covers the whole shot
    time_x, prob = predict_video_shot(model, frames, 0, frame_end, SEQ_LEN,
                                      crop_size=CROP, batch_size=BATCH, device=dev)
    expect_len = SEQ_LEN + (args.frames - SEQ_LEN - 3) - 2
    t_alarm = alarm_times(time_x, prob)
    pred_ok = prob.shape == (expect_len,) and bool(np.isfinite(prob).all())
    sweep_ok = curve_ok and pred_ok and launches["spatial_table"] > 0
    emit("sweep", frames=args.frames, windows=n_windows, batch=BATCH,
         clips_per_s=n_windows / sweep_s, sweep_ms=sweep_s * 1e3,
         sweep_runs_ms=[w * 1e3 for w in walls], **phases,
         launches=launches, curve_vs_plain_max_abs=curve_err,
         curve_vs_plain_mean_abs=curve_mean_err, curve_len=len(prob),
         expect_len=expect_len, alarm_s=t_alarm,
         warning_s=warning_time(t_alarm, float(time_x[-1])),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30, ok=sweep_ok)
    if not sweep_ok:
        failures.append("sweep")

    # ---- vivit_pallas: ViViT with the fused-attention kernel ----
    # ViViT's defaults are the flagship ViViTConfig
    pallas = ViViT(dtype=torch.bfloat16, use_pallas=True).to(dev).eval()
    pallas.load_state_dict(model.state_dict())
    stride = (args.frames - SEQ_LEN) // 8           # 8 windows spread over the shot
    win = torch.arange(8, device=dev)[:, None] * stride + torch.arange(SEQ_LEN, device=dev)
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.bfloat16, device=dev)
    x = frames_dev[win].to(torch.bfloat16) - mean           # (8, 21, 128, 128, 3)
    with torch.no_grad():
        fused_attention.launches = 0
        logits_k = pallas(x)
        torch.cuda.synchronize()
        launches["fused_attention"] = fused_attention.launches
        logits_p = model(x)
    # use_pallas=False rounds the attention logits to bf16 before the f32
    # softmax (models/vivit.py), the kernel keeps them in f32; that gap
    # reads 0.0101 at seed 0 on an H100, and the limit is five times it
    logit_err = float((logits_k - logits_p).abs().max())
    expect = 2 * cfg.depth                # one per MHSA: spatial + temporal layers
    pallas_ok = (launches["fused_attention"] == expect and logits_k.shape == (8, 2)
                 and bool(torch.isfinite(logits_k).all()) and logit_err <= 0.05)
    emit("vivit_pallas", input=list(x.shape), launches=launches["fused_attention"],
         expect_launches=expect, logits_max_abs_vs_plain=logit_err, ok=pallas_ok)
    if not pallas_ok:
        failures.append("vivit_pallas")

    summary = []
    for c in checks:
        entry = {k: c[k] for k in ("name", "route", "source", "replaces")}
        entry.update(launches=launches[c["name"]], max_abs_err=c["max_abs_err"],
                     ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                     bound_by=c["bound_by"], library_ms=c["library_ms"],
                     case=c["case"], max_rel_err=c["max_rel_err"],
                     atol=c["atol"], rtol=c["rtol"], ok=c["ok"])
        summary.append(entry)
    print(json.dumps({"kernels": summary}), flush=True)
    if failures:
        print(f"chip_smoke: failed: {', '.join(failures)}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
