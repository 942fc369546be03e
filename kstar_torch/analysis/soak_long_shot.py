"""Long-shot soak of the port: one 60 s shot through the whole video stack.

    python -m kstar_torch.analysis.soak_long_shot [--frames 12600] [--device cuda]

The port's twin of ``analysis/soak_long_shot.py``, with its workload: a
12,600-frame (60 s at 210 fps) shot of 256x256x3 uint8 frames made from
--seed (2.4 GiB raw, 0.6 GiB at the 128 px crop), the last two seconds
brightened in a central blob so that the curve is not flat, and the
flagship ViViT (bf16, random weights from --seed). It runs:

  1. ``predict_video_shot`` cold, then ``VideoSweeper.sweep_device`` over
     the uploaded shot 3 times (median): clips/s, peak device memory around
     the sweep, the spatial-table kernel's launches; the curve of the plain
     table (``use_fused_table=False``) beside the kernel's;
  2. ``StreamingPredictor`` at k = 16 over the first ~1,600 frames: ms per
     frame against the camera's 1000/210;
  3. ``render_realtime_gif`` where matplotlib is present, else a skip line.

Correct: the steady curve equals the cold one exactly; the kernel's curve
is within ``SWEEP_TOL`` of the plain table's (max, mean |dp|); the stream's
probabilities, for the windows it ran once its buffer held real frames,
equal the sweep's within ``STREAM_TOL``. A failed check raises. Prints one
line per stage, the card's name and power limit, and a last JSON line.
``main(n_frames, device="cpu", cfg=..., crop=...)`` runs the same at a
small size on the CPU (the plain versions of the kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..config import FPS, ViViTConfig

SEQ_LEN, DIST, CROP, BATCH = 21, 3, 128, 128
STREAM_K, STREAM_FRAMES = 16, 1600
SWEEP_TOL = (5e-2, 5e-3)        # kernel against plain table: max, mean |dp| (bf16 rounding)
STREAM_TOL = 2e-2               # stream against sweep windows (bf16, other batch shapes)


def make_shot(n_frames: int, size: int, seed: int = 0, chunk: int = 256) -> np.ndarray:
    """(n_frames, size, size, 3) uint8 noise from ``seed``, filled a chunk at
    a time from the generator's raw bytes (fast, no second full-size copy),
    with the last two seconds OR-ed with 200 in the central quarter."""
    rng = np.random.default_rng(seed)
    frames = np.empty((n_frames, size, size, 3), np.uint8)
    per = size * size * 3
    for a in range(0, n_frames, chunk):
        n = min(chunk, n_frames - a)
        frames[a:a + n] = np.frombuffer(rng.bytes(n * per), np.uint8).reshape(n, size, size, 3)
    lo, hi = 3 * size // 8, 5 * size // 8
    frames[-int(2 * FPS):, lo:hi, lo:hi, :] |= 200
    return frames


def reset_peak(device: torch.device) -> None:
    """Zero the device's peak-memory count (after a synchronise); a no-op
    off the GPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device: torch.device) -> Optional[float]:
    return (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None
    without nvidia-smi)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def main(n_frames: int = 12600, device=None, cfg: Optional[ViViTConfig] = None,
         crop: int = CROP, batch: int = BATCH, compute_dtype: torch.dtype = torch.bfloat16,
         stream_frames: int = STREAM_FRAMES, seed: int = 0,
         out_dir: str = "build/soak") -> dict:
    """Run the soak; returns its numbers (and raises when a check fails).
    The frames are ``2 * crop`` px square; ``cfg`` defaults to the flagship
    ViViT at ``crop``."""
    from .. import resolve_device
    from ..cli.common import draw_figure
    from ..infer import StreamingPredictor, VideoSweeper, predict_video_shot
    from ..infer.continuous import startup_suppression
    from ..models import build_video_model
    from ..ops.preprocess import gather_normalize
    from ..ops.spatial_table import spatial_table
    from ..viz.prob_curve import render_realtime_gif

    dev = resolve_device(device)
    size = 2 * crop
    cfg = cfg or ViViTConfig(image_size=crop, n_frames=SEQ_LEN)
    res = {"frames": n_frames, "size": size, "device": str(dev)}
    print(f"soak: {n_frames} frames (~{n_frames / FPS:.1f} s shot), {size}x{size} uint8 = "
          f"{n_frames * size * size * 3 / 2 ** 30:.2f} GiB raw", flush=True)
    t0 = time.perf_counter()
    frames = make_shot(n_frames, size, seed)
    res["make_shot_s"] = time.perf_counter() - t0
    model = build_video_model("ViViT", cfg, dtype=compute_dtype,
                              generator=torch.Generator().manual_seed(seed)).to(dev).eval()

    # 1. the whole-shot sweep, cold then steady
    n_windows = n_frames - SEQ_LEN - DIST
    reset_peak(dev)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0   # the model
    spatial_table.launches = 0
    t0 = time.perf_counter()
    time_x, prob = predict_video_shot(model, frames, 0, n_frames - int(FPS), SEQ_LEN, DIST,
                                      crop, batch, compute_dtype=compute_dtype, device=dev)
    res["cold_s"] = time.perf_counter() - t0
    res["cold_peak_gib"] = _peak_gib(dev)

    sweeper = VideoSweeper(model, SEQ_LEN, crop, batch, compute_dtype, device=dev)
    frames_dev = sweeper.upload_shot(frames)
    starts = np.arange(n_windows, dtype=np.int64)
    sweeper.sweep_device(frames_dev, starts)                     # warm
    reset_peak(dev)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        steady = sweeper.sweep_device(frames_dev, starts)       # ends in a host copy
        walls.append(time.perf_counter() - t0)
    res["k1_launches"] = spatial_table.launches
    res["fused_table"] = sweeper.fused_table_active
    steady_s = float(np.median(walls))
    res.update(windows=n_windows, batch=batch, steady_s=steady_s, steady_runs_s=walls,
               clips_per_s=n_windows / steady_s, steady_peak_gib=_peak_gib(dev),
               model_gib=before / 2 ** 30)
    curve = startup_suppression(np.concatenate(
        [np.zeros(SEQ_LEN, np.float32), steady[1:-1]]), int(FPS))
    res["steady_equals_cold"] = bool(curve.shape == prob.shape and np.array_equal(curve, prob))

    plain = VideoSweeper(model, SEQ_LEN, crop, batch, compute_dtype, use_fused_table=False,
                         device=dev).sweep_device(frames_dev, starts)
    err = np.abs(steady - plain)
    res.update(vs_plain_table_max_abs=float(err.max()), vs_plain_table_mean_abs=float(err.mean()))
    print(f"  sweep cold {res['cold_s']:.2f} s | steady {steady_s:.3f} s = "
          f"{res['clips_per_s']:,.0f} clips/s ({n_windows} windows) | peak "
          f"{res['steady_peak_gib']} GiB | K1 launches {res['k1_launches']} | vs plain table "
          f"max {res['vs_plain_table_max_abs']:.2e}", flush=True)
    del frames_dev

    # 2. the k = 16 stream over the first ~1,600 frames
    y0 = size // 2 - crop // 2
    cropped = np.ascontiguousarray(frames[:stream_frames + STREAM_K, y0:y0 + crop,
                                          y0:y0 + crop])
    sp = StreamingPredictor(model, seq_len=SEQ_LEN, crop_size=crop, block_size=STREAM_K,
                            compute_dtype=compute_dtype, device=dev)
    n_blocks = min(stream_frames, len(cropped)) // STREAM_K - 1
    probs = [sp.push_block(cropped[:STREAM_K])[0]]                 # allocate + warm
    gather_normalize.launches = 0
    t0 = time.perf_counter()
    for b in range(1, 1 + n_blocks):
        probs.append(sp.push_block(cropped[b * STREAM_K:(b + 1) * STREAM_K])[0])
    stream_ms = (time.perf_counter() - t0) / (n_blocks * STREAM_K) * 1e3
    stream_p = np.concatenate(probs)
    # the probability after frame t is the window of frames t-20..t, the
    # sweep's window s = t - SEQ_LEN (frames s+1..s+SEQ_LEN)
    t = np.arange(SEQ_LEN, len(stream_p))
    serr = np.abs(stream_p[t] - steady[t - SEQ_LEN])
    res.update(stream_k=STREAM_K, stream_frames=n_blocks * STREAM_K, stream_ms_per_frame=stream_ms,
               budget_ms_per_frame=1e3 / FPS, stream_holds=stream_ms < 1e3 / FPS,
               k3_launches=gather_normalize.launches,
               stream_vs_sweep_max_abs=float(serr.max()))
    print(f"  streaming k={STREAM_K}: {stream_ms:.3f} ms/frame over {n_blocks * STREAM_K} frames "
          f"({'holds' if res['stream_holds'] else 'misses'} the {1e3 / FPS:.2f} ms budget) | "
          f"vs sweep max {res['stream_vs_sweep_max_abs']:.2e}", flush=True)

    # 3. the real-time GIF
    gif = os.path.join(out_dir, "soak_long_shot.gif")
    t0 = time.perf_counter()
    drawn = draw_figure(gif, lambda: render_realtime_gif(
        frames, time_x, prob, shot=99999, t_cq=(n_frames - 1) / FPS, save_path=gif))
    res["gif_s"] = time.perf_counter() - t0 if drawn is not None else None
    if drawn is not None:
        print(f"  gif: {res['gif_s']:.1f} s -> {gif} ({os.path.getsize(gif) / 2 ** 20:.1f} MiB)")

    failed = []
    if not res["steady_equals_cold"]:
        failed.append("steady curve != cold curve")
    if (not np.isfinite(steady).all() or res["vs_plain_table_max_abs"] > SWEEP_TOL[0]
            or res["vs_plain_table_mean_abs"] > SWEEP_TOL[1]):
        failed.append(f"kernel curve against plain table: {res['vs_plain_table_max_abs']}, "
                      f"{res['vs_plain_table_mean_abs']} (limits {SWEEP_TOL})")
    if res["stream_vs_sweep_max_abs"] > STREAM_TOL:
        failed.append(f"stream against sweep: {res['stream_vs_sweep_max_abs']} > {STREAM_TOL}")
    if dev.type == "cuda" and not (res["fused_table"] and res["k1_launches"] == 5
                                   and res["k3_launches"] == n_blocks):
        failed.append(f"kernel launches: K1 {res['k1_launches']} (table kernel "
                      f"{res['fused_table']}), K3 {res['k3_launches']}")
    if failed:
        raise RuntimeError("soak_long_shot: " + "; ".join(failed))
    return res


def cli() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=12600)
    parser.add_argument("--device", default=None, help="default: the GPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", default="build/soak")
    args = parser.parse_args()
    res = main(args.frames, args.device, seed=args.seed, out_dir=args.out_dir)
    print(card() or "no nvidia-smi")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
