"""Library soak of the port: a 50-shot library swept under the device-memory
budget, and the frame-bucket ladder A/B.

    python -m kstar_torch.analysis.soak_library_sweep [--shots 50] [--device cuda]

The port's twin of ``analysis/soak_library_sweep.py``, with its workload:
``--shots`` shots of 2,300-4,096 frames (lengths from --seed) of 128x128x3
uint8 frames made from --seed (~7.7 GiB for 50), and the flagship ViViT
(bf16, random weights from --seed). It runs:

  1. ``VideoSweeper.sweep_shots`` at the default budget
     (``_hbm_budget_bytes``, half the free device memory), once with the
     sub-octave frame ladder (``bucket_len``) and once with the pow2 ladder
     swapped in: frame padding, cold and steady seconds, clips/s, groups,
     peak device memory and the breakdown of the library spans
     (``library_phases``: host prep, upload, sweep), recorded under a
     profiler session;
  2. the same with the budget forced to a quarter of the library's cropped
     bytes, so that the library is swept in several groups;
  3. the per-shot path (``upload_shot`` + ``sweep_device``) on 8 shots, with
     and without the upload, and the device memory a resident shot's sweep
     takes beyond its frames (which the stack budget does not count).

Correct: every library curve (both ladders, both budgets) equals the shot's
own ``sweep_device`` curve within ``LIB_TOL`` (max, mean |dp|: the group
pads a shot to the group's frame bucket, so the table kernel sees another
frame count and rounds bf16 at other points); the forced run takes two or
more groups. A failed check raises. Prints one line per run, the card's
name and power limit, and a last JSON line. ``main(n_shots, device="cpu",
lengths=..., cfg=..., crop=...)`` runs the same at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ViViTConfig
from .soak_long_shot import card, reset_peak

SEQ_LEN, CROP, BATCH = 21, 128, 128
LENGTHS = (2300, 4097)            # shot lengths drawn from [2300, 4097)
LIB_TOL = (5e-2, 5e-3)            # library against per-shot curves: max, mean |dp|
PER_SHOT = 8                      # shots of the per-shot timing


def pow2_len(n: int) -> int:
    """The pow2 frame ladder the sub-octave one replaced."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def make_library(n_shots: int, lengths: Sequence[int] = LENGTHS, size: int = CROP,
                 seed: int = 0) -> list:
    """``n_shots`` (n, size, size, 3) uint8 noise shots, lengths uniform in
    ``[lengths[0], lengths[1])``, from ``seed`` (the generator's raw bytes)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in rng.integers(lengths[0], lengths[1], size=n_shots):
        shot = np.empty((int(n), size, size, 3), np.uint8)
        shot.reshape(-1)[:] = np.frombuffer(rng.bytes(shot.size), np.uint8)
        out.append(shot)
    return out


def _gib(nbytes) -> Optional[float]:
    return None if nbytes is None else nbytes / 2 ** 30


def _curve_err(got: list, want: list) -> tuple:
    err = [np.abs(g - w) for g, w in zip(got, want)]
    ok_shapes = all(g.shape == w.shape for g, w in zip(got, want))
    if not ok_shapes:
        return float("inf"), float("inf")
    return (max(float(e.max()) for e in err), max(float(e.mean()) for e in err))


def library_phases(records) -> tuple:
    """The ``_sweep_group`` spans among ``records`` (``utils/profiling.py``)
    as ({host_prep_s, h2d_s, dispatch_s: summed host walls; h2d_bytes},
    [(frames stack shape, chunks stack shape) per group]). The upload's
    wall is the host's: the spans do not synchronise."""
    def wall(name):
        return sum(s.end_ns - s.start_ns for s in records if s.name == name) / 1e9

    h2d = [s for s in records if s.name == "library.h2d"]
    return ({"host_prep_s": wall("library.prep"), "h2d_s": wall("library.h2d"),
             "dispatch_s": wall("library.sweep"),
             "h2d_bytes": sum(s.attrs["bytes"] for s in h2d)},
            [(s.attrs["frames"], s.attrs["chunks"]) for s in h2d])


def main(n_shots: int = 50, device=None, lengths: Sequence[int] = LENGTHS,
         cfg: Optional[ViViTConfig] = None, crop: int = CROP, batch: int = BATCH,
         compute_dtype: torch.dtype = torch.bfloat16, tol: tuple = LIB_TOL,
         per_shot: int = PER_SHOT, seed: int = 0) -> dict:
    """Run the soak; returns its numbers (and raises when a check fails)."""
    from .. import resolve_device
    from ..infer import continuous as C
    from ..models import build_video_model
    from ..ops.spatial_table import spatial_table
    from ..utils.profiling import recording

    dev = resolve_device(device)
    cfg = cfg or ViViTConfig(image_size=crop, n_frames=SEQ_LEN)
    t0 = time.perf_counter()
    frames_list = make_library(n_shots, lengths, crop, seed)
    lens = np.array([len(f) for f in frames_list])
    starts_list = [np.arange(n - SEQ_LEN - 3, dtype=np.int64) for n in lens]
    n_windows = int(sum(len(s) for s in starts_list))
    stack_bytes = int(lens.sum()) * crop * crop * 3
    res = {"shots": n_shots, "frames_min": int(lens.min()), "frames_max": int(lens.max()),
           "windows": n_windows, "cropped_gib": stack_bytes / 2 ** 30, "device": str(dev),
           "make_library_s": time.perf_counter() - t0}
    print(f"library: {n_shots} shots, {lens.min()}-{lens.max()} frames, "
          f"{res['cropped_gib']:.2f} GiB cropped total", flush=True)

    model = build_video_model("ViViT", cfg, dtype=compute_dtype,
                              generator=torch.Generator().manual_seed(seed)).to(dev).eval()
    sw = C.VideoSweeper(model, SEQ_LEN, crop, batch, compute_dtype, device=dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    budget = sw._hbm_budget_bytes()
    res.update(budget_gib=budget / 2 ** 30, model_gib=_gib(base),
               free_gib=_gib(torch.cuda.mem_get_info(dev)[0]) if dev.type == "cuda" else None)
    print(f"  device-memory budget for the stack: {res['budget_gib']:.2f} GiB "
          f"(free {res['free_gib']} GiB)", flush=True)

    # each shot alone: the reference curves
    t0 = time.perf_counter()
    alone = [sw.sweep_device(sw.upload_shot(f), s) for f, s in zip(frames_list, starts_list)]
    res["per_shot_reference_s"] = time.perf_counter() - t0

    runs, curves = {}, {}
    orig = C.bucket_len
    try:
        for name, ladder, run_budget in (("sub-octave", orig, None), ("pow2", pow2_len, None),
                                         ("sub-octave forced", orig, stack_bytes // 4)):
            C.bucket_len = ladder
            pad = sum(ladder(int(n)) for n in lens) / float(lens.sum())
            t0 = time.perf_counter()
            sw.sweep_shots(frames_list, starts_list, hbm_budget_bytes=run_budget)
            cold = time.perf_counter() - t0
            reset_peak(dev)
            spatial_table.launches = 0
            with recording() as rec:
                t0 = time.perf_counter()
                probs = sw.sweep_shots(frames_list, starts_list, hbm_budget_bytes=run_budget)
                warm = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
            tm, shapes = library_phases(rec)
            err = _curve_err(probs, alone)
            run = dict(frame_padding=pad, cold_s=cold, steady_s=warm,
                       clips_per_s=n_windows / warm, ms_per_shot=warm / n_shots * 1e3,
                       groups=len(shapes), group_shapes=[[list(f), list(c)] for f, c in shapes],
                       budget_gib=(run_budget or budget) / 2 ** 30,
                       peak_gib=_gib(peak),
                       stack_peak_gib=_gib(None if peak is None else peak - base),
                       k1_launches=spatial_table.launches, timings=tm,
                       vs_per_shot_max_abs=err[0], vs_per_shot_mean_abs=err[1])
            runs[name], curves[name] = run, probs
            gbps = tm["h2d_bytes"] / max(tm["h2d_s"], 1e-9) / 2 ** 30
            print(f"  {name:17s}: padding x{pad:.3f} | {run['groups']} groups | cold {cold:.2f} s"
                  f" | steady {warm:.2f} s = {run['clips_per_s']:,.0f} clips/s "
                  f"({run['ms_per_shot']:.0f} ms/shot) | peak {run['peak_gib']} GiB\n"
                  f"    breakdown: host prep {tm['host_prep_s']:.2f} s | h2d {tm['h2d_s']:.2f} s "
                  f"({tm['h2d_bytes'] / 2 ** 30:.2f} GiB at {gbps:.2f} GiB/s) | sweep "
                  f"{tm['dispatch_s']:.2f} s | vs per-shot max {err[0]:.2e}", flush=True)
    finally:
        C.bucket_len = orig
    ladders = _curve_err(curves["pow2"], curves["sub-octave"])
    res.update(runs=runs, ladders_max_abs=ladders[0], ladders_mean_abs=ladders[1])

    # the per-shot path: upload + sweep, and the sweep of a resident shot
    sub = list(range(0, n_shots, max(n_shots // per_shot, 1)))[:per_shot]
    devs = [sw.upload_shot(frames_list[i]) for i in sub]
    for d, i in zip(devs, sub):
        sw.sweep_device(d, starts_list[i])                    # warm each bucket
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in sub:
        sw.sweep_device(sw.upload_shot(frames_list[i]), starts_list[i])
    with_upload = (time.perf_counter() - t0) / len(sub)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    reset_peak(dev)
    t0 = time.perf_counter()
    for d, i in zip(devs, sub):
        sw.sweep_device(d, starts_list[i])
    resident = (time.perf_counter() - t0) / len(sub)
    # what one shot's sweep needs beyond its resident frames (the embedding
    # and table, a chunk's activations): what the stack budget leaves out
    shot_peak = (torch.cuda.max_memory_allocated(dev) - held) if dev.type == "cuda" else None
    res.update(per_shot_ms_with_upload=with_upload * 1e3, per_shot_ms_resident=resident * 1e3,
               per_shot_shots=len(sub), shot_sweep_peak_gib=_gib(shot_peak))
    lib = runs["sub-octave"]
    print(f"  per-shot path: {resident * 1e3:.0f} ms/shot resident, {with_upload * 1e3:.0f} "
          f"ms/shot with the upload (library: {lib['ms_per_shot']:.0f} end to end, "
          f"{lib['timings']['dispatch_s'] / n_shots * 1e3:.0f} sweep only)", flush=True)

    failed = [f"{name}: against per-shot {r['vs_per_shot_max_abs']}, "
              f"{r['vs_per_shot_mean_abs']} (limits {tol})"
              for name, r in runs.items()
              if r["vs_per_shot_max_abs"] > tol[0] or r["vs_per_shot_mean_abs"] > tol[1]]
    if ladders[0] > tol[0] or ladders[1] > tol[1]:
        failed.append(f"ladders differ: {ladders} (limits {tol})")
    if runs["sub-octave forced"]["groups"] < 2:
        failed.append("the forced budget swept the library in one group")
    if not all(np.isfinite(p).all() for p in curves["sub-octave"]):
        failed.append("non-finite probabilities")
    if dev.type == "cuda" and any(r["k1_launches"] != n_shots for r in runs.values()):
        failed.append(f"table-kernel launches per steady run: "
                      f"{[r['k1_launches'] for r in runs.values()]}, not {n_shots}")
    if failed:
        raise RuntimeError("soak_library_sweep: " + "; ".join(failed))
    return res


def cli() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shots", type=int, default=50)
    parser.add_argument("--device", default=None, help="default: the GPU")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    res = main(args.shots, args.device, seed=args.seed)
    print(card() or "no nvidia-smi")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
