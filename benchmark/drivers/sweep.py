"""Whole-shot sweeps through ``VideoSweeper.sweep_device``, in a closed loop.

Set-up makes the shot library and the weights on the device from the seed,
builds the model and its sweeper (``use_fused_table=None``: K1 where it
takes the shape), calibrates BatchNorm statistics where the configuration
has them, and warms up on the cell's own shapes. The window sweeps shots one
after another (``core/library.py order``), each ending in its
probabilities on the host; the shot in flight when the time is up is
finished and counted. A traced run calls the two halves of
``sweep_device``, ``embed_all`` and ``sweep_table``, under spans of their
own.

After the window, the program is freed and the reference recomputes a
sample of the windows drawn from the seed (half of them from the longest
shot swept); the gaps in probability and in log-odds are read, and the cell's
``limits`` name those compared.
"""

from __future__ import annotations

import gc
import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.core import library as lib_mod
from benchmark.core import program, weights as weights_mod
from benchmark.core.library import seed_for


@dataclass
class State:
    lib: object
    weights: dict
    sweeper: object = None
    calib: torch.Tensor = None
    results: list = field(default_factory=list)   # (shot, probs) per completed shot


def _route(ctx):
    """The launch counter of the layer the cell names (K1 or K3)."""
    from kstar_torch.ops.preprocess import gather_normalize
    from kstar_torch.ops.spatial_table import spatial_table

    return spatial_table if ctx.cell["route"] == "spatial_table" else gather_normalize


def setup(ctx) -> State:
    from kstar_torch.infer.continuous import VideoSweeper

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    crop = cell["image_size"]
    lib = lib_mod.make(cell["library"], ctx.seed, dev, crop=crop)
    w = weights_mod.make(ctx.reference.param_spec(cfg, crop), ctx.seed, dev)
    model = program.build_model(cfg, crop, w, dev)
    st = State(lib=lib, weights=w)
    if cfg.get("calibrate_bn"):
        rng = np.random.default_rng(seed_for(ctx.seed, 4))
        shots = rng.integers(0, len(lib.lengths), cell["calibration_windows"])
        starts = [int(rng.integers(0, lib.windows(s, ctx.seq_len))) for s in shots]
        st.calib = lib.frames[lib.clip_index(shots, starts, ctx.seq_len)]
        program.calibrate_bn(model, program.normalise(st.calib, cfg))
    st.sweeper = VideoSweeper(model, ctx.seq_len, crop, cell["batch"],
                              program.DTYPES[cfg["compute_dtype"]],
                              use_fused_table=None, device=dev)
    # warm-up on the cell's shapes: the longest shot, or its first chunks
    longest = int(np.argmax(lib.lengths))
    n = lib.windows(longest, ctx.seq_len)
    if cell.get("warmup_windows"):
        n = min(n, cell["warmup_windows"])
    st.sweeper.sweep_device(lib.shot(longest), np.arange(n, dtype=np.int64))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st


def _sweep_shot(ctx, st, frames, starts):
    if not ctx.tracer.on:
        return st.sweeper.sweep_device(frames, starts)
    with ctx.tracer.span("embed_all"):
        data = st.sweeper.embed_all(frames)
    with ctx.tracer.span("sweep_table"):
        return st.sweeper.sweep_table(data, starts)


def window(ctx, st: State, seconds: float, longest_first: bool = False) -> dict:
    """The closed loop for ``seconds``. ``longest_first`` (for the limits'
    readings, whose window is short) sweeps the longest shot first."""
    from kstar_torch.infer.continuous import chunkify_starts

    route = _route(ctx)
    launches0 = route.launches
    order = lib_mod.order(st.lib)
    if longest_first:
        order = itertools.chain([int(np.argmax(st.lib.lengths))], order)
    clips = chunks = frames_swept = failed = 0
    shots = []
    t0 = time.perf_counter()
    while True:
        i = next(order)
        starts = np.arange(st.lib.windows(i, ctx.seq_len), dtype=np.int64)
        p = _sweep_shot(ctx, st, st.lib.shot(i), starts)
        st.results.append((i, p))
        failed += int(not np.all(np.isfinite(p)) or len(p) != len(starts))
        clips += len(starts)
        chunks += len(chunkify_starts(starts, ctx.cell["batch"]))
        frames_swept += int(st.lib.lengths[i])
        shots.append(int(st.lib.lengths[i]))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    expected = len(shots) if ctx.cell["route"] == "spatial_table" else chunks
    return {"end_to_end": {ctx.cell["throughput_metric"]: clips / elapsed},
            "attempted": len(shots), "failed": failed,
            "route_launches": (route.launches - launches0, expected),
            "counters": {"shots": shots, "clips": clips, "chunks": chunks,
                         "frames": frames_swept, "image_size": ctx.cell["image_size"]}}


def _sample(ctx, st: State, k: int):
    """(shot, start, program probability) of ``k`` windows drawn from the
    seed among those the window swept: half from the longest shot swept (its
    first and last window among them), half from all."""
    rng = np.random.default_rng(seed_for(ctx.seed, 5))
    sizes = np.array([len(p) for _, p in st.results])
    longest = int(np.argmax(sizes))
    picks = {(longest, 0), (longest, int(sizes[longest]) - 1)}
    while len(picks) < min(k // 2, sizes[longest]):
        picks.add((longest, int(rng.integers(0, sizes[longest]))))
    cum = np.cumsum(sizes)
    while len(picks) < min(k, cum[-1]):
        g = int(rng.integers(0, cum[-1]))
        r = int(np.searchsorted(cum, g, side="right"))
        picks.add((r, g - (int(cum[r - 1]) if r else 0)))
    picks = sorted(picks)
    shots = [st.results[r][0] for r, _ in picks]
    starts = [s for _, s in picks]
    got = np.array([st.results[r][1][s] for r, s in picks], np.float64)
    return shots, starts, got


def free_program(st: State) -> None:
    st.sweeper = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_probs(ctx, st: State, shots, starts, prec: str = "f32") -> np.ndarray:
    idx = st.lib.clip_index(shots, starts, ctx.seq_len)
    p = ctx.reference.probs(st.weights, st.lib.frames, idx, ctx.cfg, prec,
                            ctx.cell["check"]["block"], st.calib)
    return p.double().cpu().numpy()


def readings(ctx, st: State, prec_in_place: str = None) -> dict:
    """The numbers compared: the program's sampled probabilities (or, for
    the control, the reference's in ``prec_in_place``) against the f32
    reference's."""
    shots, starts, got = _sample(ctx, st, ctx.cell["check"]["windows"])
    if prec_in_place is not None:
        got = reference_probs(ctx, st, shots, starts, prec_in_place)
    want = reference_probs(ctx, st, shots, starts)
    gap = np.abs(got - want)
    lgap = np.abs(_log_odds(got) - _log_odds(want))
    return {"prob_gap_max": float(gap.max()), "prob_gap_mean": float(gap.mean()),
            "logit_gap_max": float(lgap.max()), "logit_gap_mean": float(lgap.mean()),
            "windows_compared": len(shots)}


def _log_odds(p: np.ndarray) -> np.ndarray:
    """log(p / (1 - p)), the two-class logit gap the probability came from;
    p is held off 0 and 1 by f32's resolution there."""
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def check(ctx, st: State, rec: dict) -> dict:
    free_program(st)
    return readings(ctx, st)
