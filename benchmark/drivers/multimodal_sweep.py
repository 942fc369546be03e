"""Whole-shot paired sweeps through ``MultiModalSweeper.sweep_device``, in a
closed loop.

Set-up makes the shot library (cropped once), each shot's 0D rows
(``core/signals.py``) and the weights on the device from the seed, builds
the fusion model on the meta device and gives it the weights, calibrates
its BatchNorm statistics on library windows, builds the sweeper
(``use_fused_table=None``: K1 where it takes the shape) and warms up on the
longest shot. Each shot's paired windows are those ``multimodal_ladders``
keeps over the whole shot, video and 0D windows ending on the same frame.
The window sweeps shots one after another (``core/library.py order``), each
ending in its probabilities on the host; the shot in flight when the time
is up is finished and counted. A traced run calls the two halves of
``sweep_device``, ``embed_all`` and ``sweep_table``, under spans of their
own.

After the window, the program is freed and the reference recomputes a
sample of the windows drawn from the seed (half of them from the longest
shot swept; ``drivers/sweep.py``'s draw, each window an index into its
shot's ladder) from their raw frames and 0D rows; the gaps in probability
and in log-odds are read. The model's fusion head, kept when the sweeper is
freed, is then run alone on the reference's f32 fused features of those
windows and read against the reference's f32 head (``head_gaps``): the
head runs in f32 by the configuration, and the whole window's gaps, which
the bf16 encoders set, cannot tell an f32 head from a bf16 one. The cell's
``limits`` name the numbers compared.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.core import library as lib_mod
from benchmark.core import program, signals, weights as weights_mod
from benchmark.core.library import seed_for
from benchmark.drivers import sweep as video_sweep

free_program = video_sweep.free_program


@dataclass
class State:
    lib: object
    rows: torch.Tensor            # (frames, n_signals) f32, at the library's offsets
    ladders: list                 # per shot: (video window ends, 0D window ends)
    weights: dict
    sweeper: object = None
    model: object = None          # the swept model; kept when the sweeper is freed (its head)
    calib: tuple = None           # (clips, rows) the BatchNorms were calibrated on
    results: list = field(default_factory=list)   # (shot, probs) per completed shot


def ladders(lib, cell: dict, seq_len: int) -> list:
    """Per shot, the paired window ends ``multimodal_ladders`` keeps over
    the whole shot: the video window ends at frame v + 1, the 0D window at
    row t = v + 1, every such window inside the shot."""
    from kstar_torch.infer.continuous import multimodal_ladders

    dt, tau = cell["signals"]["dt"], cell["tau"]
    out = []
    for t in lib.lengths:
        times = np.arange(int(t)) * dt
        vk, tk = multimodal_ladders(times, 0, int(t) - 2, 0.0, float(times[-1]), seq_len, dt,
                                    tau)
        out.append((np.asarray(vk, np.int64), np.asarray(tk, np.int64)))
    return out


def window_index(st: State, shots, picks, seq_len: int, tau: int):
    """(K, L) library frame rows and (K, L) 0D rows of the paired windows
    ``picks`` (an index into each shot's ladder)."""
    back = tau * np.arange(seq_len - 1, -1, -1)
    v = np.array([st.ladders[s][0][k] for s, k in zip(shots, picks)])
    t = np.array([st.ladders[s][1][k] for s, k in zip(shots, picks)])
    off = st.lib.offsets[np.asarray(shots)][:, None]
    dev = st.lib.frames.device
    return (torch.as_tensor(off + v[:, None] + 1 - back).to(dev),
            torch.as_tensor(off + t[:, None] - back).to(dev))


def build_model(cfg: dict, image_size: int, weights: dict, device):
    """The fusion model at the crop ``image_size``, built on the meta device
    (no initialisation draws) and given copies of the benchmark's weights."""
    from kstar_torch.models import TFNGB

    c = cfg["program_config"]
    with torch.device("meta"):
        model = TFNGB(dict(c["vivit_kwargs"], image_size=image_size), dict(c["ts_kwargs"]),
                      n_classes=c["n_classes"], dtype=program.DTYPES[cfg["compute_dtype"]])
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()},
                          strict=True, assign=True)
    return model.to(device)


class _Paired(torch.nn.Module):
    """The fusion model with its 0D rows bound, so that ``program.calibrate_bn``'s
    one-input forward runs it."""

    def __init__(self, model, rows: torch.Tensor):
        super().__init__()
        self.model, self.rows = model, rows

    def forward(self, clips):
        return self.model(clips, self.rows)


def calibrate_bn(model, clips: torch.Tensor, rows: torch.Tensor) -> None:
    """``program.calibrate_bn`` over the paired windows: ``filter_bn``'s and
    ``cls_bn``'s statistics, each its own input's in one evaluation forward,
    layer after layer."""
    program.calibrate_bn(_Paired(model, rows), clips)


def setup(ctx) -> State:
    from kstar_torch.infer.continuous import MultiModalSweeper

    if not hasattr(MultiModalSweeper, "sweep_device"):
        raise SystemExit("multimodal_sweep: this program's MultiModalSweeper has no "
                         "sweep_device, the device-resident entry the cell sweeps through")
    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    crop = cell["image_size"]
    lib = lib_mod.make(cell["library"], ctx.seed, dev, crop=crop)
    st = State(lib=lib, rows=signals.make(lib, cell["signals"], ctx.seed, dev),
               ladders=ladders(lib, cell, ctx.seq_len),
               weights=weights_mod.make(ctx.reference.param_spec(cfg, crop), ctx.seed, dev))
    model = build_model(cfg, crop, st.weights, dev)
    rng = np.random.default_rng(seed_for(ctx.seed, 4))
    shots = rng.integers(0, len(lib.lengths), cell["calibration_windows"])
    picks = [int(rng.integers(0, len(st.ladders[s][0]))) for s in shots]
    fidx, ridx = window_index(st, shots, picks, ctx.seq_len, cell["tau"])
    st.calib = (lib.frames[fidx], st.rows[ridx])
    calibrate_bn(model, program.normalise(st.calib[0], cfg), st.calib[1])
    st.sweeper = MultiModalSweeper(model, ctx.seq_len, cell["tau"], crop, cell["batch"],
                                   program.DTYPES[cfg["compute_dtype"]],
                                   use_fused_table=None, device=dev)
    st.model = st.sweeper.model
    longest = int(np.argmax(lib.lengths))
    _sweep_shot(ctx, st, longest, traced=False)         # warm-up: the window graph's capture
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st


def _rows(st: State, i: int) -> torch.Tensor:
    o = int(st.lib.offsets[i])
    return st.rows[o:o + int(st.lib.lengths[i])]


def _sweep_shot(ctx, st: State, i: int, traced: bool):
    vk, tk = st.ladders[i]
    if not traced:
        return st.sweeper.sweep_device(st.lib.shot(i), _rows(st, i), vk, tk)
    with ctx.tracer.span("embed_all"):
        video = st.sweeper.embed_all(st.lib.shot(i))
    with ctx.tracer.span("sweep_table"):
        return st.sweeper.sweep_table(video, _rows(st, i), vk, tk)


def window(ctx, st: State, seconds: float, longest_first: bool = False) -> dict:
    """The closed loop for ``seconds``. ``longest_first`` (for the limits'
    readings, whose window is short) sweeps the longest shot first."""
    from kstar_torch.infer.continuous import chunkify_starts
    from kstar_torch.ops.spatial_table import spatial_table

    launches0 = spatial_table.launches
    order = lib_mod.order(st.lib)
    if longest_first:
        order = itertools.chain([int(np.argmax(st.lib.lengths))], order)
    clips = chunks = frames_swept = failed = 0
    shots = []
    t0 = time.perf_counter()
    while True:
        i = next(order)
        n = len(st.ladders[i][0])
        p = _sweep_shot(ctx, st, i, ctx.tracer.on)
        st.results.append((i, p))
        failed += int(not np.all(np.isfinite(p)) or len(p) != n)
        clips += n
        chunks += len(chunkify_starts(st.ladders[i][0], ctx.cell["batch"]))
        frames_swept += int(st.lib.lengths[i])
        shots.append(int(st.lib.lengths[i]))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return {"end_to_end": {ctx.cell["throughput_metric"]: clips / elapsed},
            "attempted": len(shots), "failed": failed,
            "route_launches": (spatial_table.launches - launches0, len(shots)),
            "counters": {"shots": shots, "clips": clips, "chunks": chunks,
                         "frames": frames_swept, "image_size": ctx.cell["image_size"],
                         "batch": ctx.cell["batch"]}}


def reference_probs(ctx, st: State, shots, index, prec: str = "f32", with_fused=False):
    fidx, ridx = window_index(st, shots, index, ctx.seq_len, ctx.cell["tau"])
    out = ctx.reference.probs(st.weights, st.lib.frames, fidx, st.rows, ridx, ctx.cfg, prec,
                              ctx.cell["check"]["block"], st.calib, with_fused)
    p, feats = out if with_fused else (out, None)
    return p.double().cpu().numpy(), feats


HEAD = ("cls_fc1.", "cls_bn.", "cls_fc2.")


@torch.no_grad()
def program_head_log_odds(model, x: torch.Tensor, batch: int) -> np.ndarray:
    """logit 0 less logit 1 of the swept model's own fusion head (``_head``,
    which ``forward_spatial_cls`` runs in the window graph) over (K, fused)
    features, ``batch`` rows at a time."""
    z = torch.cat([model._head(x[i:i + batch], train=False).float()
                   for i in range(0, x.shape[0], batch)])
    return (z[:, 0] - z[:, 1]).double().cpu().numpy()


def head_gaps(ctx, st: State, feats: torch.Tensor, prec_in_place: str = None) -> np.ndarray:
    """|log-odds gap| of the fusion head alone, on the f32 reference's
    fused features of the sampled windows: the swept model's head (or, for
    the control, the reference's head in ``prec_in_place``) against the
    reference's f32 head, both with the swept model's head parameters and
    ``cls_bn`` statistics, so only the head's arithmetic differs."""
    w = {k: v.float() for k, v in st.model.state_dict().items() if k.startswith(HEAD)}
    batch = ctx.cell["batch"]
    want = ctx.reference.head_log_odds(w, feats, "f32", batch).double().cpu().numpy()
    if prec_in_place is None:
        got = program_head_log_odds(st.model, feats, batch)
    else:
        got = ctx.reference.head_log_odds(w, feats, prec_in_place, batch).double().cpu().numpy()
    return np.abs(got - want)


def readings(ctx, st: State, prec_in_place: str = None) -> dict:
    """The numbers compared: the program's sampled probabilities (or, for
    the control, the reference's in ``prec_in_place``) against the f32
    reference's, and the fusion head alone on the reference's features
    (``head_gaps``)."""
    shots, index, got = video_sweep._sample(ctx, st, ctx.cell["check"]["windows"])
    want, feats = reference_probs(ctx, st, shots, index, with_fused=True)
    if prec_in_place is not None:
        got = reference_probs(ctx, st, shots, index, prec_in_place)[0]
    gap = np.abs(got - want)
    lgap = np.abs(video_sweep._log_odds(got) - video_sweep._log_odds(want))
    hgap = head_gaps(ctx, st, feats, prec_in_place)
    return {"prob_gap_max": float(gap.max()), "prob_gap_mean": float(gap.mean()),
            "logit_gap_max": float(lgap.max()), "logit_gap_mean": float(lgap.mean()),
            "head_logit_gap_max": float(hgap.max()), "head_logit_gap_mean": float(hgap.mean()),
            "windows_compared": len(shots)}


def check(ctx, st: State, rec: dict) -> dict:
    video_sweep.free_program(st)
    return readings(ctx, st)
