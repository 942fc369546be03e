"""Training steps through ``train/loop.py make_train_step``, in a closed loop.

Set-up makes the shot library and the weights on the device from the seed,
builds the model, its ``TrainState`` (AdamW with its staircase and the
global-norm clip) and the step (the Focal loss; ``pre_fn`` crops and
normalises inside the step, as ``DevicePreprocessor`` hands batches to
``fit``), then drives that same state through its first steps on batches
that all differ: the first three are the ones the reference follows. The
window goes on with the same state and step, one batch after another, each
a (B, L, 256, 256, 3) uint8 gather from the library on the device by
window starts drawn from the seed, a quarter of them ending in the last
frames before a disruptive shot's quench.

After the window, the reference runs the first three steps again from the
same weights and batches; read are the first step's logits (the log-odds of
each row, as the step's forward made them), each step's loss, the first gradient as
the optimizer took it (from its first moment after one step) and the
parameters' change after three steps, by the worst and the median leaf, as
the gap of the two norms and as the norm of the difference; the cell's
``limits`` name those compared.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.core import library as lib_mod
from benchmark.core import program, weights as weights_mod
from benchmark.core.library import seed_for

COMPARED_STEPS = 3
B1 = 0.9                    # the first moment's decay: mu after one step = (1 - B1) g


@dataclass
class State:
    lib: object
    weights: dict
    batches: list                       # (frame index (B, L), labels (B,)) on the device
    state: object = None
    step: object = None
    aux: tuple = ()
    names: list = field(default_factory=list)
    shapes: list = field(default_factory=list)
    losses: list = field(default_factory=list)     # the compared steps' losses
    logits1: torch.Tensor = None        # the first step's logits, as its forward made them
    mu1: torch.Tensor = None
    flat3: torch.Tensor = None
    next_batch: int = 0


def _batches(ctx, lib) -> list:
    """``pool_batches`` batches of window starts and labels drawn from the
    seed: ``positive_share`` of the rows end in the last ``positive_frames``
    frames before a disruptive shot's quench (label 1), the rest end before
    that (label 0)."""
    cell, L = ctx.cell, ctx.seq_len
    rng = np.random.default_rng(seed_for(ctx.seed, 6))
    n, B, h = cell["pool_batches"], cell["batch"], cell["positive_frames"]
    pos = np.arange(B) < round(B * cell["positive_share"])
    disruptive = np.flatnonzero(lib.disrupt)
    shots = np.where(pos, rng.choice(disruptive, (n, B)),
                     rng.integers(0, len(lib.lengths), (n, B)))
    last = lib.cutoff[shots] - L - 1                  # the window ending at the quench
    lo = np.where(pos, np.maximum(last - h, 0), 0)
    hi = np.maximum(np.where(pos, last, last - h), lo + 1)
    starts = lo + (rng.random((n, B)) * (hi - lo)).astype(np.int64)
    labels = torch.as_tensor(np.broadcast_to(pos, (n, B)).astype(np.int64),
                             device=lib.frames.device)
    return [(lib.clip_index(shots[i], starts[i], L), labels[i]) for i in range(n)]


def setup(ctx) -> State:
    from kstar_torch.config import LossConfig, OptimConfig
    from kstar_torch.data import make_pre_fns
    from kstar_torch.losses import ldam_margins
    from kstar_torch.train import create_train_state, make_train_step

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    lib = lib_mod.make(cell["library"], ctx.seed, dev)
    w = weights_mod.make(ctx.reference.param_spec(cfg, cell["image_size"]), ctx.seed, dev)
    st = State(lib=lib, weights=w, batches=_batches(ctx, lib))
    model = program.build_model(cfg, cell["image_size"], w, dev)
    opt = cell["optimizer"]
    st.state = create_train_state(
        model, OptimConfig(optimizer="AdamW", lr=opt["lr"], use_scheduler=True,
                           step_size=opt["step_size"], gamma=opt["gamma"],
                           max_norm_grad=opt["max_norm_grad"]),
        steps_per_epoch=cell["steps_per_epoch"], seed=seed_for(ctx.seed, 7))
    st.names = [n for n, p in model.named_parameters() if p.requires_grad]
    st.shapes = [p.shape for p in st.state.params]
    dtype = program.DTYPES[cfg["compute_dtype"]]
    pre_fn = make_pre_fns(cell["image_size"], out_dtype=dtype)[1]      # crop + normalise
    st.step = make_train_step(LossConfig(loss_type="Focal",
                                         focal_gamma=cell["loss"]["focal_gamma"]),
                              pre_fn=pre_fn)
    B = cell["batch"]
    st.aux = (torch.ones(2, device=dev),
              torch.as_tensor(ldam_margins(np.array([B // 2, B - B // 2]))).to(dev))
    keep = []
    hook = st.state.model.register_forward_hook(lambda m, i, out: keep.append(out.detach()))
    for i in range(cell["warmup_steps"]):
        loss = _one_step(ctx, st)
        if i == 0:
            hook.remove()
            st.logits1 = keep[0].float()
        if i < COMPARED_STEPS:
            st.losses.append(loss)
        if i == 0:
            st.mu1 = st.state.opt_state["mu"].clone()
        if i == COMPARED_STEPS - 1:
            st.flat3 = st.state.flat.clone()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st


def _one_step(ctx, st: State) -> torch.Tensor:
    idx, labels = st.batches[st.next_batch % len(st.batches)]
    st.next_batch += 1
    with ctx.tracer.span("train_step"):
        _, loss, _ = st.step(st.state, st.lib.frames[idx], labels, *st.aux)
    return loss


def window(ctx, st: State, seconds: float) -> dict:
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(_one_step(ctx, st))
        if time.perf_counter() - t0 >= seconds:
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    B = ctx.cell["batch"]
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"end_to_end": {"train_clips_per_s": B * len(losses) / elapsed},
            "attempted": len(losses), "failed": failed,
            "counters": {"steps": len(losses), "clips": B * len(losses), "batch": B,
                         "image_size": ctx.cell["image_size"]}}


def _leaves(flat: torch.Tensor, st: State) -> dict:
    parts = torch.split(flat.detach().double().cpu(), [s.numel() for s in st.shapes])
    return {n: p.view(s) for n, p, s in zip(st.names, parts, st.shapes)}


def _leaf_gaps(got: dict, want: dict, leaves, diff: bool = False) -> np.ndarray:
    """| |got| - |want| | per leaf (with ``diff``, |got - want|, which also
    sees a leaf of the right size pointing the wrong way), over the larger of
    the leaf's |want| and the median leaf's."""
    norm = {k: float(want[k].norm()) for k in leaves}
    median = float(np.median(list(norm.values())))
    gap = ((lambda k: float((got[k] - want[k]).norm())) if diff
           else (lambda k: abs(float(got[k].norm()) - norm[k])))
    return np.array([gap(k) / max(norm[k], median) for k in leaves])


def free_program(st: State) -> None:
    st.state = st.step = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def compared_batches(st: State) -> list:
    return [(st.lib.frames[idx], labels) for idx, labels in st.batches[:COMPARED_STEPS]]


def readings(ctx, st: State, got: dict) -> dict:
    """The numbers compared, for the steps ``got`` (losses, first clipped
    gradient and parameters after three steps, as leaf dicts) against the f32
    reference's."""
    ref = ctx.reference.train(st.weights, compared_batches(st), ctx.cfg, ctx.cell, "f32")
    w0 = {k: v.double().cpu() for k, v in st.weights.items()}
    g_ref = {k: v.double().cpu() for k, v in ref["grads1"].items()}
    d_ref = {k: ref["params"][k].double().cpu() - w0[k] for k in st.names}
    d_got = {k: got["params"][k] - w0[k] for k in st.names}
    gnorm = {k: float(g_ref[k].norm()) for k in st.names}
    floor = 1e-3 * float(np.median(list(gnorm.values())))
    moved = [k for k in st.names if gnorm[k] >= floor]
    loss_ref = np.array(ref["losses"])
    loss = np.abs(np.array(got["losses"]) - loss_ref) / np.abs(loss_ref)
    logit = np.abs(_log_odds(got["logits1"]) - _log_odds(ref["logits1"].double().cpu()))
    grad = _leaf_gaps(got["grads1"], g_ref, st.names)
    update = _leaf_gaps(d_got, d_ref, moved)
    grad_diff = _leaf_gaps(got["grads1"], g_ref, st.names, diff=True)
    update_diff = _leaf_gaps(d_got, d_ref, moved, diff=True)
    return {"logit_gap_max": float(logit.max()), "logit_gap_mean": float(logit.mean()),
            "loss_gap": float(loss.max()), "loss_gap_step1": float(loss[0]),
            "grad_norm_gap": float(grad.max()), "grad_norm_gap_median": float(np.median(grad)),
            "update_norm_gap": float(update.max()),
            "update_norm_gap_median": float(np.median(update)),
            "grad_diff_gap": float(grad_diff.max()),
            "grad_diff_gap_median": float(np.median(grad_diff)),
            "update_diff_gap": float(update_diff.max()),
            "update_diff_gap_median": float(np.median(update_diff)),
            "leaves_left_out": len(st.names) - len(moved)}


def _log_odds(logits: torch.Tensor) -> np.ndarray:
    """Each row's two-class log-odds, logit 0 over logit 1 (as the sweeps
    read their probabilities)."""
    return (logits[:, 0] - logits[:, 1]).double().cpu().numpy()


def program_steps(st: State) -> dict:
    return {"logits1": st.logits1,
            "losses": [float(x) for x in torch.stack(st.losses).cpu()],
            "grads1": _leaves(st.mu1 / (1 - B1), st),
            "params": _leaves(st.flat3, st)}


def check(ctx, st: State, rec: dict) -> dict:
    got = program_steps(st)
    free_program(st)
    return readings(ctx, st, got)
