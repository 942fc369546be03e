"""Gradient Blending training (port of ``kstar_tpu/train/gb.py``, a rebuild
of reference src/GradientBlending.py).

  * per-stream train/eval steps: the reference gates streams by mutating
    ``model.use_stream`` and reloading checkpoints (reference :74-76); here
    each stream is its own step over the same ``TrainState``. After the
    guarded update of a ``video`` or ``0D`` probe step the parameters
    OUTSIDE the active stream's submodule (``vis_model`` / ``ts_model``) are
    put back as they were before the step, while the optimizer moments and
    count of every parameter move, exactly as the JAX step restores the
    frozen top-level subtrees after ``guarded_update`` (torch skips
    parameters with ``grad=None``; AdamW's decay would otherwise shrink
    the inactive stream);
  * ``gb_estimate``: offline G-Blend weight estimation (reference
    GB_estimate :52-114): per stream, train a copy of the state for n
    epochs, measure the overfitting Oi/Of and the generalisation G, weight
    w = G/(Of-Oi)^2, normalise. One numpy ``default_rng(seed)`` is shared by
    the three streams in the order video, 0D, multi, so the batches match
    JAX's;
  * ``fit_gb``: the train_GB / train_GB_dynamic epoch driver (reference
    :165-446): the GB-weighted three-stream loss, optional periodic
    re-estimation, per-stream valid-F1 logging, best/last checkpoints (the
    best one records the ``gb_weights``).

Every step, epoch loop and estimate takes ``mesh=`` and is then data-parallel
over its data group as ``train/loop.py``'s are (the probes' copies too:
each rank copies its replica, so the probes stay replicas); only rank 0
writes.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import LossConfig, TrainConfig
from ..data.loader import (epoch_batches, eval_batches, grouped_batches,
                           threaded_batches, to_device)
from ..losses import classification_loss, estimate_gb_weights
from ..parallel.comm import all_gather_cat, all_reduce_, broadcast_object, data_parallel
from .early_stopping import EarlyStopping
from .logging import MetricWriter
from .loop import (History, _loss_aux, default_puts, guarded_update, make_eval_step,
                   make_scan_steps, make_train_step, run_eval_epoch, run_train_epoch,
                   save_on_mesh)
from .metrics import macro_f1
from .state import TrainState

STREAMS = ("video", "0D", "multi")
# the submodule a single-stream probe trains; everything else is put back
_ACTIVE = {"video": "vis_model", "0D": "ts_model"}


def _stream_logits(model, batch, stream: str, **kw) -> torch.Tensor:
    if stream == "video":
        return model.forward_video(batch["video"], **kw)
    if stream == "0D":
        return model.forward_ts(batch["0D"], **kw)
    return model(batch["video"], batch["0D"], **kw)[0]


def _outside(state: TrainState, submodule: str):
    """The flat-buffer ranges NOT under ``submodule``."""
    out, start = [], 0
    for a, b in state.flat_ranges(submodule):
        if a > start:
            out.append((start, a))
        start = b
    if start < state.flat.numel():
        out.append((start, state.flat.numel()))
    return out


def make_stream_step(loss_cfg: LossConfig, stream: str,
                     pre_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """step(state, batch, labels, weight, m_list) -> (state, loss): one
    train step of one stream of a *-GB model. ``stream`` selects the
    forward and the logits the loss sees; the update is guarded as in
    ``make_train_step``. The 0D stream skips ``pre_fn`` (it only prepares
    the video, which that stream never reads)."""
    if stream not in STREAMS:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    active = _ACTIVE.get(stream)

    def step(state: TrainState, batch, labels, weight, m_list):
        gen_pre, gen_drop, gen_noise = state.next_generators()
        with data_parallel(mesh):
            if pre_fn is not None and stream != "0D":
                batch = pre_fn(gen_pre, batch)
            for p in state.params:
                p.grad = None
            stats_before = state.snapshot_stats()
            out = _stream_logits(state.model, batch, stream, train=True,
                                 generator=gen_drop, noise_generator=gen_noise)
            loss = classification_loss(out, labels, loss_cfg.loss_type, weight=weight,
                                       gamma=loss_cfg.focal_gamma, m_list=m_list,
                                       s=loss_cfg.ldam_s)
            loss.backward()
        before = state.flat.clone() if active is not None else None
        loss = guarded_update(state, loss.detach(), stats_before, mesh)
        if active is not None:
            with torch.no_grad():
                for a, b in _outside(state, active):
                    state.flat[a:b] = before[a:b]
        return state, loss

    return step


def make_stream_scan_steps(loss_cfg: LossConfig, stream: str,
                           pre_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """K probe steps per call over a (K, B, ...) stack of device batches
    (the ``make_scan_steps`` pattern): the same trajectory as K calls of
    ``make_stream_step``'s step. Returns (state, losses (K,))."""
    step = make_stream_step(loss_cfg, stream, pre_fn, mesh)

    def multi_step(state: TrainState, batches, labels, weight, m_list):
        losses = []
        for i in range(labels.shape[0]):
            state, loss = step(state, {k: v[i] for k, v in batches.items()},
                               labels[i], weight, m_list)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step


def make_stream_eval(loss_cfg: LossConfig, stream: str,
                     pre_fn: Optional[Callable] = None, mesh=None) -> Callable:
    """eval(model, batch, labels, weight, m_list, mask) -> (loss, preds) of
    one stream in evaluation mode (on a mesh: the global batch's loss and
    predictions)."""

    @torch.no_grad()
    def step(model, batch, labels, weight, m_list, mask):
        with data_parallel(mesh):
            if pre_fn is not None:
                batch = pre_fn(None, batch)
            out = _stream_logits(model, batch, stream, train=False)
            loss = classification_loss(out, labels, loss_cfg.loss_type, weight=weight,
                                       mask=mask, gamma=loss_cfg.focal_gamma,
                                       m_list=m_list, s=loss_cfg.ldam_s)
        preds = out.argmax(-1)
        if mesh is not None:
            loss = all_reduce_(loss.clone(), mesh.data_group)
            preds = all_gather_cat(preds, mesh.data_group, mesh.shape["data"])
        return loss, preds

    return step


def _epoch_stream(step, state, dataset, batch_size, rng, weight, m_list, put=None,
                  scan_step=None, steps_per_dispatch: int = 1, mesh=None):
    """One probe epoch of one stream: (state, summed batch losses / samples)."""
    put, put_stack = default_puts(state.device, mesh, put)
    dev_losses, n = [], 0
    idx_iter = epoch_batches(len(dataset), batch_size, rng)
    if scan_step is not None and steps_per_dispatch > 1:
        for kind, (batch, labels) in grouped_batches(dataset, idx_iter,
                                                     steps_per_dispatch, put,
                                                     put_stack=put_stack):
            if kind == "stack":
                state, losses_k = scan_step(state, batch, labels, weight, m_list)
                dev_losses.append(losses_k.sum())
            else:
                state, loss = step(state, batch, labels, weight, m_list)
                dev_losses.append(loss)
            n += labels.numel()
    else:
        for batch, labels in threaded_batches(dataset, idx_iter, put):
            state, loss = step(state, batch, labels, weight, m_list)
            dev_losses.append(loss)        # stays on the device; one fetch at the end
            n += len(labels)
    if n == 0:
        return state, 0.0
    if mesh is not None:
        n *= mesh.shape["data"]              # the losses are the global batches'
    return state, float(torch.stack(dev_losses).sum()) / n


def _eval_stream(step, model, dataset, batch_size, weight, m_list, put=None, mesh=None):
    """One stream's (mean loss, macro-F1) over ``dataset``."""
    device = next(model.parameters()).device
    put = put or default_puts(device, mesh)[0]
    if mesh is None:
        put_mask = lambda m: to_device(m, device)
    else:
        from ..parallel.mesh import put_batch
        put_mask = lambda m: put_batch(mesh, m)
    dev_losses, dev_preds, dev_labels, masks, n = [], [], [], [], 0
    for idx, mask in eval_batches(len(dataset), batch_size):
        item = dataset.batch(idx)
        batch, labels = put(item)
        loss, preds = step(model, batch, labels, weight, m_list,
                           put_mask(mask.astype(np.float32)))
        dev_losses.append(loss)
        dev_preds.append(preds)
        dev_labels.append(labels if mesh is None else torch.as_tensor(item[1]))
        masks.append(mask)
        n += int(mask.sum())
    if n == 0:
        return 0.0, 0.0
    total = float(torch.stack(dev_losses).sum())      # one host sync
    mask_all = np.concatenate(masks)
    preds = torch.cat(dev_preds).cpu().numpy()[mask_all]
    labels = torch.cat(dev_labels).cpu().numpy()[mask_all]
    return total / n, macro_f1(labels, preds)


def gb_estimate(
    state: TrainState, train_ds, valid_ds,
    loss_cfg: LossConfig, batch_size: int, n_epochs: int = 4,
    seed: int = 42, put=None, pre_fn=None, pre_fn_eval=None,
    steps_per_dispatch: int = 1,
    step_cache: Optional[Dict] = None,
    mesh=None,
) -> Dict[str, float]:
    """Offline G-Blend estimate. The reference reloads last.pt per stream
    (reference :74-76); here each stream trains from a copy of the current
    state (``TrainState.copy``), so ``state`` is left as it was. Pass a
    ``step_cache`` dict when calling repeatedly (``fit_gb``'s dynamic
    re-estimation does) to build the per-stream steps once."""
    counts = train_ds.class_counts()
    weight, m_list = _loss_aux(loss_cfg, counts, 0, max(n_epochs, 1), state.device)

    train_hist: Dict[str, list] = {}
    valid_hist: Dict[str, list] = {}
    rng = np.random.default_rng(seed)
    cache = step_cache if step_cache is not None else {}

    for stream in STREAMS:
        if (stream, "step") not in cache:
            cache[(stream, "step")] = make_stream_step(loss_cfg, stream, pre_fn=pre_fn,
                                                       mesh=mesh)
            cache[(stream, "scan")] = (
                make_stream_scan_steps(loss_cfg, stream, pre_fn=pre_fn, mesh=mesh)
                if steps_per_dispatch > 1 else None)
            cache[(stream, "eval")] = make_stream_eval(loss_cfg, stream,
                                                       pre_fn=pre_fn_eval, mesh=mesh)
        step, scan_step = cache[(stream, "step")], cache[(stream, "scan")]
        ev = cache[(stream, "eval")]
        probe = state.copy()
        tr_losses, va_losses = [], []
        for _ in range(n_epochs):
            probe, tr = _epoch_stream(step, probe, train_ds, batch_size, rng, weight,
                                      m_list, put, scan_step=scan_step,
                                      steps_per_dispatch=steps_per_dispatch, mesh=mesh)
            va, _ = _eval_stream(ev, probe.model, valid_ds, batch_size, weight,
                                 m_list, put, mesh=mesh)
            tr_losses.append(tr)
            va_losses.append(va)
        train_hist[stream] = tr_losses
        valid_hist[stream] = va_losses
        del probe

    return estimate_gb_weights(train_hist, valid_hist)


def fit_gb(
    state: TrainState,
    train_ds,
    valid_ds,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    tag: str = "gb",
    gb_weights: Optional[Dict[str, float]] = None,
    dynamic: bool = False,
    epoch_per_gb_estimate: int = 16,
    n_epochs_gb_estimate: int = 4,
    sampler=None,
    writer: Optional[MetricWriter] = None,
    put=None,
    pre_fn=None,
    pre_fn_eval=None,
    mesh=None,
) -> Tuple[TrainState, History, Dict[str, float]]:
    """train_GB / train_GB_dynamic driver (reference :165-446). Initial
    weights default to the reference's w_fusion=.5, w_vis=.1, w_0D=.4
    (reference train_multimodal.py:374-385). Returns (state, history, the
    last GB weights). ``mesh``: data-parallel, as ``fit(mesh=)``."""
    gb_weights = gb_weights or {"video": 0.1, "0D": 0.4, "multi": 0.5}
    as_tensor = lambda w: torch.tensor([w["video"], w["0D"], w["multi"]],
                                       dtype=torch.float32, device=state.device)
    gb_arr = as_tensor(gb_weights)

    train_step = make_train_step(loss_cfg, pre_fn=pre_fn, model_type="multi-GB", mesh=mesh)
    eval_step = make_eval_step(loss_cfg, pre_fn=pre_fn_eval, model_type="multi-GB",
                               mesh=mesh)
    k = train_cfg.steps_per_dispatch
    scan_step = (make_scan_steps(loss_cfg, pre_fn=pre_fn, model_type="multi-GB", mesh=mesh)
                 if k > 1 else None)
    stream_evals = {s: make_stream_eval(loss_cfg, s, pre_fn=pre_fn_eval, mesh=mesh)
                    for s in STREAMS}
    main = mesh is None or mesh.is_main
    if not main:
        writer = None
    # the per-stream valid evals are collective on a mesh: every rank runs
    # them where rank 0 logs them
    monitor = broadcast_object(writer is not None) if mesh is not None else writer is not None

    counts = train_ds.class_counts()
    rng = np.random.default_rng(train_cfg.seed)
    stopper = EarlyStopping(train_cfg.early_stopping_patience,
                            train_cfg.early_stopping_delta) if train_cfg.early_stopping else None
    hist = History()

    os.makedirs(train_cfg.weight_dir, exist_ok=True)
    last_path = os.path.join(train_cfg.weight_dir, f"{tag}_last.ckpt")
    best_path = os.path.join(train_cfg.weight_dir, f"{tag}_best.ckpt")

    gb_step_cache: Dict = {}       # shared across re-estimations
    for epoch in range(train_cfg.num_epoch):
        weight, m_list = _loss_aux(loss_cfg, counts, epoch, train_cfg.num_epoch,
                                   state.device)

        if dynamic and epoch > 0 and epoch % epoch_per_gb_estimate == 0:
            gb_weights = gb_estimate(state, train_ds, valid_ds, loss_cfg,
                                     train_cfg.batch_size, n_epochs_gb_estimate,
                                     train_cfg.seed, put, pre_fn=pre_fn,
                                     pre_fn_eval=pre_fn_eval, steps_per_dispatch=k,
                                     step_cache=gb_step_cache, mesh=mesh)
            gb_arr = as_tensor(gb_weights)
            if writer:
                writer.scalars({f"GB/{name}": v for name, v in gb_weights.items()}, epoch)

        state, tr_loss, tr_acc, tr_f1 = run_train_epoch(
            train_step, state, train_ds, train_cfg.batch_size, rng, weight, m_list,
            sampler=sampler, put=put, scan_step=scan_step, steps_per_dispatch=k,
            gb_w=gb_arr, mesh=mesh)
        va_loss, va_acc, va_f1 = run_eval_epoch(
            eval_step, state.model, valid_ds, train_cfg.batch_size, weight, m_list,
            put=put, gb_w=gb_arr, mesh=mesh)

        hist.train_loss.append(tr_loss); hist.valid_loss.append(va_loss)
        hist.train_f1.append(tr_f1); hist.valid_f1.append(va_f1)
        hist.train_acc.append(tr_acc); hist.valid_acc.append(va_acc)

        if writer:
            writer.scalars({"Loss/train": tr_loss, "Loss/valid": va_loss,
                            "F1/train": tr_f1, "F1/valid": va_f1}, epoch)
        if monitor:
            # per-stream valid F1 monitoring (reference evaluate_GB :116-163)
            for stream, ev in stream_evals.items():
                _, f1_s = _eval_stream(ev, state.model, valid_ds, train_cfg.batch_size,
                                       weight, m_list, put, mesh=mesh)
                if writer:
                    writer.scalar(f"F1_valid/{stream}", f1_s, epoch)

        if main and train_cfg.verbose and epoch % train_cfg.verbose == 0:
            print(f"epoch {epoch+1:3d} | GB w={gb_arr.cpu().numpy().round(3)} | "
                  f"train loss {tr_loss:.4f} f1 {tr_f1:.4f} | valid f1 {va_f1:.4f}")

        save_on_mesh(state, last_path, mesh)
        improved = stopper(va_f1) if stopper else va_f1 > hist.best_f1
        if improved:
            hist.best_f1 = va_f1
            hist.best_epoch = epoch
            save_on_mesh(state, best_path, mesh, extra={"epoch": epoch, "valid_f1": va_f1,
                                                        "gb_weights": gb_weights})
        if stopper and stopper.should_stop:
            if main:
                print(f"early stopping at epoch {epoch+1}")
            break

    return state, hist, gb_weights
