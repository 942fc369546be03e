"""Train/eval steps + epoch drivers.

Port of ``kstar_tpu/train/loop.py`` (rebuild of reference src/train.py
train_per_epoch/valid_per_epoch/train/train_DRW):

  * class weights and LDAM margins are tensor inputs of the step, so DRW
    changes them per epoch without rebuilding anything;
  * the NaN-loss skip guard (reference src/train.py:56-58) is a
    ``torch.where`` select on the device (``TrainState.apply_gradients``):
    no host sync per step;
  * preprocessing (``pre_fn``: crop / augment / normalize of the raw uint8
    batch) runs inside the step, on the device;
  * each step draws from three generators on the device seeded from
    (seed, step count) (``TrainState.next_generators``): one for
    ``pre_fn``, one for the dropout masks, one for the 0D models' input
    noise (JAX's ``pre``, ``dropout`` and ``noise`` keys);
  * the model's BatchNorm statistics move in the train forward and the NaN
    guard puts them back on a skipped step, as ``guarded_update`` does;
  * per-step losses and predictions stay on the device; the host fetches
    them once per epoch, so step N+1 is queued while step N runs;
  * metrics (macro-F1) accumulate host-side like the reference's sklearn
    f1_score over the epoch's predictions.

``model_type`` picks the model's inputs and loss, as in the JAX loop:
``"single"`` (one input, the classification loss), ``"multi"`` (a fusion
model called on ``batch["video"], batch["0D"]``) and ``"multi-GB"`` (the
same call returning the (multi, vis, ts) logits, scored by
``gradient_blending_loss`` with the (3,) device weights ``gb_w``; the
predictions come from the multi logits).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import LossConfig, TrainConfig
from ..data.loader import (epoch_batches, eval_batches, grouped_batches,
                           prefetch_to_device, threaded_batches, to_device)
from ..losses import (classification_loss, drw_weights, gradient_blending_loss,
                      inverse_freq_weights, ldam_margins)
from .early_stopping import EarlyStopping
from .logging import MetricWriter
from .metrics import accuracy, macro_f1
from .state import TrainState, save_checkpoint


MODEL_TYPES = ("single", "multi", "multi-GB")


def _check_model_type(model_type: str) -> None:
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type must be one of {MODEL_TYPES}, got {model_type!r}")


def _model_outputs(model, batch, model_type: str, **kw):
    """The model's forward on one input (``"single"``) or on a multimodal
    {'video', '0D'} batch; a (multi, vis, ts) triple for ``"multi-GB"``."""
    if model_type == "single":
        return model(batch, **kw)
    return model(batch["video"], batch["0D"], **kw)


def _loss_and_logits(out, labels, loss_cfg: LossConfig, model_type: str, weight,
                     m_list, gb_w=None, mask=None):
    """(loss, logits): the classification loss of the logits, or for
    ``"multi-GB"`` the Gradient-Blending loss of the triple weighted by
    ``gb_w`` with the multi logits."""
    kw = dict(weight=weight, mask=mask, gamma=loss_cfg.focal_gamma, m_list=m_list,
              s=loss_cfg.ldam_s)
    if model_type == "multi-GB":
        out_multi, out_vis, out_ts = out
        return gradient_blending_loss(out_multi, out_vis, out_ts, labels, gb_w,
                                      loss_type=loss_cfg.loss_type, **kw), out_multi
    return classification_loss(out, labels, loss_cfg.loss_type, **kw), out


def make_train_step(loss_cfg: LossConfig, pre_fn: Optional[Callable] = None,
                    model_type: str = "single") -> Callable:
    """step(state, batch, labels, weight, m_list, gb_w=None)
    -> (state, loss, preds).

    One optimizer step of ``state.model`` on a device batch: ``pre_fn(gen,
    batch)`` (optional), the forward in training mode with dropout (and,
    for the 0D models and encoders, the input noise) drawn from the step's
    generators, the loss (``model_type``), backward, and the guarded
    update. ``loss`` and ``preds`` stay on the device."""
    _check_model_type(model_type)

    def step(state: TrainState, batch, labels, weight, m_list, gb_w=None):
        gen_pre, gen_drop, gen_noise = state.next_generators()
        if pre_fn is not None:
            batch = pre_fn(gen_pre, batch)
        for p in state.params:
            p.grad = None
        stats_before = state.snapshot_stats()
        out = _model_outputs(state.model, batch, model_type, train=True,
                             generator=gen_drop, noise_generator=gen_noise)
        loss, logits = _loss_and_logits(out, labels, loss_cfg, model_type, weight,
                                        m_list, gb_w)
        loss.backward()
        loss = loss.detach()
        state.apply_gradients(torch.isfinite(loss), stats_before)
        return state, loss, logits.detach().argmax(-1)

    return step


def make_scan_steps(loss_cfg: LossConfig, pre_fn: Optional[Callable] = None,
                    model_type: str = "single") -> Callable:
    """K steps per call over a (K, B, ...) stack of device batches:

    multi_step(state, batches, labels, weight, m_list, gb_w=None)
        -> (state, losses (K,), preds (K, B))

    The same step function and the same per-step generators as K calls of
    ``make_train_step``'s step, so the trajectory is the same (JAX's
    ``lax.scan`` version amortizes a per-dispatch link latency; here it
    takes one stacked upload per K batches)."""
    step = make_train_step(loss_cfg, pre_fn, model_type)

    def multi_step(state: TrainState, batches, labels, weight, m_list, gb_w=None):
        losses, preds = [], []
        for i in range(labels.shape[0]):
            b = ({k: v[i] for k, v in batches.items()} if isinstance(batches, dict)
                 else batches[i])
            state, loss, pred = step(state, b, labels[i], weight, m_list, gb_w)
            losses.append(loss)
            preds.append(pred)
        return state, torch.stack(losses), torch.stack(preds)

    return multi_step


def make_eval_step(loss_cfg: LossConfig, pre_fn: Optional[Callable] = None,
                   model_type: str = "single") -> Callable:
    """eval_step(model, batch, labels, weight, m_list, mask, gb_w=None)
    -> (loss, probs, preds); probs = softmax(logits) in f32 (the multi
    logits for ``"multi-GB"``), the loss counts only the samples where
    ``mask`` is 1."""
    _check_model_type(model_type)

    @torch.no_grad()
    def step(model, batch, labels, weight, m_list, mask, gb_w=None):
        if pre_fn is not None:
            batch = pre_fn(None, batch)
        out = _model_outputs(model, batch, model_type, train=False)
        loss, logits = _loss_and_logits(out, labels, loss_cfg, model_type, weight,
                                        m_list, gb_w, mask)
        return loss, torch.softmax(logits.float(), dim=-1), logits.argmax(-1)

    return step


# ---------------------------------------------------------------------------
# epoch drivers
# ---------------------------------------------------------------------------

@dataclass
class History:
    train_loss: List[float] = field(default_factory=list)
    valid_loss: List[float] = field(default_factory=list)
    train_f1: List[float] = field(default_factory=list)
    valid_f1: List[float] = field(default_factory=list)
    train_acc: List[float] = field(default_factory=list)
    valid_acc: List[float] = field(default_factory=list)
    epoch_s: List[float] = field(default_factory=list)   # wall-clock per epoch
    best_epoch: int = 0
    best_f1: float = 0.0


def _loss_aux(loss_cfg: LossConfig, cls_counts: np.ndarray, epoch: int,
              num_epoch: int, device):
    """Per-epoch (weight, m_list) tensors for the step functions."""
    if loss_cfg.use_drw:
        weight = drw_weights(epoch, num_epoch, cls_counts, loss_cfg.drw_beta)
    elif loss_cfg.use_weighting:
        weight = inverse_freq_weights(cls_counts)
    else:
        weight = np.ones(len(cls_counts), np.float32)
    m_list = ldam_margins(cls_counts, loss_cfg.ldam_max_m)
    return (torch.as_tensor(weight).to(device), torch.as_tensor(m_list).to(device))


def run_train_epoch(train_step, state: TrainState, dataset, batch_size, rng,
                    weight, m_list, sampler=None, put=None, prefetch=True,
                    scan_step=None, steps_per_dispatch: int = 1, gb_w=None):
    """One training epoch, pipelined: batches are gathered (and put on the
    device) by a producer thread ahead of consumption, and the per-step
    losses/preds stay on the device until the epoch ends (one host sync).

    scan_step + steps_per_dispatch > 1: full groups of K batches run through
    the K-step call (make_scan_steps); the remainder through ``train_step``.
    ``gb_w``: the (3,) Gradient-Blending weights of a ``"multi-GB"`` step.
    Returns (state, mean loss, accuracy, macro-F1)."""
    if put is None:
        put = lambda item: to_device(item, state.device)
    n_samples = 0
    dev_losses, dev_preds, dev_labels = [], [], []
    idx_iter = epoch_batches(len(dataset), batch_size, rng, sampler=sampler)

    if scan_step is not None and steps_per_dispatch > 1:
        for kind, (batch, labels) in grouped_batches(dataset, idx_iter,
                                                     steps_per_dispatch, put):
            if kind == "stack":
                state, losses_k, preds_k = scan_step(state, batch, labels, weight, m_list,
                                                     gb_w)
                dev_losses.append(losses_k.sum())
                dev_preds.append(preds_k.reshape(-1))
            else:
                state, loss, preds = train_step(state, batch, labels, weight, m_list,
                                                gb_w)
                dev_losses.append(loss)
                dev_preds.append(preds)
            n_samples += labels.numel()
            dev_labels.append(labels.reshape(-1))
    else:
        if prefetch:
            batch_iter = threaded_batches(dataset, idx_iter, put)
        else:
            batch_iter = prefetch_to_device((dataset.batch(idx) for idx in idx_iter), put)
        for batch, labels in batch_iter:
            state, loss, preds = train_step(state, batch, labels, weight, m_list, gb_w)
            dev_losses.append(loss)
            dev_preds.append(preds)
            dev_labels.append(labels)
            n_samples += batch_size
    if n_samples == 0:
        return state, 0.0, 0.0, 0.0
    losses = float(torch.stack(dev_losses).sum())          # the epoch's one sync
    preds = torch.cat(dev_preds).cpu().numpy()
    labels = torch.cat(dev_labels).cpu().numpy()
    return state, losses / n_samples, accuracy(labels, preds), macro_f1(labels, preds)


def run_eval_epoch(eval_step, model, dataset, batch_size, weight, m_list,
                   put=None, collect_probs: bool = False, gb_w=None):
    """One pass over ``dataset`` in fixed-size batches (the tail padded and
    masked out). Returns (mean loss, accuracy, macro-F1) and, with
    ``collect_probs``, ((N, 2) probabilities, (N,) labels). ``gb_w``: the
    Gradient-Blending weights of a ``"multi-GB"`` eval step."""
    device = next(model.parameters()).device
    if put is None:
        put = lambda item: to_device(item, device)
    n_samples = 0
    dev_losses, dev_preds, dev_probs, dev_labels, all_masks = [], [], [], [], []
    for idx, mask in eval_batches(len(dataset), batch_size):
        batch, labels = put(dataset.batch(idx))
        loss, probs, preds = eval_step(model, batch, labels, weight, m_list,
                                       to_device(mask.astype(np.float32), device), gb_w)
        dev_losses.append(loss)
        dev_preds.append(preds)
        if collect_probs:
            dev_probs.append(probs)
        dev_labels.append(labels)
        n_samples += int(mask.sum())
        all_masks.append(mask)
    if n_samples == 0:
        out = (0.0, 0.0, 0.0)
        return out + ((np.zeros((0, 2)), np.zeros((0,))),) if collect_probs else out
    # device results fetched once after every batch is queued
    losses = float(torch.stack(dev_losses).sum())
    mask_all = np.concatenate(all_masks)
    preds = torch.cat(dev_preds).cpu().numpy()[mask_all]
    labels = torch.cat(dev_labels).cpu().numpy()[mask_all]
    res = (losses / n_samples, accuracy(labels, preds), macro_f1(labels, preds))
    if collect_probs:
        probs_all = torch.cat(dev_probs).cpu().numpy()[mask_all]
        return res + ((probs_all, labels),)
    return res


def fit(
    state: TrainState,
    train_ds,
    valid_ds,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    model_type: str = "single",
    tag: str = "model",
    sampler=None,
    writer: Optional[MetricWriter] = None,
    gb_weights: Optional[np.ndarray] = None,
    num_epoch: Optional[int] = None,
    put=None,
    put_eval=None,
    pre_fn=None,
    pre_fn_eval=None,
    eval_stats_fn: Optional[Callable] = None,
) -> Tuple[TrainState, History]:
    """Epoch driver covering the reference's ``train`` and ``train_DRW``
    (src/train.py:147-274, :277-422): per-epoch train/valid, metric logging,
    last/best checkpointing on valid macro-F1, early stopping, optional DRW.
    ``put`` moves a host (batch, labels) pair to the device (default: to the
    state's device); ``pre_fn``/``pre_fn_eval`` preprocess inside the
    steps; ``model_type`` and ``gb_weights`` ((3,), zeros by default) as in
    ``make_train_step``.

    ``eval_stats_fn(model)`` runs after each train epoch, before validation,
    and writes the model's statistics in place, so the state and both
    checkpoints carry its result: the SubBatchNorm aggregate-before-eval
    contract (``models.aggregate_batch_stats``; reference aggregate_stats,
    src/models/resnet.py:52-61)."""
    num_epoch = num_epoch or train_cfg.num_epoch
    train_step = make_train_step(loss_cfg, pre_fn=pre_fn, model_type=model_type)
    eval_step = make_eval_step(loss_cfg, pre_fn=pre_fn_eval, model_type=model_type)
    k = train_cfg.steps_per_dispatch
    scan_step = (make_scan_steps(loss_cfg, pre_fn=pre_fn, model_type=model_type)
                 if k > 1 else None)

    cls_counts = train_ds.class_counts()
    gb_w = torch.as_tensor(gb_weights if gb_weights is not None else np.zeros(3),
                           dtype=torch.float32).to(state.device)
    rng = np.random.default_rng(train_cfg.seed)
    stopper = EarlyStopping(train_cfg.early_stopping_patience,
                            train_cfg.early_stopping_delta) if train_cfg.early_stopping else None
    hist = History()

    os.makedirs(train_cfg.weight_dir, exist_ok=True)
    last_path = os.path.join(train_cfg.weight_dir, f"{tag}_last.ckpt")
    best_path = os.path.join(train_cfg.weight_dir, f"{tag}_best.ckpt")

    for epoch in range(num_epoch):
        weight, m_list = _loss_aux(loss_cfg, cls_counts, epoch, num_epoch, state.device)

        t_ep = time.perf_counter()
        state, tr_loss, tr_acc, tr_f1 = run_train_epoch(
            train_step, state, train_ds, train_cfg.batch_size, rng,
            weight, m_list, sampler=sampler, put=put,
            scan_step=scan_step, steps_per_dispatch=k, gb_w=gb_w)
        if eval_stats_fn is not None:
            with torch.no_grad():
                eval_stats_fn(state.model)
        # the valid probabilities feed the evaluation figure of a new best
        va_loss, va_acc, va_f1, *va_probs = run_eval_epoch(
            eval_step, state.model, valid_ds, train_cfg.batch_size, weight, m_list,
            put=put_eval if put_eval is not None else put, gb_w=gb_w,
            collect_probs=writer is not None)
        ep_s = time.perf_counter() - t_ep

        hist.train_loss.append(tr_loss); hist.valid_loss.append(va_loss)
        hist.train_acc.append(tr_acc); hist.valid_acc.append(va_acc)
        hist.train_f1.append(tr_f1); hist.valid_f1.append(va_f1)
        hist.epoch_s.append(ep_s)

        if writer:
            writer.scalars({"Loss/train": tr_loss, "Loss/valid": va_loss,
                            "F1/train": tr_f1, "F1/valid": va_f1,
                            "time/epoch_s": ep_s}, epoch)
        if train_cfg.verbose and epoch % train_cfg.verbose == 0:
            print(f"epoch {epoch+1:3d} | train loss {tr_loss:.4f} f1 {tr_f1:.4f} "
                  f"| valid loss {va_loss:.4f} f1 {va_f1:.4f} | {ep_s:.1f}s")

        save_checkpoint(state, last_path)
        improved = stopper(va_f1) if stopper else va_f1 > hist.best_f1
        if improved:
            hist.best_f1 = va_f1
            hist.best_epoch = epoch
            save_checkpoint(state, best_path, extra={"epoch": epoch, "valid_f1": va_f1})
            if writer:
                # evaluation figure on improvement (the reference emits one
                # per epoch via evaluate_tensorboard, src/train.py:242-245)
                try:
                    from ..eval.evaluate import evaluate_probs, evaluation_figure
                    probs, labels = va_probs[0]
                    fig = evaluation_figure(evaluate_probs(probs, labels))
                    writer.figure("eval/valid", fig, epoch)
                    import matplotlib.pyplot as plt
                    plt.close(fig)
                except Exception as e:  # figure emission is best-effort,
                    # but a broken pipeline must surface in the logs
                    print(f"[fit] eval figure emission failed: {type(e).__name__}: {e}")
        if stopper and stopper.should_stop:
            print(f"early stopping at epoch {epoch+1}")
            break

    return state, hist
