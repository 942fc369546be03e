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
  * since nothing in a step waits for the host, on one CUDA device the
    whole step is captured once as a CUDA graph and replayed (``_TrainStep``):
    one launch a step in place of several hundred;
  * metrics (macro-F1) accumulate host-side like the reference's sklearn
    f1_score over the epoch's predictions.

``mesh`` (``parallel/mesh.py``) makes each step data-parallel over the
mesh's data group (``parallel/dp.py`` says what that takes): the step runs
in ``parallel.comm.data_parallel``, the loss and the flat gradient are
summed over the group in one ``all_reduce`` before the guarded update, and
the eval step gathers its probabilities and predictions. With no mesh the
steps compute exactly what they computed before.

``model_type`` picks the model's inputs and loss, as in the JAX loop:
``"single"`` (one input, the classification loss), ``"multi"`` (a fusion
model called on ``batch["video"], batch["0D"]``) and ``"multi-GB"`` (the
same call returning the (multi, vis, ts) logits, scored by
``gradient_blending_loss`` with the (3,) device weights ``gb_w``; the
predictions come from the multi logits).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import LossConfig, TrainConfig
from ..data.loader import (epoch_batches, eval_batches, grouped_batches,
                           prefetch_to_device, threaded_batches, to_device)
from ..losses import (classification_loss, drw_weights, gradient_blending_loss,
                      inverse_freq_weights, ldam_margins)
from ..parallel.comm import all_gather_cat, all_reduce_, barrier, data_parallel
from ..utils.graphs import capture, on_capture_stream, storage_key
from ..utils.profiling import span
from .early_stopping import EarlyStopping
from .logging import MetricWriter
from .metrics import accuracy, macro_f1
from .state import TrainState, save_checkpoint, save_checkpoint_sharded


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


def guarded_update(state: TrainState, loss: torch.Tensor, stats_before, mesh):
    """The NaN-guarded update after a backward. On a mesh this rank's flat
    gradient, with the loss appended, is summed over the data group in one
    ``all_reduce``, and the update of the summed gradient is decided on the
    global loss, so every rank steps or every rank skips. Returns the
    (global) loss."""
    if mesh is None:
        state.apply_gradients(torch.isfinite(loss), stats_before)
        return loss
    buf = all_reduce_(torch.cat([state.flat_grads(), loss.reshape(1).float()]),
                      mesh.data_group)
    state.apply_gradients(torch.isfinite(buf[-1]), stats_before, buf[:-1])
    return buf[-1]


@dataclass
class _StepGraph:
    """One captured train step: the key it was captured under, the graph,
    its static inputs (batch, labels, weight, m_list, gb_w), its three
    registered generators and its outputs (loss, preds)."""
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    gens: tuple
    loss: torch.Tensor
    preds: torch.Tensor


_THREAD = threading.local()


def _thread_token() -> object:
    """An object of the calling thread's own, for a graph's key: a state
    stepped on another thread recaptures there."""
    if not hasattr(_THREAD, "token"):
        _THREAD.token, _THREAD.newest = object(), {}
    return _THREAD.token


def _shared_pool(device) -> Optional[tuple]:
    """The memory pool of this thread's newest live train-step graph on
    ``device`` (None: a new pool). A thread replays its graphs one at a time
    on one stream, and each replay's outputs are cloned before the next
    replay, so one step's working set serves every state the thread steps
    (an ensemble's members, the Gradient-Blending probes). A pool is taken
    from a live graph only: CUDA frees a pool with its last graph."""
    ref = getattr(_THREAD, "newest", {}).get(torch.device(device))
    graph = ref() if ref is not None else None
    return None if graph is None else graph.graph.pool()


def _tensors(inputs) -> list:
    """The step's inputs as a flat list (a dict batch key by key; None
    kept)."""
    batch, *rest = inputs
    return ([batch[k] for k in sorted(batch)] if isinstance(batch, dict) else [batch]) + rest


def _signature(inputs) -> tuple:
    """The inputs' shapes and dtypes (and a dict batch's keys)."""
    batch = inputs[0]
    return (tuple(sorted(batch)) if isinstance(batch, dict) else None,
            tuple(None if t is None else (t.shape, t.dtype) for t in _tensors(inputs)))


def _static_like(inputs) -> tuple:
    """Fresh device buffers of the inputs' shapes and dtypes."""
    make = lambda t: None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                                        device=t.device)
    batch, *rest = inputs
    batch = ({k: make(v) for k, v in batch.items()} if isinstance(batch, dict)
             else make(batch))
    return (batch, *(make(t) for t in rest))


class _TrainStep:
    """``make_train_step``'s step (its docstring). On one CUDA device
    (``state.device`` CUDA and no mesh) the step is one captured CUDA graph
    per state, keyed by the inputs' shapes and dtypes, the storage of every
    parameter, buffer, optimizer tensor and of ``state.step``, ``pre_fn``,
    ``model_type``, the loss, and the calling thread (``_thread_token``;
    one thread's graphs share a memory pool, ``_shared_pool``). A step whose
    key is neither the graph's nor that of the state's last eager step runs
    eagerly on the capture stream (``utils/graphs.py``); the next step of
    that key captures the whole step (``pre_fn``, forward, loss, backward,
    guarded update) and replays it; each later one copies its inputs into
    the graph's, reseeds the graph's generators as ``next_generators``
    seeds new ones and replays, drawing and computing what the eager step
    does. Elsewhere (the CPU, a mesh) every step runs eagerly.

    The step function holds each state's graph weakly by the state
    (``graph_of``): a graph goes with its state or with the step function,
    whichever goes first, so a finished ``fit`` (an HPO trial's rung) holds
    no graph however long its state is kept. The graphs of one step
    function share their static inputs (an ensemble's members take the same
    batch). ``graph_captures`` counts the captures, ``graphed_steps`` the
    steps replayed."""

    def __init__(self, loss_cfg: LossConfig, pre_fn: Optional[Callable],
                 model_type: str, mesh):
        _check_model_type(model_type)
        self.loss_cfg, self.pre_fn, self.model_type, self.mesh = (
            loss_cfg, pre_fn, model_type, mesh)
        self.graph_captures = self.graphed_steps = 0
        self._held = weakref.WeakKeyDictionary()    # state -> [last eager key, graph]
        self._static: dict = {}                     # (signature, thread) -> static inputs

    def graph_of(self, state: TrainState) -> Optional[_StepGraph]:
        """The graph this step function holds for ``state``, if any."""
        return self._held.get(state, (None, None))[1]

    def _forward(self, state: TrainState, gens, batch, labels, weight, m_list, gb_w):
        """(loss, logits, statistics before): ``pre_fn``, the gradients
        cleared, the forward in training mode and the loss."""
        gen_pre, gen_drop, gen_noise = gens
        with data_parallel(self.mesh):
            if self.pre_fn is not None:
                batch = self.pre_fn(gen_pre, batch)
            for p in state.params:
                p.grad = None
            stats_before = state.snapshot_stats()
            out = _model_outputs(state.model, batch, self.model_type, train=True,
                                 generator=gen_drop, noise_generator=gen_noise)
            loss, logits = _loss_and_logits(out, labels, self.loss_cfg, self.model_type,
                                            weight, m_list, gb_w)
        return loss, logits, stats_before

    def _eager(self, state: TrainState, inputs):
        n = state.draws
        with span("train.step", step=n, graphed=0):
            with span("train.forward", step=n):
                gens = state.next_generators()
                loss, logits, stats_before = self._forward(state, gens, *inputs)
            with span("train.backward", step=n), data_parallel(self.mesh):
                loss.backward()
            with span("train.update", step=n):
                loss = guarded_update(state, loss.detach(), stats_before, self.mesh)
        return loss, logits.detach().argmax(-1)

    def _key(self, state: TrainState, inputs) -> tuple:
        return (_signature(inputs), storage_key(state.model),
                tuple(v.data_ptr() for v in state.opt_state.values()), state.step.data_ptr(),
                self.pre_fn, self.model_type, self.loss_cfg, _thread_token())

    def _capture(self, state: TrainState, key: tuple, inputs) -> _StepGraph:
        """The whole step captured over static inputs, on the capture
        stream into the pool of the thread's graphs, with three generators
        registered with the graph."""
        sig = (key[0], key[-1])                 # the thread's graphs of the signature
        static = self._static.get(sig)
        if static is None:
            static = self._static[sig] = _static_like(inputs)
        gens = tuple(torch.Generator(device=state.device) for _ in range(3))
        graph = torch.cuda.CUDAGraph()
        for gen in gens:
            graph.register_generator_state(gen)
        with capture(graph, state.device, pool=_shared_pool(state.device)):
            loss, logits, stats_before = self._forward(state, gens, *static)
            loss.backward()
            loss = guarded_update(state, loss.detach(), stats_before, None)
            preds = logits.detach().argmax(-1)
        self.graph_captures += 1
        step_graph = _StepGraph(key, graph, static, gens, loss, preds)
        _THREAD.newest[torch.device(state.device)] = weakref.ref(step_graph)
        return step_graph

    def __call__(self, state: TrainState, batch, labels, weight, m_list, gb_w=None):
        inputs = (batch, labels, weight, m_list, gb_w)
        if self.mesh is not None or state.device.type != "cuda":
            loss, preds = self._eager(state, inputs)
            return state, loss, preds
        key = self._key(state, inputs)
        held = self._held.setdefault(state, [None, None])
        graph = held[1]
        if graph is None or graph.key != key:
            if held[0] != key:
                # the key's first step: eagerly, on the capture stream
                held[0] = key
                with on_capture_stream(state.device):
                    loss, preds = self._eager(state, inputs)
                main = torch.cuda.current_stream(state.device)
                loss.record_stream(main)
                preds.record_stream(main)
                return state, loss, preds
            held[1] = None                  # the old graph gives its memory back first
            graph = held[1] = self._capture(state, key, inputs)
        n = state.draws
        with span("train.step", step=n, graphed=1):
            with span("train.inputs", step=n):
                for buf, t in zip(_tensors(graph.inputs), _tensors(inputs)):
                    if buf is not None:
                        buf.copy_(t)
                state.seed_generators(graph.gens)
            with span("train.replay", step=n):
                graph.graph.replay()
        self.graphed_steps += 1
        return state, graph.loss.clone(), graph.preds.clone()


def make_train_step(loss_cfg: LossConfig, pre_fn: Optional[Callable] = None,
                    model_type: str = "single", mesh=None) -> Callable:
    """step(state, batch, labels, weight, m_list, gb_w=None)
    -> (state, loss, preds).

    One optimizer step of ``state.model`` on a device batch: ``pre_fn(gen,
    batch)`` (optional), the forward in training mode with dropout (and,
    for the 0D models and encoders, the input noise) drawn from the step's
    generators, the loss (``model_type``), backward, and the guarded
    update. ``loss`` and ``preds`` stay on the device. On a ``mesh`` the
    batch is this rank's rows, ``loss`` the global batch's and ``preds``
    this rank's rows'. On one CUDA device the step is replayed from a
    captured CUDA graph (``_TrainStep``). Spans (``utils/profiling.py``):
    ``train.step`` with ``step``, the step's ``state.draws``, and
    ``graphed`` (1 on a replay, 0 when eager); eagerly it encloses
    ``train.forward`` (generators to the loss), ``train.backward`` and
    ``train.update``, on a replay ``train.inputs`` (the copies and the
    reseeding) and ``train.replay``, each with ``step``."""
    return _TrainStep(loss_cfg, pre_fn, model_type, mesh)


def make_scan_steps(loss_cfg: LossConfig, pre_fn: Optional[Callable] = None,
                    model_type: str = "single", mesh=None) -> Callable:
    """K steps per call over a (K, B, ...) stack of device batches:

    multi_step(state, batches, labels, weight, m_list, gb_w=None)
        -> (state, losses (K,), preds (K, B))

    The same step function and the same per-step generators as K calls of
    ``make_train_step``'s step, so the trajectory is the same (JAX's
    ``lax.scan`` version amortizes a per-dispatch link latency; here it
    takes one stacked upload per K batches)."""
    step = make_train_step(loss_cfg, pre_fn, model_type, mesh)

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
                   model_type: str = "single", mesh=None) -> Callable:
    """eval_step(model, batch, labels, weight, m_list, mask, gb_w=None)
    -> (loss, probs, preds); probs = softmax(logits) in f32 (the multi
    logits for ``"multi-GB"``), the loss counts only the samples where
    ``mask`` is 1. On a ``mesh`` the batch and mask are this rank's rows;
    the loss is the global batch's, and probs and preds are all-gathered in
    rank order, the global batch's order."""
    _check_model_type(model_type)

    @torch.no_grad()
    def step(model, batch, labels, weight, m_list, mask, gb_w=None):
        with data_parallel(mesh):
            if pre_fn is not None:
                batch = pre_fn(None, batch)
            out = _model_outputs(model, batch, model_type, train=False)
            loss, logits = _loss_and_logits(out, labels, loss_cfg, model_type, weight,
                                            m_list, gb_w, mask)
        probs, preds = torch.softmax(logits.float(), dim=-1), logits.argmax(-1)
        if mesh is not None:
            d = mesh.shape["data"]
            loss = all_reduce_(loss.clone(), mesh.data_group)
            probs = all_gather_cat(probs, mesh.data_group, d)
            preds = all_gather_cat(preds, mesh.data_group, d)
        return loss, probs, preds

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


def default_puts(device, mesh=None, put=None):
    """(put, put_stack) of host (batch, labels) pairs and (K, B, ...)
    stacks. Without a ``mesh`` both are the caller's ``put`` (default: a
    plain upload to ``device``). On a mesh, pairs go through ``put``
    (default: this rank's rows, ``parallel/mesh.py put_batch``) and stacks
    through this rank's rows of axis 1 (``put_stack``)."""
    if mesh is None:
        put = put or (lambda item: to_device(item, device))
        return put, put
    from ..parallel.mesh import put_batch, put_stack

    return (put or (lambda item: (put_batch(mesh, item[0]), put_batch(mesh, item[1]))),
            lambda item: (put_stack(mesh, item[0]), put_stack(mesh, item[1])))


def run_train_epoch(train_step, state: TrainState, dataset, batch_size, rng,
                    weight, m_list, sampler=None, put=None, prefetch=True,
                    scan_step=None, steps_per_dispatch: int = 1, gb_w=None,
                    mesh=None):
    """One training epoch, pipelined: batches are gathered (and put on the
    device) by a producer thread ahead of consumption, and the per-step
    losses/preds stay on the device until the epoch ends (one host sync).

    scan_step + steps_per_dispatch > 1: full groups of K batches run through
    the K-step call (make_scan_steps; stacks through ``put``, or on a mesh
    this rank's rows of axis 1, ``default_puts``); the
    remainder through ``train_step``. ``gb_w``: the (3,) Gradient-Blending
    weights of a ``"multi-GB"`` step. On a ``mesh`` (steps built with it)
    the predictions and labels are all-gathered once at the end, so the
    metrics are the global batch's on every rank.
    Returns (state, mean loss, accuracy, macro-F1)."""
    put, put_stack = default_puts(state.device, mesh, put)
    n_samples = 0
    dev_losses, dev_preds, dev_labels = [], [], []
    idx_iter = epoch_batches(len(dataset), batch_size, rng, sampler=sampler)

    if scan_step is not None and steps_per_dispatch > 1:
        for kind, (batch, labels) in grouped_batches(dataset, idx_iter,
                                                     steps_per_dispatch, put,
                                                     put_stack=put_stack):
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
    preds, labels = torch.cat(dev_preds), torch.cat(dev_labels)
    if mesh is not None:
        d = mesh.shape["data"]
        preds = all_gather_cat(preds, mesh.data_group, d)
        labels = all_gather_cat(labels, mesh.data_group, d)
        n_samples = labels.numel()
    preds, labels = preds.cpu().numpy(), labels.cpu().numpy()
    return state, losses / n_samples, accuracy(labels, preds), macro_f1(labels, preds)


def run_eval_epoch(eval_step, model, dataset, batch_size, weight, m_list,
                   put=None, collect_probs: bool = False, gb_w=None, mesh=None):
    """One pass over ``dataset`` in fixed-size batches (the tail padded and
    masked out). Returns (mean loss, accuracy, macro-F1) and, with
    ``collect_probs``, ((N, 2) probabilities, (N,) labels). ``gb_w``: the
    Gradient-Blending weights of a ``"multi-GB"`` eval step. On a ``mesh``
    (an eval step built with it) each rank puts its rows of the batch and
    of the mask, and the step's gathered results cover the population."""
    device = next(model.parameters()).device
    put = put or default_puts(device, mesh)[0]
    if mesh is None:
        put_mask = lambda m: to_device(m, device)
    else:
        from ..parallel.mesh import put_batch
        put_mask = lambda m: put_batch(mesh, m)
    n_samples = 0
    dev_losses, dev_preds, dev_probs, dev_labels, all_masks = [], [], [], [], []
    for idx, mask in eval_batches(len(dataset), batch_size):
        item = dataset.batch(idx)
        batch, labels = put(item)
        loss, probs, preds = eval_step(model, batch, labels, weight, m_list,
                                       put_mask(mask.astype(np.float32)), gb_w)
        dev_losses.append(loss)
        dev_preds.append(preds)
        if collect_probs:
            dev_probs.append(probs)
        # on a mesh the step's outputs are the global batch's: so are the
        # host labels
        dev_labels.append(labels if mesh is None else torch.as_tensor(item[1]))
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
    mesh=None,
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
    src/models/resnet.py:52-61).

    ``mesh``: data-parallel over its data group (``put``/``put_eval``
    default to this rank's rows, and multi-step stacks always go up as this
    rank's rows of axis 1). Every rank runs the same
    epochs on the same global batches and sees the same metrics; rank 0
    alone writes the checkpoints, the writer's logs and the printed lines,
    and the others wait at a barrier after each save (a mesh with a model
    axis writes ``save_checkpoint_sharded`` directories instead, every rank
    its shards)."""
    num_epoch = num_epoch or train_cfg.num_epoch
    train_step = make_train_step(loss_cfg, pre_fn=pre_fn, model_type=model_type, mesh=mesh)
    eval_step = make_eval_step(loss_cfg, pre_fn=pre_fn_eval, model_type=model_type,
                               mesh=mesh)
    k = train_cfg.steps_per_dispatch
    scan_step = (make_scan_steps(loss_cfg, pre_fn=pre_fn, model_type=model_type, mesh=mesh)
                 if k > 1 else None)
    main = mesh is None or mesh.is_main
    if not main:
        writer = None

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
            scan_step=scan_step, steps_per_dispatch=k, gb_w=gb_w,
            mesh=mesh)
        if eval_stats_fn is not None:
            with torch.no_grad():
                eval_stats_fn(state.model)
        # the valid probabilities feed the evaluation figure of a new best
        va_loss, va_acc, va_f1, *va_probs = run_eval_epoch(
            eval_step, state.model, valid_ds, train_cfg.batch_size, weight, m_list,
            put=put_eval if put_eval is not None else put, gb_w=gb_w,
            collect_probs=writer is not None, mesh=mesh)
        ep_s = time.perf_counter() - t_ep

        hist.train_loss.append(tr_loss); hist.valid_loss.append(va_loss)
        hist.train_acc.append(tr_acc); hist.valid_acc.append(va_acc)
        hist.train_f1.append(tr_f1); hist.valid_f1.append(va_f1)
        hist.epoch_s.append(ep_s)

        if writer:
            writer.scalars({"Loss/train": tr_loss, "Loss/valid": va_loss,
                            "F1/train": tr_f1, "F1/valid": va_f1,
                            "time/epoch_s": ep_s}, epoch)
        if main and train_cfg.verbose and epoch % train_cfg.verbose == 0:
            print(f"epoch {epoch+1:3d} | train loss {tr_loss:.4f} f1 {tr_f1:.4f} "
                  f"| valid loss {va_loss:.4f} f1 {va_f1:.4f} | {ep_s:.1f}s")

        save_on_mesh(state, last_path, mesh)
        improved = stopper(va_f1) if stopper else va_f1 > hist.best_f1
        if improved:
            hist.best_f1 = va_f1
            hist.best_epoch = epoch
            save_on_mesh(state, best_path, mesh, extra={"epoch": epoch, "valid_f1": va_f1})
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
            if main:
                print(f"early stopping at epoch {epoch+1}")
            break

    return state, hist


def save_on_mesh(state: TrainState, path: str, mesh=None, extra=None) -> None:
    """``save_checkpoint`` by rank 0 while the other ranks wait at a barrier
    (the reference's rank-0 saves); on a mesh with a model axis, a
    ``save_checkpoint_sharded`` directory that every rank writes into."""
    if mesh is not None and mesh.shape["model"] > 1:
        save_checkpoint_sharded(state, path, mesh)
        return
    if mesh is None or mesh.is_main:
        save_checkpoint(state, path, extra=extra)
    if mesh is not None:
        barrier()
