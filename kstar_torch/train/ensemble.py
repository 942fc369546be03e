"""Multi-seed ensemble training: N members, one shared batch per step.

Port of ``kstar_tpu/train/ensemble.py``. The reference's experiment sweeps
train the same configuration once per seed, serially (reference
exp/exp_0D_mlstm.sh, exp/exp_r2plus1d.sh: seeds 40-43 as four separate
processes). Here the seeds train together in one process: every step
gathers and uploads one batch, and each member takes its own guarded step
on it.

Semantics (as JAX's): member i takes exactly the step sequence of a solo
run with seed i (its model initialised from ``torch.Generator().
manual_seed(s)``, its dropout, input-noise and augmentation draws from its
own ``(seed, draws, stream)`` generators, ``TrainState.next_generators``);
the batches are shared across members, which relative to the reference's
per-seed processes is an rng difference, not a semantic one.
``tests/test_torch_ensemble.py`` holds members against solo runs bit for
bit.

The mechanism is a loop over members, not JAX's ``vmap`` over stacked
states. ``torch.func.vmap`` over ``functional_call`` fits the port's step
badly: dropout and input noise draw from explicit per-member generators
(train/loop.py, state.py ``next_generators``), which vmap's ``randomness``
modes cannot take (they draw from the global stream); the flax-exact
BatchNorm writes its running statistics in place; and the 0D models run
cuDNN's ``torch.lstm``. So an ensemble is a list of ``TrainState``s sharing
one ``Optimizer``, and an ensemble step costs about N solo steps on the
device (the batch's gather and upload are paid once). Batching the members
into one launch chain is speed work for later (ROADMAP.md Queue 2).

On a mesh (``create_ensemble_state(mesh=)``, JAX's ensemble axis sharded
over the data devices) each data rank holds its own block of the members,
``local_seeds``, and trains them on the full batches with no collectives:
every rank draws the same batches, as every member does on one device.
"""

from __future__ import annotations

import operator
import os
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import LossConfig, OptimConfig, TrainConfig
from ..data.loader import (epoch_batches, eval_batches, grouped_batches,
                           threaded_batches, to_device)
from .loop import History, _loss_aux, make_eval_step, make_scan_steps, make_train_step
from .metrics import accuracy, macro_f1
from .state import TrainState, make_optimizer, save_checkpoint


def local_seeds(seeds: Sequence[int], mesh=None) -> List[int]:
    """The seeds whose members this rank holds: all of them without a mesh,
    else the data rank's contiguous block (the data axis must divide the
    member count, as JAX's ensemble-axis sharding requires)."""
    if mesh is None:
        return list(seeds)
    d = mesh.shape["data"]
    if len(seeds) % d:
        raise ValueError(f"{len(seeds)} ensemble members do not split over the "
                         f"mesh's data axis ({d})")
    k = len(seeds) // d
    return list(seeds[mesh.data_index * k:(mesh.data_index + 1) * k])


def create_ensemble_state(make_model: Callable[[torch.Generator], torch.nn.Module],
                          seeds: Sequence[int], optim_cfg: OptimConfig,
                          steps_per_epoch: int = 1, device=None,
                          mesh=None) -> List[TrainState]:
    """One ``TrainState`` per seed: ``make_model(generator)`` builds the
    model from ``torch.Generator().manual_seed(s)`` (as the train CLIs
    initialise theirs), it moves to ``device`` (``None``: the GPU; on a
    mesh, the mesh's device), and the state takes seed ``s`` for its step
    streams. The members share one ``Optimizer``. ``mesh``: only this
    rank's members, ``local_seeds(seeds, mesh)``."""
    device = mesh.device if mesh is not None else resolve_device(device)
    tx = make_optimizer(optim_cfg, steps_per_epoch)
    return [TrainState(make_model(torch.Generator().manual_seed(int(s))).to(device), tx,
                       seed=int(s)) for s in local_seeds(seeds, mesh)]


# JAX's name for member i of the ensemble (shared, not copied: training it
# trains the member)
unstack_ensemble = operator.getitem


def members_from_flax(states: Sequence[TrainState], params: Mapping,
                      batch_stats: Optional[Mapping] = None) -> None:
    """Load a JAX ensemble's stacked parameters and batch statistics (numpy
    trees whose leaves carry a leading member axis, as
    ``kstar_tpu.train.create_ensemble_state`` stacks them) into the members,
    in place, through ``weights.state_dict_from_flax``."""
    from ..weights import state_dict_from_flax

    def member(tree, i):
        if isinstance(tree, Mapping):
            return {k: member(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i, st in enumerate(states):
        stats = member(batch_stats, i) if batch_stats else None
        st.model.load_state_dict(state_dict_from_flax(member(params, i), stats),
                                 strict=True)


def make_ensemble_step(loss_cfg: LossConfig, pre_fn=None, model_type: str = "single"):
    """step(states, batch, labels, weight, m_list, gb_w=None)
    -> (states, losses (N,), preds (N, B)): each member takes
    ``make_train_step``'s step on the shared device batch."""
    one = make_train_step(loss_cfg, pre_fn, model_type)

    def step(states, batch, labels, weight, m_list, gb_w=None):
        out = [one(st, batch, labels, weight, m_list, gb_w) for st in states]
        return (states, torch.stack([loss for _, loss, _ in out]),
                torch.stack([pred for _, _, pred in out]))

    return step


def make_ensemble_scan_steps(loss_cfg: LossConfig, pre_fn=None,
                             model_type: str = "single"):
    """K steps x N members per call over a (K, B, ...) stack of device
    batches (``make_scan_steps`` per member):

    multi_step(states, batches, labels, weight, m_list, gb_w=None)
        -> (states, losses (N, K), preds (N, K, B))

    The same trajectory as K calls of ``make_ensemble_step``'s step."""
    one = make_scan_steps(loss_cfg, pre_fn, model_type)

    def multi_step(states, batches, labels, weight, m_list, gb_w=None):
        out = [one(st, batches, labels, weight, m_list, gb_w) for st in states]
        return (states, torch.stack([loss for _, loss, _ in out]),
                torch.stack([pred for _, _, pred in out]))

    return multi_step


def make_ensemble_eval(loss_cfg: LossConfig, pre_fn=None, model_type: str = "single"):
    """eval(states, batch, labels, weight, m_list, mask, gb_w=None)
    -> (losses (N,), probs (N, B, C), preds (N, B))."""
    one = make_eval_step(loss_cfg, pre_fn, model_type)

    def step(states, batch, labels, weight, m_list, mask, gb_w=None):
        out = [one(st.model, batch, labels, weight, m_list, mask, gb_w) for st in states]
        return tuple(torch.stack([o[j] for o in out]) for j in range(3))

    return step


def fit_ensemble(
    states: Sequence[TrainState],
    seeds: Sequence[int],
    train_ds,
    valid_ds,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    model_type: str = "single",
    tag: str = "model",
    sampler=None,
    put=None,
    pre_fn=None,
    pre_fn_eval=None,
    writes: bool = True,
) -> Tuple[List[TrainState], List[History]]:
    """Train all members together; per-member ``History`` and per-member
    ``{tag}_seed_{s}_{best,last}.ckpt`` checkpoints (the tag scheme of the
    reference's per-seed sweep processes). ``put`` moves a host (batch,
    labels) pair to the device (default: to the members' device), once per
    step for all members.

    ``train_cfg.steps_per_dispatch`` > 1 runs full groups of K batches
    through ``make_ensemble_scan_steps`` (one stacked upload per K batches).

    Scope (as JAX's): no early stopping (members would stop at different
    epochs; run the full budget and use each member's best checkpoint) and
    no metric writer (the histories return to the caller). ``writes=False``
    writes no checkpoint (a replica of the ensemble on a rank other than 0
    of a data-parallel run)."""
    n = len(seeds)
    device = states[0].device
    if put is None:
        put = lambda item: to_device(item, device)
    train_step = make_ensemble_step(loss_cfg, pre_fn, model_type)
    eval_step = make_ensemble_eval(loss_cfg, pre_fn_eval, model_type)
    k = train_cfg.steps_per_dispatch
    scan_step = make_ensemble_scan_steps(loss_cfg, pre_fn, model_type) if k > 1 else None

    cls_counts = train_ds.class_counts()
    gb_w = torch.zeros(3, device=device)
    rng = np.random.default_rng(train_cfg.seed)
    hists = [History() for _ in range(n)]
    best_f1 = [-1.0] * n
    os.makedirs(train_cfg.weight_dir, exist_ok=True)

    for epoch in range(train_cfg.num_epoch):
        weight, m_list = _loss_aux(loss_cfg, cls_counts, epoch, train_cfg.num_epoch, device)

        # train: shared batches, per-step losses and predictions kept on the
        # device until the epoch ends
        dev_losses, dev_preds, dev_labels = [], [], []
        idx_iter = epoch_batches(len(train_ds), train_cfg.batch_size, rng, sampler=sampler)
        if scan_step is not None:
            for kind, (batch, labels) in grouped_batches(train_ds, idx_iter, k, put):
                fn = scan_step if kind == "stack" else train_step
                states, losses, preds = fn(states, batch, labels, weight, m_list, gb_w)
                dev_losses.append(losses.reshape(n, -1).sum(1))          # (N,)
                dev_preds.append(preds.reshape(n, -1))                   # (N, K*B)
                dev_labels.append(labels.reshape(-1))
        else:
            for batch, labels in threaded_batches(train_ds, idx_iter, put):
                states, losses, preds = train_step(states, batch, labels, weight,
                                                   m_list, gb_w)
                dev_losses.append(losses)
                dev_preds.append(preds)
                dev_labels.append(labels)
        tr_loss = torch.stack(dev_losses).sum(0).cpu().numpy()          # (N,)
        preds_all = torch.cat(dev_preds, dim=1).cpu().numpy()
        labels_all = torch.cat(dev_labels).cpu().numpy()
        n_samples = max(len(labels_all), 1)

        # valid
        v_losses, v_preds, v_labels, v_masks = [], [], [], []
        for idx, mask in eval_batches(len(valid_ds), train_cfg.batch_size):
            batch, labels = put(valid_ds.batch(idx))
            losses, _, preds = eval_step(states, batch, labels, weight, m_list,
                                         to_device(mask.astype(np.float32), device), gb_w)
            v_losses.append(losses)
            v_preds.append(preds)
            v_labels.append(labels)
            v_masks.append(mask)
        va_loss = torch.stack(v_losses).sum(0).cpu().numpy()
        mask_all = np.concatenate(v_masks)
        v_preds_all = torch.cat(v_preds, dim=1).cpu().numpy()[:, mask_all]
        v_labels_all = torch.cat(v_labels).cpu().numpy()[mask_all]
        nv = max(int(mask_all.sum()), 1)

        for i, s in enumerate(seeds):
            va_f1 = macro_f1(v_labels_all, v_preds_all[i])
            h = hists[i]
            h.train_loss.append(float(tr_loss[i]) / n_samples)
            h.valid_loss.append(float(va_loss[i]) / nv)
            h.train_f1.append(macro_f1(labels_all, preds_all[i]))
            h.valid_f1.append(va_f1)
            h.train_acc.append(accuracy(labels_all, preds_all[i]))
            h.valid_acc.append(accuracy(v_labels_all, v_preds_all[i]))
            if writes:
                save_checkpoint(states[i], os.path.join(train_cfg.weight_dir,
                                                        f"{tag}_seed_{s}_last.ckpt"))
            if va_f1 > best_f1[i]:
                best_f1[i] = h.best_f1 = va_f1
                h.best_epoch = epoch
                if writes:
                    save_checkpoint(states[i], os.path.join(
                        train_cfg.weight_dir, f"{tag}_seed_{s}_best.ckpt"),
                        extra={"epoch": epoch, "valid_f1": va_f1, "seed": int(s)})

        if writes and train_cfg.verbose and epoch % train_cfg.verbose == 0:
            f1s = " ".join(f"{hists[i].valid_f1[-1]:.3f}" for i in range(n))
            print(f"epoch {epoch+1:3d} | ensemble valid f1 [{f1s}]")

    return list(states), hists
