"""Train state, the optax-exact optimizers, and checkpoints.

Port of ``kstar_tpu/train/state.py``. ``TrainState`` holds the model, the
optimizer and its state, the applied-update count ``step`` (a device
tensor) and what the per-step random streams are made from (``seed`` and
the count of steps taken, ``draws``). The model's parameters are rebound as
views of one flat f32 buffer, so the optimizer and the NaN guard work on a
few whole-buffer tensors instead of one small tensor per parameter.

``make_optimizer`` reproduces ``optax`` (``kstar_tpu/train/state.py:42-67``),
not ``torch.optim``'s defaults: ``optax.chain(clip_by_global_norm(max_norm),
tx)`` with ``tx`` one of

  * ``sgd(lr, momentum=0.9)``: trace = g + 0.9 trace, update = trace;
  * ``adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction by the incremented count;
  * ``adamw(lr)``: adam plus ``1e-4 * param`` added to the update before
    the learning rate (torch's AdamW defaults to 0.01 and decays first);
  * ``rmsprop(lr)``: nu = 0.1 g^2 + 0.9 nu, update = g * rsqrt(nu + 1e-8)
    (eps inside the root; torch's RMSprop uses alpha 0.99, eps outside);

clipping scales by ``max_norm / |g|`` only when ``|g| >= max_norm`` (no
1e-6 as in ``clip_grad_norm_``), and the learning rate is
``exponential_decay(lr, step_size * steps_per_epoch, gamma,
staircase=True)`` of the count of APPLIED updates: a step the NaN guard
skips does not advance it. Everything stays on the device.

The model's batch statistics (its persistent floating-point buffers: the
BatchNorm running mean and variance, a SubBatchNorm's split statistics too)
are rebound the same way into a second flat buffer, so the NaN guard keeps
them too with one select; whatever updates them writes in place.

A checkpoint is the full state (parameters, batch statistics, optimizer
state, step, seed, draws) written with ``torch.save``: ``--resume``
continues exactly. ``load_checkpoint`` and ``load_params`` also read the
JAX package's flax checkpoints (``flax_ckpt.py``, through the bridge in
``kstar_torch/weights.py``): parameters, batch statistics, the optax
moments and ``count``, and ``step``. JAX's ``rng`` is not carried: the
resumed run draws from (its own seed, steps taken) as any port run does.
``save_checkpoint_sharded`` writes every rank's part of a data- or
tensor-parallel run (a tensor-parallel rank's flat buffer holds
its shards, ``shard_mask``; the global-norm clip then sums the shards'
squares over the model group, ``grad_norm``).
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import OptimConfig
from .flax_ckpt import is_flax_checkpoint, read_flax_checkpoint

OPTIMIZERS = ("sgd", "adam", "adamw", "rmsprop")
# the optax defaults that kstar_tpu/train/state.py:56-63 leaves in place
MOMENTUM = 0.9                  # sgd(momentum=0.9)
B1, B2, EPS = 0.9, 0.999, 1e-8  # adam, adamw; rmsprop's eps is EPS too
WEIGHT_DECAY = 1e-4             # adamw
RMS_DECAY = 0.9                 # rmsprop


@dataclass(frozen=True)
class Optimizer:
    """One ``optax.chain(clip_by_global_norm, tx)``, written out for flat
    f32 tensors. ``init`` and ``update`` are pure, as optax's are."""
    name: str                      # one of OPTIMIZERS
    lr: float
    transition_steps: Optional[int] = None   # staircase decay; None = constant
    decay_rate: float = 1.0
    max_norm: Optional[float] = None

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """``exponential_decay(..., staircase=True)`` at ``count`` applied
        updates, f32 (a constant rate when there is no schedule)."""
        if self.transition_steps is None:
            return torch.full((), self.lr, dtype=torch.float32, device=count.device)
        p = torch.floor(count.float() / self.transition_steps)
        return self.lr * torch.pow(self.decay_rate, p)

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = {"count": torch.zeros((), dtype=torch.int32, device=params.device)}
        if self.name == "sgd":
            state["trace"] = torch.zeros_like(params)
        elif self.name in ("adam", "adamw"):
            state["mu"] = torch.zeros_like(params)
            state["nu"] = torch.zeros_like(params)
        else:
            state["nu"] = torch.zeros_like(params)
        return state

    def update(self, grads: torch.Tensor, state: Dict[str, torch.Tensor],
               params: torch.Tensor, norm: Optional[torch.Tensor] = None):
        """(updates, new state) for flat f32 gradients and parameters; the
        new parameters are ``params + updates`` (``optax.apply_updates``).
        ``norm``: the global gradient norm where ``grads`` holds only part of
        the gradient (a tensor-parallel shard); default ``|grads|``."""
        g = grads
        if self.max_norm is not None:
            if norm is None:
                norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
        count = state["count"]
        count_inc = count + 1
        new = {"count": count_inc}
        if self.name == "sgd":
            new["trace"] = u = g + MOMENTUM * state["trace"]
        elif self.name in ("adam", "adamw"):
            new["mu"] = mu = (1 - B1) * g + B1 * state["mu"]
            new["nu"] = nu = (1 - B2) * (g ** 2) + B2 * state["nu"]
            n = count_inc.float()
            mu_hat = mu / (1 - torch.pow(B1, n))
            nu_hat = nu / (1 - torch.pow(B2, n))
            u = mu_hat / (torch.sqrt(nu_hat) + EPS)
            if self.name == "adamw":
                u = u + WEIGHT_DECAY * params
        else:
            new["nu"] = nu = (1 - RMS_DECAY) * (g ** 2) + RMS_DECAY * state["nu"]
            u = torch.rsqrt(nu + EPS) * g
        return -self.learning_rate(count) * u, new


def make_optimizer(cfg: OptimConfig, steps_per_epoch: int = 1) -> Optimizer:
    """Optimizer dispatch + StepLR-style staircase decay + global-norm clip
    (reference train_vision_network.py:271-290; clip src/train.py:63-64)."""
    name = cfg.optimizer.lower()
    name = {"rmsprops": "rmsprop"}.get(name, name)
    if name not in OPTIMIZERS:
        name = "adamw"               # the JAX dispatch's fallback
    return Optimizer(
        name=name, lr=cfg.lr,
        transition_steps=cfg.step_size * steps_per_epoch if cfg.use_scheduler else None,
        decay_rate=cfg.gamma, max_norm=cfg.max_norm_grad)


def _flatten_parameters(params, what: str = "parameters") -> torch.Tensor:
    """Copy the tensors into one flat buffer and rebind each as a view of it
    (so a whole-buffer update updates the model)."""
    dev = {p.device for p in params}
    if len(dev) != 1 or any(p.dtype != torch.float32 for p in params):
        raise ValueError(f"TrainState: {what} must be f32 on one device, got "
                         f"{sorted({str(p.dtype) for p in params})} on {dev}")
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        p.data = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


class TrainState:
    """Model + optimizer + step + the seed of the step streams.

    ``step`` counts APPLIED updates on the device (the NaN guard can skip
    one without the host knowing); ``draws`` counts steps TAKEN on the host
    and seeds each step's generators, so the K-step path, the one-step path
    and a resumed run draw the same. JAX folds the applied step into its key
    instead, so a skipped step there repeats its draws; here it does not,
    since knowing it was skipped would cost a host sync per step."""

    def __init__(self, model: nn.Module, tx: Optimizer, seed: int = 0):
        self.model = model
        self.tx = tx
        self.seed = int(seed)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.flat = _flatten_parameters(self.params)
        self.device = self.flat.device
        self._find_shards()
        # batch statistics: the persistent floating-point buffers
        self._flatten_stats()
        self.opt_state = tx.init(self.flat)
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)
        self.draws = 0

    def _find_shards(self) -> None:
        """``shard_mask``: the entries of ``flat`` that hold a tensor-parallel
        shard (``parallel/tp.py``), and ``shard_group``, their model group;
        both None for a model with no split layer."""
        self.shard_mask = self.shard_group = None
        split = {}
        for module in self.model.modules():
            tp = getattr(module, "tp", None)
            if tp is not None:
                split.update({id(getattr(module, n)): tp.group for n in tp.names})
        if not split:
            return
        self.shard_mask = torch.cat([
            torch.full((p.numel(),), id(p) in split, dtype=torch.bool, device=self.device)
            for p in self.params])
        self.shard_group = next(iter(split.values()))

    def grad_norm(self, grads: torch.Tensor) -> Optional[torch.Tensor]:
        """The global norm of a flat gradient whose shards are split over the
        model group (None without shards: the optimizer takes |grads|)."""
        if self.shard_mask is None:
            return None
        from ..parallel.comm import all_reduce_

        sq = torch.where(self.shard_mask, grads, 0.0).square().sum()
        return torch.sqrt(all_reduce_(sq, self.shard_group)
                          + torch.where(self.shard_mask, 0.0, grads).square().sum())

    def _flatten_stats(self) -> None:
        saved = set(self.model.state_dict())
        self.stats = [b for name, b in self.model.named_buffers()
                      if name in saved and b.is_floating_point()]
        self.stats_flat = (_flatten_parameters(self.stats, "batch statistics")
                           if self.stats else None)

    def reset_bn_splits(self, new_splits: int) -> None:
        """The multigrid long-cycle step on the state's model
        (``models.reset_bn_splits_long_cycle``): fresh SubBatchNorm split
        statistics at ``new_splits``. Their buffers change shape, so the
        statistics are flattened anew; the parameters and the optimizer
        state stay as they are."""
        from ..models.subbn import reset_bn_splits_long_cycle

        reset_bn_splits_long_cycle(self.model, new_splits)
        self._flatten_stats()

    def next_generators(self):
        """(pre, dropout, noise) generators on the device for the next step,
        each seeded from (seed, draws, its stream index) alone, so one
        stream's draws do not depend on the others; advances ``draws``."""
        return self.seed_generators(tuple(torch.Generator(device=self.device)
                                          for _ in range(3)))

    def seed_generators(self, gens):
        """Seed the three (pre, dropout, noise) generators ``gens`` for the
        next step as ``next_generators`` seeds its new ones (a captured step
        keeps its generators and reseeds them before each replay); advances
        ``draws``. Returns ``gens``."""
        for stream, gen in enumerate(gens):
            s = np.random.SeedSequence([self.seed, self.draws, stream]).generate_state(
                1, np.uint64)[0]
            gen.manual_seed(int(s))
        self.draws += 1
        return gens

    def copy(self) -> "TrainState":
        """An independent copy (model, flat buffers, batch statistics,
        optimizer state, ``step``, ``seed`` and ``draws``): training the copy
        leaves this state as it was, as a JAX state's functional copy does
        (the Gradient-Blending probes, ``train/gb.py gb_estimate``)."""
        twin = TrainState(copy.deepcopy(self.model), self.tx, self.seed)
        twin.opt_state = {k: v.clone() for k, v in self.opt_state.items()}
        twin.step = self.step.clone()
        twin.draws = self.draws
        return twin

    def flat_ranges(self, submodule: str) -> List[Tuple[int, int]]:
        """The (start, stop) ranges of ``flat`` that hold the parameters of
        the top-level submodule ``submodule`` (e.g. a fusion model's
        ``vis_model`` or ``ts_model``), adjacent ranges merged."""
        ranges, offset = [], 0
        trainable = {id(p) for p in self.params}
        for name, p in self.model.named_parameters():
            if id(p) not in trainable:
                continue
            if name.split(".", 1)[0] == submodule:
                if ranges and ranges[-1][1] == offset:
                    ranges[-1] = (ranges[-1][0], offset + p.numel())
                else:
                    ranges.append((offset, offset + p.numel()))
            offset += p.numel()
        if not ranges:
            raise ValueError(f"TrainState: the model has no parameters under {submodule!r}")
        return ranges

    def flat_grads(self) -> torch.Tensor:
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in self.params])

    def snapshot_stats(self) -> Optional[torch.Tensor]:
        """A copy of the batch statistics before a train forward moves them
        (None for a model without any), for ``apply_gradients``."""
        return None if self.stats_flat is None else self.stats_flat.clone()

    @torch.no_grad()
    def apply_gradients(self, finite: torch.Tensor,
                        stats_before: Optional[torch.Tensor],
                        grads: Optional[torch.Tensor] = None) -> None:
        """One optimizer update from the parameters' ``.grad`` (or the flat
        ``grads``, the data-parallel step's summed buffer), kept only where
        ``finite`` (a device bool): otherwise parameters, optimizer state,
        step and the batch statistics (back to ``stats_before``, the step's
        ``snapshot_stats``) stay bit-identical. Decided on the device, with
        no host sync (``guarded_update``, ``kstar_tpu/train/loop.py:91-104``).
        Every tensor of the state is written in place, so a captured step
        reads and writes the same storage at each replay."""
        if grads is None:
            grads = self.flat_grads()
        updates, new_opt = self.tx.update(grads, self.opt_state, self.flat,
                                          norm=self.grad_norm(grads))
        self.flat.copy_(torch.where(finite, self.flat + updates, self.flat))
        for k, v in new_opt.items():
            self.opt_state[k].copy_(torch.where(finite, v, self.opt_state[k]))
        self.step.copy_(torch.where(finite, self.step + 1, self.step))
        if stats_before is not None:
            self.stats_flat.copy_(torch.where(finite, self.stats_flat, stats_before))

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": self.opt_state, "seed": self.seed, "draws": self.draws}

    def load_state_dict(self, payload: dict) -> None:
        self.model.load_state_dict(payload["model"])      # copies into the views
                                                          # (parameters and statistics)
        self.opt_state = {k: v.to(self.device) for k, v in payload["opt_state"].items()}
        self.step = payload["step"].to(self.device)
        self.seed, self.draws = int(payload["seed"]), int(payload["draws"])


def create_train_state(model: nn.Module, optim_cfg: OptimConfig,
                       steps_per_epoch: int = 1, seed: int = 0) -> TrainState:
    """Wrap an initialised model (its ``generator=`` seeded the weights)
    with the optimizer and a zero step."""
    return TrainState(model, make_optimizer(optim_cfg, steps_per_epoch), seed)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def save_checkpoint(state: TrainState, path: str, extra: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state.state_dict(), path)
    if extra:
        with open(path + ".json", "w") as f:
            json.dump(extra, f, indent=2, default=str)


def _load_flax_model(model: nn.Module, tree: dict, path: str) -> None:
    """A flax checkpoint's ``params`` and ``batch_stats`` into ``model``;
    raises with the first missing or extra key, or the first shape that
    differs, before anything is copied."""
    from ..weights import state_dict_from_flax

    sd = state_dict_from_flax(tree["params"], tree.get("batch_stats") or None)
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    extra = [k for k in sd if k not in want]
    if missing or extra:
        raise ValueError(
            f"flax checkpoint {path} does not match the model: "
            + (f"first missing key {missing[0]!r}" if missing else f"first extra key {extra[0]!r}")
            + f" ({len(missing)} missing, {len(extra)} extra)")
    bad = next((k for k in want if tuple(sd[k].shape) != tuple(want[k].shape)), None)
    if bad is not None:
        raise ValueError(f"flax checkpoint {path}: {bad} has shape {tuple(sd[bad].shape)}, "
                         f"the model {tuple(want[bad].shape)}")
    model.load_state_dict(sd)         # copies into the views (parameters and statistics)


def load_checkpoint(state: TrainState, path: str) -> TrainState:
    """Restore into an existing (template) state, in place; returns it. A
    flax checkpoint (``is_flax_checkpoint``) restores parameters, batch
    statistics, the optimizer state and ``step``; ``draws`` becomes
    ``step`` and ``seed`` stays the template's."""
    if not is_flax_checkpoint(path):
        state.load_state_dict(torch.load(path, map_location=state.device))
        return state
    from ..weights import opt_state_from_flax

    tree = read_flax_checkpoint(path)
    step = int(tree["step"])
    opt_state = opt_state_from_flax(tree["opt_state"], state, step)   # checked first
    _load_flax_model(state.model, tree, path)
    state.opt_state = opt_state
    state.step = torch.tensor(step, dtype=torch.int64, device=state.device)
    state.draws = step
    return state


def load_params(model: nn.Module, path: str) -> nn.Module:
    """Restore only the model's parameters and statistics (for inference),
    from a port or a flax checkpoint; returns it."""
    if is_flax_checkpoint(path):
        _load_flax_model(model, read_flax_checkpoint(path), path)
        return model
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device)["model"])
    return model


def flax_checkpoint_tree(state: TrainState) -> dict:
    """The tree ``kstar_tpu/train/state.py save_checkpoint`` writes, made
    from a port state: ``step`` (int32), ``params``/``batch_stats`` and the
    optax chain state (``kstar_torch/weights.py``), and ``rng`` as the raw
    data of JAX's key for the state's seed. ``write_flax_checkpoint`` of it
    is a file the JAX package and ``load_checkpoint`` both read."""
    from ..weights import flax_from_state_dict, opt_state_to_flax

    params, stats = flax_from_state_dict(state.model)
    return {"batch_stats": stats, "opt_state": opt_state_to_flax(state), "params": params,
            "rng": torch.tensor([(state.seed >> 32) & 0xFFFFFFFF, state.seed & 0xFFFFFFFF],
                                dtype=torch.uint32),
            "step": state.step.detach().to("cpu", torch.int32).clone()}


# ---------------------------------------------------------------------------
# sharded checkpoints (the counterpart of JAX's orbax checkpoints)
# ---------------------------------------------------------------------------

SHARDED_META = "meta.json"


def _layout(mesh) -> dict:
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

    if mesh is None:
        return {"world": 1, "data": 1, "model": 1}
    return {"world": mesh.world, "data": mesh.shape[DATA_AXIS],
            "model": mesh.shape[MODEL_AXIS]}


def _rank_file(path: str, mesh) -> str:
    return os.path.join(path, f"rank_{0 if mesh is None else mesh.rank:05d}.pt")


def save_checkpoint_sharded(state, path: str, mesh=None) -> None:
    """Every rank writes what it holds into the directory ``path``: its
    ``TrainState`` (a tensor-parallel rank its shards) or its list of
    ensemble members, as ``rank_<r>.pt``; rank 0 adds ``meta.json`` with the
    mesh's layout. Returns when every rank has written (a barrier). The
    counterpart of ``kstar_tpu/train/state.py save_checkpoint_orbax``; no
    file format is shared with orbax."""
    from ..parallel.comm import barrier

    members = isinstance(state, (list, tuple))
    os.makedirs(path, exist_ok=True)
    payload = ([s.state_dict() for s in state] if members else state.state_dict())
    torch.save(payload, _rank_file(path, mesh))
    if mesh is None or mesh.is_main:
        meta = {**_layout(mesh), "members": len(state) if members else None}
        with open(os.path.join(path, SHARDED_META), "w") as f:
            json.dump(meta, f, indent=2)
    barrier()


def load_checkpoint_sharded(state, path: str, mesh=None):
    """Restore this rank's part of ``save_checkpoint_sharded``'s directory
    into a template of the same layout (the same mesh, the same split
    layers, the same member count), in place; returns it. A different
    layout raises."""
    with open(os.path.join(path, SHARDED_META)) as f:
        meta = json.load(f)
    members = isinstance(state, (list, tuple))
    want = {**_layout(mesh), "members": len(state) if members else None}
    if meta != want:
        raise ValueError(f"sharded checkpoint {path} has layout {meta}, the template {want}")
    device = (state[0] if members else state).device
    payload = torch.load(_rank_file(path, mesh), map_location=device)
    for st, p in (zip(state, payload) if members else [(state, payload)]):
        st.load_state_dict(p)
    return state
