"""Tensor-parallel (column-parallel) layers over the mesh's ``model`` axis.

Port of ``kstar_tpu/parallel/tp.py``. JAX places large Dense kernels with a
column sharding and lets GSPMD insert the collectives; here each chosen
layer is split by hand, Megatron's column-parallel layer:

  * this rank holds its rows of the torch ``weight`` (out, in) and of the
    ``bias``: its block of output columns;
  * the forward computes those columns and all-gathers them over the model
    group (``parallel/comm.py gather_last``); the backward hands each shard
    its slice of the gradient, and the input's gradient, a partial sum on
    each rank, is summed over the model group (``copy_to_group``);
  * an LSTM cell's stacked ``w_ih``/``w_hh`` (which the recurrence needs
    whole) keeps its rows sharded in storage and in the optimizer, and is
    all-gathered for the forward (``gather_rows``, sliced back in the
    backward);
  * ``TrainState`` flattens the shards, so its flat buffer, its optimizer
    moments and its checkpoint hold this rank's shards (``shard_state_tp``
    slices the moments the same way, JAX's mirrored placement), and the
    global-norm clip adds the model group's sum of the shards' squares.

Every rank of a model row computes the same replicated layers on the same
rows, so their gradients need only the data-group sum of the data-parallel
step. The beneficiary is TFN's fusion head (a 16,641 x 8,320 Dense at the
CLI's widths).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .comm import ColumnShards
from .mesh import MODEL_AXIS, Mesh


def _chosen(module: nn.Module, n: int, min_size: int) -> set:
    """The names of ``module``'s own parameters JAX's rule splits: a 2-D
    kernel with at least ``min_size`` elements whose output dimension the
    model axis divides. The port's models hold exactly two kinds of 2-D
    parameter: a Dense ``weight`` (out, in), flax's (in, out) kernel
    transposed, whose ``bias`` is split with it here (the layer computes
    its own output columns); and an LSTM cell's ``w_ih``/``w_hh``, flax's
    four (in, H) / (H, H) gate kernels stacked, so each gate is judged as
    JAX judges it (the cell's bias, 1-D, stays replicated as in JAX)."""
    from ..models.common import LSTMCellParams
    from ..models.vivit import Dense

    if n <= 1:
        return set()
    if isinstance(module, Dense):
        w = module.weight
        if w.numel() >= min_size and w.shape[0] % n == 0:
            return {"weight"} | ({"bias"} if module.bias is not None else set())
    elif isinstance(module, LSTMCellParams):
        return {attr for attr in ("w_ih", "w_hh")
                if getattr(module, attr).numel() // 4 >= min_size
                and (getattr(module, attr).shape[0] // 4) % n == 0}
    return set()


def tp_param_shardings(model: nn.Module, mesh: Mesh,
                       min_size: int = 1 << 16) -> Dict[str, Optional[str]]:
    """Per parameter name: ``MODEL_AXIS`` where the parameter is split over
    the model axis, None where it is replicated."""
    n = mesh.shape[MODEL_AXIS]
    out = {}
    for mod_name, module in model.named_modules():
        split = _chosen(module, n, min_size)
        for attr, _ in module.named_parameters(recurse=False):
            out[f"{mod_name}.{attr}" if mod_name else attr] = (
                MODEL_AXIS if attr in split else None)
    return out


def shard_state_tp(state, mesh: Mesh, min_size: int = 1 << 16):
    """A new ``TrainState`` whose chosen layers are column-parallel over the
    model axis (module docstring): parameters and optimizer moments keep
    this rank's rows, everything else stays replicated. Call it after
    ``replicate_state``; the state passed in shares the model and is not
    to be used again."""
    from ..train.state import TrainState

    placements = tp_param_shardings(state.model, mesh, min_size)
    if not any(placements.values()):
        return state
    n, r = mesh.shape[MODEL_AXIS], mesh.model_index
    trainable = {id(p) for p in state.params}
    layout, off = [], 0                          # (name, offset, shape) in the old flat
    for name, p in state.model.named_parameters():
        if id(p) in trainable:
            layout.append((name, off, p.shape))
            off += p.numel()
    modules = dict(state.model.named_modules())
    for name, axis in placements.items():
        if axis is None:
            continue
        mod_name, attr = name.rsplit(".", 1) if "." in name else ("", name)
        module = modules[mod_name]
        p = getattr(module, attr)
        rows = p.shape[0] // n
        setattr(module, attr, nn.Parameter(p.detach()[r * rows:(r + 1) * rows].clone()))
        info = getattr(module, "tp", None) or ColumnShards(mesh.model_group, r, n)
        info.names.add(attr)
        module.tp = info

    def shard(flat: torch.Tensor) -> torch.Tensor:
        parts = []
        for name, o, shape in layout:
            v = flat[o:o + shape.numel()].view(shape)
            if placements[name] is not None:
                rows = shape[0] // n
                v = v[r * rows:(r + 1) * rows]
            parts.append(v.reshape(-1))
        return torch.cat(parts)

    new = TrainState(state.model, state.tx, state.seed)
    new.opt_state = {k: (shard(v) if v.shape == state.flat.shape else v.clone())
                     for k, v in state.opt_state.items()}
    new.step, new.draws = state.step.clone(), state.draws
    return new
