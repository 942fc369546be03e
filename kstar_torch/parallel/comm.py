"""The collectives the data- and tensor-parallel paths are written with, and
the data-parallel context the models read.

PyTorch has no single controller: each device is one rank of
``torch.distributed`` and sees only its own rows of the global batch. What
GSPMD gives the JAX package for free, the port writes out here:

  * ``data_parallel(mesh)`` is a context, entered by the data-parallel
    steps (``train/loop.py make_train_step(mesh=)`` and the steps built
    like it) around the preprocessing, the forward and the backward. While
    it is entered on a mesh,
      - ``draw_rows`` makes a random draw of the GLOBAL batch's shape from
        the step's generator and keeps this rank's rows, so dropout masks,
        the 0D input noise and the augmentation parameters are those of the
        one-device step on the global batch (the draws' leading axis is the
        batch axis, or the batch axis folded with others behind it);
      - ``BatchNorm``/``SubBatchNorm`` reduce their statistics over the data
        group with ``all_reduce_sum``, a differentiable sum;
      - ``ldam_loss`` divides by the data group's sum of its weights.
    Off the context (no mesh, the one-device path) every one of them
    computes exactly what it computed before.
  * ``all_reduce_sum``, ``gather_last``, ``gather_rows`` and
    ``copy_to_group`` are the autograd-aware collectives of the
    column-parallel layers (``parallel/tp.py``), Megatron's f/g pair: the
    forward of a column-parallel Dense all-gathers the output columns and
    its backward hands each shard its slice; the input's gradient is summed
    over the model group.

A group of ``None`` is a group of one: every collective is then the
identity, with no ``torch.distributed`` call.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Sequence

import torch
import torch.distributed as dist

_LOCAL = threading.local()


# ---------------------------------------------------------------------------
# the data-parallel context
# ---------------------------------------------------------------------------

@contextmanager
def data_parallel(mesh):
    """Within the block, draws, batch statistics and LDAM's denominator
    cover the global batch of ``mesh``'s data group (module docstring).
    ``mesh=None`` enters nothing."""
    prev = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh if mesh is not None else prev
    try:
        yield
    finally:
        _LOCAL.mesh = prev


def current_mesh():
    """The mesh of the enclosing ``data_parallel`` block, or None."""
    return getattr(_LOCAL, "mesh", None)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` on the one-device path; inside ``data_parallel``, this
    rank's rows of ``draw`` of the global shape (the leading axis times the
    data-group size), so the values are those the one-device step draws for
    the same rows."""
    mesh = current_mesh()
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    n, size, rank = shape[0], mesh.shape["data"], mesh.data_index
    full = draw((n * size,) + shape[1:])
    return full[rank * n:(rank + 1) * n]


def reduce_data(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the enclosing block's data group (the
    identity off the context)."""
    mesh = current_mesh()
    if mesh is None:
        return t
    return all_reduce_sum(t, mesh.data_group)


def data_size() -> int:
    """The data-group size of the enclosing block (1 off the context)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.shape["data"]


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; each rank's dL/dx is the group's sum of
    dL/dy (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel layer: each shard sees all of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` in rank order; the backward hands this rank
    its slice of the gradient (every rank computes the same downstream)."""

    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.rank, ctx.n, ctx.dim = rank, x.shape[dim], dim
        return _gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (None: the identity)."""
    return t if group is None else _AllReduceSum.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    return t if group is None else _CopyToGroup.apply(t, group)


def gather_last(t: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    return t if group is None else _Gather.apply(t, group, rank, size, t.dim() - 1)


def gather_rows(t: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    return t if group is None else _Gather.apply(t, group, rank, size, 0)


class ColumnShards:
    """A module's column-parallel split (``parallel/tp.py``): ``names`` of
    its parameters that hold only this rank's rows, over ``group`` of
    ``size`` ranks where this one is ``rank``. Shared, never copied, by a
    deep copy of the module (a process group cannot be copied)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self.names = set()

    def __deepcopy__(self, memo):
        return self


# ---------------------------------------------------------------------------
# plain (no-grad) collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``; returns ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Equal-shape tensors of the group concatenated along axis 0 in rank
    order."""
    return t if group is None else _gather(t, group, size, 0)


def all_gather_objects(obj, group, size: int) -> list:
    """Every rank's ``obj`` (picklable) in rank order."""
    if group is None:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank of the default group."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s, in place; returns it."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast(t, src, group=group)
    return t


def barrier(group=None) -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=group)
