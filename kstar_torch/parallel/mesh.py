"""The (data, model) grid of ranks and the puts that feed it.

Port of ``kstar_tpu/parallel/mesh.py``. JAX's ``Mesh`` is a grid of the
devices one controller drives; here each device is one rank of
``torch.distributed`` in its own process, so ``Mesh`` is this rank's view
of the grid: its coordinates, its device, and one process group per data
column (the ranks that split a batch) and per model row (the ranks that
split a layer). Rank ``r`` sits at ``(r // model, r % model)``, the order
of JAX's ``reshape(data, model)``.

The puts slice on the host and upload only this rank's part: ``put_batch``
the batch axis (this rank's rows of its data group; JAX's batch sharding,
the reference's ``DistributedSampler``), ``put_stack`` axis 1 of a
(K, B, ...) multi-step stack (axis 0 is the step axis and stays whole),
``put_replicated`` a broadcast from rank 0. JAX's ``batch_sharding``,
``replicated`` and ``stack_sharding`` placement objects are not ported:
nothing here reads a placement, the puts do the slicing.

Without a process group the mesh is one rank (``make_mesh`` on one
process), and every collective is the identity. Like every entry point of
the port, the mesh is on the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(eq=False)
class Mesh:
    """This rank's place in the (data, model) grid. ``shape`` maps the axis
    names to their sizes, as JAX's ``mesh.shape`` does; ``data_group`` and
    ``model_group`` are None where there is no process group."""
    shape: dict
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[MODEL_AXIS]

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and reports."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row global batch; raises unless the
        data axis divides ``n``, as JAX's batch sharding does."""
        d = self.shape[DATA_AXIS]
        if n % d:
            raise ValueError(f"global batch {n} is not divisible by the mesh's "
                             f"data axis ({d})")
        per = n // d
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def __deepcopy__(self, memo):
        return self          # process groups are shared, never copied


def make_mesh(cfg: MeshConfig = MeshConfig(), devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """This rank's (data, model) mesh over the ranks of the default process
    group (one rank without one). ``data=-1`` means all remaining ranks.
    This rank's device is ``devices[rank]`` where ``devices`` lists one per
    rank, else ``device``: None means the GPU, ``cuda:<local rank>``, and
    raises without CUDA (``resolve_device``); the CPU ranks of a gloo group
    pass ``device="cpu"``. Every rank must call it, in the same order as
    any other group creation (``dist.new_group`` is collective)."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    model = max(cfg.model, 1)
    data = cfg.data if cfg.data > 0 else n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    if devices is not None:
        devices = list(devices)
        assert len(devices) == n, f"{len(devices)} devices for {n} ranks"
        device = torch.device(devices[rank])
    else:
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    data_group = model_group = None
    if initialized:
        grid = np.arange(n).reshape(data, model)
        for m in range(model):                    # columns: split the batch
            g = dist.new_group(grid[:, m].tolist())
            if rank in grid[:, m]:
                data_group = g
        for d in range(data):                     # rows: split the layers
            g = dist.new_group(grid[d, :].tolist())
            if rank in grid[d, :]:
                model_group = g
    return Mesh(shape={DATA_AXIS: data, MODEL_AXIS: model}, rank=rank, device=device,
                data_group=data_group, model_group=model_group)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def put_batch(mesh: Mesh, batch):
    """This rank's rows of a host batch (array, tensor, or a dict/tuple of
    them, batch axis leading), on the mesh's device."""
    from ..data.loader import to_device

    return _map(lambda x: to_device(x[mesh.rows(len(x))], mesh.device), batch)


def put_stack(mesh: Mesh, batch):
    """This rank's rows of a (K, B, ...) stack: axis 1 (the batch) is sliced,
    axis 0 (the steps) stays whole."""
    from ..data.loader import to_device

    return _map(lambda x: to_device(x[:, mesh.rows(x.shape[1])], mesh.device), batch)


def put_replicated(mesh: Mesh, tree):
    """Rank 0's values of a tree of tensors on every rank, on the mesh's
    device (a broadcast over the whole group)."""
    from .comm import broadcast_

    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        return broadcast_(x.to(mesh.device).clone(), 0)

    return _map(put, tree)
