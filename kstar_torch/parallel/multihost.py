"""Process-group start-up and per-rank data feeding.

Port of ``kstar_tpu/parallel/multihost.py``. JAX has one controller per
host and ``jax.distributed.initialize``; here every device is one rank of
``torch.distributed`` (the reference's ``mp.spawn`` + NCCL rendezvous,
src/distributed.py:205-246): each rank calls ``init_multihost`` once,
before it builds a mesh, and feeds only its own rows.

Every rendezvous and collective takes ``TIMEOUT``: a rank that never
arrives fails the run within a minute instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from .comm import broadcast_
from .mesh import Mesh

TIMEOUT = datetime.timedelta(seconds=60)


def _backend(device: Optional[str]) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks. ``None`` means the GPU and
    raises without CUDA (``resolve_device``): no quiet fall back to gloo."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: Optional[str] = None,
                   timeout: datetime.timedelta = TIMEOUT,
                   backend: Optional[str] = None) -> None:
    """Join the default process group.

    * Explicit arguments declare the topology: all three are required, the
      address is ``host:port`` (``tcp://`` is added) or a URL (``tcp://``,
      ``file://``), and a failure raises, as JAX's does: a misconfigured
      launch must not fall back to one process.
    * No arguments: ``env://`` when a launcher set ``RANK`` and
      ``WORLD_SIZE`` (torchrun), otherwise nothing (one process).

    ``device``: this rank's device, which picks the backend (NCCL for CUDA,
    gloo for the CPU; default: the GPU, so NCCL, raising without CUDA) unless
    ``backend`` names one (gloo also takes CUDA tensors, and unlike NCCL
    lets several ranks share one card). An NCCL rank is bound to
    ``cuda:<LOCAL_RANK>`` (or its process id) first."""
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("init_multihost: coordinator_address, num_processes and "
                             "process_id go together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        url, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return
    if dist.is_initialized():
        raise RuntimeError("init_multihost: a process group is already initialized")
    backend = backend or _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank,
                            timeout=timeout)


def host_batch_slice(n_global: int) -> slice:
    """The [start, stop) slice of the global batch this rank loads."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def replicate_tree_multihost(mesh: Mesh, state):
    """Make every rank's ``TrainState`` rank 0's: the flat parameters, the
    flat batch statistics and the optimizer state are broadcast from rank 0
    (DDP's start-up broadcast; the JAX version builds the same seed on every
    host instead). Returns the state, changed in place."""
    with torch.no_grad():
        broadcast_(state.flat, 0)
        if state.stats_flat is not None:
            broadcast_(state.stats_flat, 0)
        for v in state.opt_state.values():
            broadcast_(v, 0)
        broadcast_(state.step, 0)
    return state


def global_batch_from_local(mesh: Mesh, local_batch):
    """This rank's slice of the global batch (batch axis leading), on its
    device: the form the data-parallel step takes. Every rank passes its
    own ``host_batch_slice`` rows."""
    from ..data.loader import to_device

    return to_device(local_batch, mesh.device)

