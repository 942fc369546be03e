"""Data- and tensor-parallel training over ``torch.distributed`` (port of
``kstar_tpu/parallel``; JAX's public names)."""

from .dp import make_dp_step_fns, replicate_state
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, put_batch, put_replicated, put_stack
from .multihost import (global_batch_from_local, host_batch_slice, init_multihost,
                        replicate_tree_multihost)
from .tp import shard_state_tp, tp_param_shardings
