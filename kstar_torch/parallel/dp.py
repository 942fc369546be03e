"""Data-parallel train and eval steps over a mesh of ranks.

Port of ``kstar_tpu/parallel/dp.py``. In JAX one controller jits the
ordinary step over the global batch and GSPMD inserts the gradient
all-reduce. Here each rank runs the step on its own rows, and the steps of
``train/loop.py`` take the mesh (``make_train_step(mesh=)``,
``make_eval_step(mesh=)``) and write out what GSPMD would insert, so that a
data-parallel step computes the one-device step's update on the global
batch, up to the order of its sums:

  * the loss and every gradient are SUMMED over the data group, in one
    ``all_reduce`` of the flat gradient buffer with the loss appended (CE
    and Focal sum over the batch, so DDP's averaging would be off by the
    group's size; LDAM's weighted mean divides by the group's sum of its
    weights, ``parallel/comm.py``);
  * the NaN guard decides on that global loss, so every rank steps or every
    rank skips;
  * BatchNorm and SubBatchNorm reduce their statistics over the data group
    (differentiably), so the running statistics stay equal on every rank;
  * dropout, the 0D input noise and the augmentation draws are made for the
    global batch from the step's generators, and each rank keeps its rows;
  * the eval step all-gathers the probabilities and predictions in rank
    order and sums the (masked) loss.

Host side, every rank draws the same epoch order, sampler indices and DRW
weights (one numpy seed) and uploads only its rows (``put``); only rank 0
writes checkpoints and logs, the others wait at a barrier
(``train/loop.py fit(mesh=)``). With no mesh every step computes exactly
what it computed before.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from ..config import LossConfig
from .mesh import Mesh, put_batch
from .multihost import replicate_tree_multihost


def make_dp_step_fns(loss_cfg: LossConfig, mesh: Mesh, model_type: str = "single",
                     pre_fn: Optional[Callable] = None) -> Tuple[Callable, Callable, Callable]:
    """(train_step, eval_step, put) for data-parallel training: the steps of
    ``train/loop.py`` on ``mesh`` (``pre_fn`` preprocesses in the train
    step), and ``put``, which uploads this rank's rows of a host (batch,
    labels) pair. The global batch must divide by the data-axis size."""
    from ..train.loop import make_eval_step, make_train_step

    train_step = make_train_step(loss_cfg, pre_fn, model_type, mesh=mesh)
    eval_step = make_eval_step(loss_cfg, None, model_type, mesh=mesh)

    def put(batch_and_labels):
        batch, labels = batch_and_labels
        return put_batch(mesh, batch), put_batch(mesh, labels)

    return train_step, eval_step, put


def replicate_state(state, mesh: Mesh):
    """Rank 0's train state on every rank (a broadcast; see
    ``replicate_tree_multihost``). Call it before ``shard_state_tp``."""
    return replicate_tree_multihost(mesh, state)
