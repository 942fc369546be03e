"""The names of JAX's grouped ASHA rungs, for a search that groups trials.

Port of ``kstar_tpu/train/hpo_vmap.py``. JAX trains a rung of
same-architecture trials as one ``vmap``-ed program, routing each trial's
learning rate through the optimizer state and its focal gamma through the
step. The port has no grouped trainable: its members would step one after
another (train/ensemble.py), and such a loop saves only the shared batch
upload, which the card does not notice (PERF.md §5: a 4-member ensemble
step costs 4.1-4.9x a solo step). With ``search_space_0d``'s spaces the
groups are singletons besides (``lstm_dropout`` and ``dropout`` are
continuous architecture keys). So ``hpo_run --hpo_vmap`` runs the serial
trainable, and what stays here is what ``run_asha``'s ``group_trainable``
seam and a later batched-member trainable need (ROADMAP.md Queue 2):

  * ``group_key``: the architecture a group shares;
  * learning rate: a trial's ``TrainState`` carries its own ``Optimizer``
    (``set_learning_rate``), so no rate is routed through the optimizer
    state as JAX's ``inject_hyperparams`` does, and ``make_hpo_optimizer``
    is ``make_optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .state import TrainState, make_optimizer

TRACED_KEYS = ("lr", "focal_gamma")

# JAX's name: the staircase decay applies to the rate a trial sets with
# set_learning_rate, as JAX's post-schedule factor does
make_hpo_optimizer = make_optimizer


def group_key(config: Dict) -> tuple:
    """Hashable architecture key: every config key but the per-trial
    ``TRACED_KEYS``."""
    return tuple(sorted((k, str(v)) for k, v in config.items()
                        if k not in TRACED_KEYS))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Give ``state`` its own optimizer at base rate ``lr`` (the optimizer
    state, step and schedule position are kept); returns the state."""
    state.tx = dataclasses.replace(state.tx, lr=float(lr))
    return state
