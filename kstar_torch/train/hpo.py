"""Hyperparameter optimization: random or TPE search + ASHA halving.

Rebuild of the reference's Ray Tune + HyperOpt + ASHAScheduler stack
(reference src/hpo.py, hyperparameter_tuning.py:513-546) without external
dependencies: trials are functional (config, state) pairs, the scheduler is
synchronous successive halving (train every trial to the rung budget, keep
the top 1/reduction_factor, resume survivors from their own train state —
the reference's tune.checkpoint_dir restore, hyperparameter_tuning.py:194-197),
per-model search spaces mirror hyperparameter_tuning.py:454-511, and
``search="tpe"`` swaps random config generation for the model-based TPE
sampler (train/tpe.py — the reference's HyperOptSearch equivalent).

The port's own copy of ``kstar_tpu/train/hpo.py`` (numpy only): the same
space, the same draws and the same halving, so for the same trainable and
seed it writes the same trial log. ``devices`` are ``torch.device``s, one
per thread worker.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


# -- search space -----------------------------------------------------------
# Each factory tags its sampler with kind/bounds attributes so the TPE
# sampler (train/tpe.py) can model the distribution; plain random search
# only ever calls the sampler.

def uniform(lo: float, hi: float):
    fn = lambda rng: float(rng.uniform(lo, hi))
    fn.kind, fn.lo, fn.hi = "uniform", float(lo), float(hi)
    return fn


def loguniform(lo: float, hi: float):
    fn = lambda rng: float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    fn.kind, fn.lo, fn.hi = "loguniform", float(lo), float(hi)
    return fn


def choice(options: List):
    fn = lambda rng: options[int(rng.integers(len(options)))]
    fn.kind, fn.options = "choice", list(options)
    return fn


def randint(lo: int, hi: int):
    fn = lambda rng: int(rng.integers(lo, hi))
    fn.kind, fn.lo, fn.hi = "randint", int(lo), int(hi)
    return fn


def sample_config(space: Dict[str, Callable], rng: np.random.Generator) -> Dict:
    return {k: fn(rng) for k, fn in space.items()}


# -- ASHA -------------------------------------------------------------------

@dataclass
class Trial:
    trial_id: int
    config: Dict
    state: Any = None          # opaque train state, threaded through rungs
    epochs_done: int = 0
    scores: List[float] = field(default_factory=list)

    @property
    def best(self) -> float:
        return max(self.scores) if self.scores else -math.inf


def run_asha(
    trainable: Callable[..., Tuple[Any, List[float]]],
    space: Dict[str, Callable],
    n_trials: int = 16,
    max_epochs: int = 32,
    grace_period: int = 4,
    reduction_factor: int = 2,
    seed: int = 42,
    log_path: Optional[str] = None,
    n_workers: int = 1,
    devices: Optional[List] = None,
    group_trainable: Optional[Callable] = None,
    search: str = "random",
    tpe_startup: Optional[int] = None,
    tpe_batch: int = 4,
    tpe_gamma: float = 0.25,
) -> Tuple[Trial, List[Trial]]:
    """Synchronous successive halving.

    ``trainable(config, n_epochs, state)`` trains for n_epochs more (resuming
    from ``state`` if given) and returns (new_state, per-epoch scores, higher
    is better).

    With ``n_workers > 1`` the trials within each rung run concurrently on a
    thread pool (the reference's Ray Tune concurrency over GPUs,
    hyperparameter_tuning.py:527-546); if ``devices`` (``torch.device``s)
    is given, trials are round-robined over them and a 4-argument trainable
    receives its device as ``trainable(config, n_epochs, state, device)``;
    with several cards each trial then trains on its own card.

    ``group_trainable(configs, n_epochs, states) -> (states, score_lists)``:
    trials sharing an architecture (hpo_vmap.group_key — every config key
    except the per-trial lr/focal_gamma) advance together per rung, in one
    call. Cross-architecture groups simply land in different groups; a
    singleton group is a group of one. (The port has no grouped trainable
    of its own yet: train/hpo_vmap.py.)

    ``search="tpe"`` replaces purely random config generation with the
    reference's TPE model-based search (HyperOptSearch,
    reference hyperparameter_tuning.py:18,:527-546): ``tpe_startup`` trials
    (default half the pool, floored at 4) sample from the prior and run to
    the first rung; the remaining trials are then proposed batch-by-batch
    (``tpe_batch``, keeps grouped rungs dense) by a TPESampler
    (train/tpe.py) observing first-rung scores. The total epoch budget is
    identical to random search — every trial reaches the first rung and the
    bracket then halves exactly as before.
    """
    import inspect

    rng = np.random.default_rng(seed)

    takes_device = len(inspect.signature(trainable).parameters) >= 4

    def advance(t: Trial, add: int, device) -> None:
        if takes_device:
            t.state, scores = trainable(t.config, add, t.state, device)
        else:
            t.state, scores = trainable(t.config, add, t.state)
        t.scores.extend(scores)
        t.epochs_done += add

    def advance_grouped(jobs) -> None:
        from .hpo_vmap import group_key

        groups: Dict[tuple, List[Trial]] = {}
        for t, add in jobs:
            groups.setdefault((group_key(t.config), add), []).append(t)
        for (_, add), ts in groups.items():
            new_states, score_lists = group_trainable(
                [t.config for t in ts], add, [t.state for t in ts])
            for t, st, sc in zip(ts, new_states, score_lists):
                t.state = st
                t.scores.extend(sc)
                t.epochs_done += add

    def run_jobs(jobs) -> None:
        if not jobs:
            return
        if group_trainable is not None:
            advance_grouped(jobs)
        elif n_workers > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            devs = devices or [None]
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                futs = [ex.submit(advance, t, add, devs[i % len(devs)])
                        for i, (t, add) in enumerate(jobs)]
                for f in futs:
                    f.result()
        else:
            for i, (t, add) in enumerate(jobs):
                advance(t, add, (devices or [None])[i % len(devices or [None])])

    first_rung = min(grace_period, max_epochs)
    if search == "tpe":
        from .tpe import TPESampler

        default_startup = max(n_trials // 2, 4)
        n_startup = min(tpe_startup if tpe_startup is not None
                        else default_startup, n_trials)
        trials = [Trial(i, sample_config(space, rng))
                  for i in range(n_startup)]
        run_jobs([(t, first_rung) for t in trials])
        sampler = TPESampler(space, gamma=tpe_gamma)
        for t in trials:
            sampler.observe(t.config, t.best)
        i = n_startup
        while i < n_trials:
            batch = [Trial(j, sampler.sample(rng))
                     for j in range(i, min(i + tpe_batch, n_trials))]
            i += len(batch)
            run_jobs([(t, first_rung) for t in batch])
            for t in batch:
                sampler.observe(t.config, t.best)
            trials.extend(batch)
    elif search == "random":
        trials = [Trial(i, sample_config(space, rng)) for i in range(n_trials)]
    else:
        raise ValueError(f"unknown search {search!r} (random|tpe)")

    rung_budget = grace_period
    alive = list(trials)
    while alive:
        jobs = [(t, min(rung_budget, max_epochs) - t.epochs_done)
                for t in alive]
        jobs = [(t, add) for t, add in jobs if add > 0]
        run_jobs(jobs)
        if rung_budget >= max_epochs:
            break
        alive.sort(key=lambda t: t.best, reverse=True)
        alive = alive[: max(len(alive) // reduction_factor, 1)]
        # a sole survivor still trains to max_epochs (Ray Tune ASHA promotes
        # the top trial to max_t); breaking here would export an undertrained
        # best model whenever the bracket narrows to one trial early
        rung_budget *= reduction_factor

    best = max(trials, key=lambda t: t.best)
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        with open(log_path, "w") as f:
            json.dump([{"trial": t.trial_id, "config": t.config,
                        "epochs": t.epochs_done, "best": t.best,
                        "scores": t.scores} for t in trials], f, indent=2, default=str)
    return best, trials


# -- per-model search spaces (reference hyperparameter_tuning.py:454-511) ----

def search_space_0d(model: str) -> Dict[str, Callable]:
    common = {
        "lr": loguniform(1e-4, 1e-2),
        "batch_size": choice([64, 128, 256]),
        "focal_gamma": uniform(0.5, 4.0),
    }
    if model == "Transformer":
        return {**common, "feature_dims": choice([64, 128, 256]),
                "n_layers": randint(1, 6), "dropout": uniform(0.0, 0.3)}
    if model == "CnnLSTM":
        return {**common, "conv_dim": choice([32, 64, 128]),
                "lstm_dim": choice([64, 128, 256]), "n_layers": randint(1, 4)}
    if model == "MLSTM_FCN":
        return {**common, "fcn_dim": choice([64, 128, 256]),
                "lstm_dim": choice([64, 128]), "lstm_dropout": uniform(0.0, 0.3)}
    raise ValueError(model)


def search_space_video(model: str) -> Dict[str, Callable]:
    common = {"lr": loguniform(1e-5, 1e-3), "batch_size": choice([16, 32, 64]),
              "focal_gamma": uniform(0.5, 4.0)}
    if model == "ViViT":
        return {**common, "dim": choice([64, 128, 192]), "depth": randint(1, 4),
                "n_heads": choice([2, 4, 8]), "dropout": uniform(0.0, 0.3)}
    if model == "R2Plus1D":
        return {**common, "layer_sizes": choice([(1, 1, 1, 1), (1, 2, 2, 1), (2, 2, 2, 2)])}
    if model == "SlowFast":
        return {**common, "alpha": choice([2, 4])}
    raise ValueError(model)
