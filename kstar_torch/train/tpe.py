"""Dependency-free Tree-structured Parzen Estimator (TPE) sampler.

The port's own copy of ``kstar_tpu/train/tpe.py`` (numpy only): for the
same observations and the same ``np.random.Generator`` it proposes the same
configs.

The reference searches hyperparameters with HyperOpt's TPE under Ray Tune's
ASHA scheduler (reference hyperparameter_tuning.py:18 ``HyperOptSearch``,
:527-546 ``tune.run(search_alg=...)``). This module rebuilds the search
*algorithm* without the HyperOpt/Ray dependency: completed trials are split
into good/bad by score quantile, each hyperparameter is modeled with a pair
of 1-D Parzen mixtures l(x) (good) / g(x) (bad) — Gaussians truncated to
the prior bounds plus a uniform prior component — and candidates drawn from
l(x) are ranked by the acquisition log l(x) - log g(x) (Bergstra et al.,
"Algorithms for Hyper-Parameter Optimization", NeurIPS 2011).

Space specs come from train/hpo.py's ``uniform``/``loguniform``/``choice``/
``randint`` factories, which tag their samplers with ``kind``/bounds
attributes; a space entry without tags (a custom lambda) silently falls
back to prior sampling for that key.

Composition with ASHA: train/hpo.run_asha(search="tpe") samples a random
startup batch, advances it to the first rung, then draws the remaining
trials batch-by-batch from a TPESampler observing first-rung scores —
batches keep grouped rungs (run_asha's ``group_trainable``) dense.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np

_SQRT2 = math.sqrt(2.0)


def _norm_logpdf(x: float, mu: float, sigma: float) -> float:
    z = (x - mu) / sigma
    return -0.5 * z * z - math.log(sigma) - 0.5 * math.log(2 * math.pi)


def _trunc_mass(mu: float, sigma: float, lo: float, hi: float) -> float:
    """Probability mass of N(mu, sigma) inside [lo, hi]."""
    a = 0.5 * (1 + math.erf((hi - mu) / (sigma * _SQRT2)))
    b = 0.5 * (1 + math.erf((lo - mu) / (sigma * _SQRT2)))
    return max(a - b, 1e-12)


class _ParzenMixture:
    """Uniform prior + one truncated Gaussian per observation, in a
    (possibly log-) transformed 1-D domain [lo, hi]."""

    def __init__(self, values: List[float], lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.mus = list(values)
        n = len(self.mus)
        # simplified Parzen bandwidth: shrink with observation count so the
        # mixture sharpens as evidence accumulates, floored to stay proper.
        # A zero-width domain (a pinned hyperparameter like uniform(x, x))
        # degenerates to a point mass: keep sigma/width positive so logpdf
        # and sample stay defined and the pinned value is always proposed.
        width = hi - lo
        self.degenerate = width <= 0.0
        if self.degenerate:
            width = max(abs(hi), 1.0) * 1e-9
            self.hi = self.lo + width
        self.sigma = max(width / max(math.sqrt(n + 1), 1.0), 1e-3 * width)
        self.n_comp = n + 1                     # + uniform prior component

    def logpdf(self, x: float) -> float:
        terms = [math.log(1.0 / (self.hi - self.lo))]          # prior
        for mu in self.mus:
            terms.append(_norm_logpdf(x, mu, self.sigma)
                         - math.log(_trunc_mass(mu, self.sigma,
                                                self.lo, self.hi)))
        m = max(terms)
        return (m + math.log(sum(math.exp(t - m) for t in terms))
                - math.log(self.n_comp))

    def sample(self, rng: np.random.Generator) -> float:
        k = int(rng.integers(self.n_comp))
        if k == 0:
            return float(rng.uniform(self.lo, self.hi))
        # rejection-free truncation: clip is fine for candidate generation
        # (density scoring is exact; clipping only biases proposals)
        return float(np.clip(rng.normal(self.mus[k - 1], self.sigma),
                             self.lo, self.hi))


class TPESampler:
    """Per-key independent TPE over a train/hpo.py search space.

    ``observe(config, score)`` records a completed (or first-rung) trial;
    ``sample(rng)`` proposes the config maximizing l/g among n_candidates
    draws from l. Higher score = better (macro-F1 convention)."""

    def __init__(self, space: Dict[str, Callable], gamma: float = 0.25,
                 n_candidates: int = 24, prior_weight: float = 1.0):
        self.space = space
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.prior_weight = prior_weight
        self.obs: List[Tuple[Dict, float]] = []

    def observe(self, config: Dict, score: float) -> None:
        if np.isfinite(score):
            self.obs.append((dict(config), float(score)))

    # -- internals ----------------------------------------------------------

    def _split(self):
        scores = np.array([s for _, s in self.obs])
        n_good = max(1, int(math.ceil(self.gamma * len(self.obs))))
        order = np.argsort(scores)[::-1]
        good = [self.obs[i][0] for i in order[:n_good]]
        bad = [self.obs[i][0] for i in order[n_good:]]
        return good, bad

    @staticmethod
    def _transform(kind: str, v: float) -> float:
        return math.log(v) if kind == "loguniform" else float(v)

    def _numeric(self, key: str, fn, good, bad, rng) -> float:
        kind = fn.kind
        lo, hi = fn.lo, fn.hi
        if kind == "loguniform":
            lo, hi = math.log(lo), math.log(hi)
        gv = [self._transform(kind, c[key]) for c in good if key in c]
        bv = [self._transform(kind, c[key]) for c in bad if key in c]
        l = _ParzenMixture(gv, lo, hi)
        g = _ParzenMixture(bv, lo, hi)
        cands = [l.sample(rng) for _ in range(self.n_candidates)]
        best = max(cands, key=lambda x: l.logpdf(x) - g.logpdf(x))
        if kind == "loguniform":
            return float(math.exp(best))
        if kind == "randint":
            return int(np.clip(round(best), fn.lo, fn.hi - 1))
        return float(best)

    def _categorical(self, key: str, fn, good, bad, rng):
        options = list(fn.options)

        def idx_of(v):
            for i, o in enumerate(options):
                if o == v or (isinstance(o, (tuple, list)) and tuple(o) == tuple(v)):
                    return i
            return None

        def probs(configs):
            counts = np.full(len(options), self.prior_weight)
            for c in configs:
                i = idx_of(c.get(key))
                if i is not None:
                    counts[i] += 1
            return counts / counts.sum()

        p_l, p_g = probs(good), probs(bad)
        cand_idx = rng.choice(len(options), size=self.n_candidates, p=p_l)
        best = max(cand_idx,
                   key=lambda i: math.log(p_l[i]) - math.log(p_g[i]))
        return options[int(best)]

    def sample(self, rng: np.random.Generator) -> Dict:
        from .hpo import sample_config

        if not self.obs:
            return sample_config(self.space, rng)
        good, bad = self._split()
        cfg = {}
        for key, fn in self.space.items():
            kind = getattr(fn, "kind", None)
            if kind in ("uniform", "loguniform", "randint"):
                cfg[key] = self._numeric(key, fn, good, bad, rng)
            elif kind == "choice":
                cfg[key] = self._categorical(key, fn, good, bad, rng)
            else:                       # untagged custom spec: prior draw
                cfg[key] = fn(rng)
        return cfg
