"""Latency / throughput harness (reference measure_computation_time,
src/utils/utility.py:1201-1265 and compute_time.py:263-268).

Port of ``kstar_tpu/infer/latency.py``. Measures (a) reference-style
single-sample latency mean/std over n timed forwards and (b) batched
clips/sec at a given batch size, with warm-up excluded and the host clock
read after ``torch.cuda.synchronize()`` when the work runs on a GPU.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import resolve_device


def _synchronize(args: tuple) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)
            return


def measure_forward(apply_fn, args: tuple, n_samples: int = 16,
                    warmup: int = 2) -> Dict[str, float]:
    """Timed forwards of ``apply_fn(*args)``. Returns {mean_s, std_s, p50_s,
    p99_s} latencies; measure_model adds clips_per_s. The device the
    tensors in ``args`` lie on is synchronised before each clock read."""
    for _ in range(warmup):
        apply_fn(*args)
    _synchronize(args)

    times = []
    for _ in range(n_samples):
        t0 = time.perf_counter()
        apply_fn(*args)
        _synchronize(args)
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {
        "mean_s": float(t.mean()),
        "std_s": float(t.std()),
        "p50_s": float(np.percentile(t, 50)),
        "p99_s": float(np.percentile(t, 99)),
    }


def measure_model(model, sample_args: tuple, n_samples: int = 16,
                  warmup: int = 2, device=None) -> Dict[str, float]:
    """Reference-style harness over a model's eval forward. ``device=None``
    means the GPU; the model and ``sample_args`` are moved there."""
    device = resolve_device(device)
    model = model.to(device).eval()
    sample_args = tuple(a.to(device) for a in sample_args)

    @torch.no_grad()
    def fwd(*args):
        return model(*args)

    stats = measure_forward(fwd, sample_args, n_samples, warmup)
    batch = sample_args[0].shape[0]
    stats["clips_per_s"] = batch / stats["mean_s"]
    return stats
