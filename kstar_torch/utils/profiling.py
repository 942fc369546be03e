"""Profiling + numerical-debug utilities.

Port of ``kstar_tpu/utils/profiling.py``. The reference has no profiler
(SURVEY.md §5), only wall-clock harnesses; its anomaly machinery is
torch.autograd.set_detect_anomaly + a NaN-loss skip (reference
src/train.py:15, :56-58). Here:

  * ``profile_trace`` — context manager around ``torch.profiler`` (the
    CPU, and the GPU where there is one) that writes a chrome trace into
    ``log_dir`` (chrome://tracing or Perfetto);
  * ``set_debug_nans`` — ``torch.autograd.set_detect_anomaly``: a backward
    that produces a NaN raises, naming the forward op that recorded it.
    It checks the backward only, where JAX's ``jax_debug_nans`` checks
    every op, forward included (the step-level NaN guard in train/loop.py
    covers the loss);
  * ``device_memory_stats`` — ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "./results/trace") -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block into ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def set_debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats() -> Optional[dict]:
    """The GPU's memory statistics, or None where there is no GPU (as
    JAX's returns None where the backend has none)."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats()
