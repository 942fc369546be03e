"""Profiling + numerical-debug utilities.

Port of ``kstar_tpu/utils/profiling.py``. The reference has no profiler
(SURVEY.md §5), only wall-clock harnesses; its anomaly machinery is
torch.autograd.set_detect_anomaly + a NaN-loss skip (reference
src/train.py:15, :56-58). Here:

  * ``span`` — the program's own spans (the sweep's and the train step's
    stages), recorded in memory while a ``torch.profiler`` session is
    active and read back with ``spans``;
  * ``profile_trace`` — context manager around ``torch.profiler`` (the
    CPU, and the GPU where there is one) that writes a chrome trace into
    ``log_dir`` (chrome://tracing or Perfetto), the program's spans in it;
  * ``set_debug_nans`` — ``torch.autograd.set_detect_anomaly``: a backward
    that produces a NaN raises, naming the forward op that recorded it.
    It checks the backward only, where JAX's ``jax_debug_nans`` checks
    every op, forward included (the step-level NaN guard in train/loop.py
    covers the loss);
  * ``device_memory_stats`` — ``torch.cuda.memory_stats``.

Spans. ``with span(name, **attrs) as sp:`` records ``(start_ns, end_ns,
name, parent, attrs)`` on ``time.time_ns()``, the clock the profiler's
events carry, so a span can be laid over the device trace; ``parent`` is
the name of the span open around it on the same thread, ``sp.set(**attrs)``
adds attributes known only at the end. Recording is on exactly while a
profiler session is (``torch.autograd.profiler._is_profiler_enabled``):
otherwise ``span`` returns one shared object that does nothing and reads no
clock. A span reads no device value and neither launches nor synchronises
anything.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class SpanRecord(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    parent: Optional[str]
    attrs: dict


_RECORDS: List[SpanRecord] = []
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "parent", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        _stack().pop()
        _RECORDS.append(SpanRecord(self.start_ns, end_ns, self.name, self.parent, self.attrs))
        return False


class _NoSpan:
    """What ``span`` returns while no profiler session is active."""
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span named ``name`` (module docstring); ``NO_SPAN`` while no
    profiler session is active."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, attrs)


def spans(name: Optional[str] = None) -> List[SpanRecord]:
    """The spans recorded since the last ``clear``, in the order they
    closed; only those named ``name`` if given."""
    return [s for s in _RECORDS if name is None or s.name == name]


def clear() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def recording() -> Iterator[List[SpanRecord]]:
    """A profiler session with the least activity (the GPU's where there is
    one, else the CPU's), to record spans; yields a list that holds, on
    exit, the spans closed inside it."""
    activity = (torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU)
    first = len(_RECORDS)
    out: List[SpanRecord] = []
    with torch.profiler.profile(activities=[activity]):
        yield out
    out.extend(_RECORDS[first:])


def _chrome_events(records: List[SpanRecord], base_ns: int) -> list:
    """The spans as complete ("X") events in microseconds from ``base_ns``,
    on a row of their own in this process."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "kstar_torch", "name": s.name, "pid": pid,
             "tid": "kstar_torch spans", "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"parent": s.parent, **{k: str(v) for k, v in s.attrs.items()}}}
            for s in records]


@contextlib.contextmanager
def profile_trace(log_dir: str = "./results/trace") -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block into ``log_dir/trace.json``,
    with the spans recorded inside it as host events on the trace's time
    base. Clears the span recorder on entry."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # the events' "ts" count from baseTimeNanoseconds (Unix time)
    trace["traceEvents"] += _chrome_events(spans(), int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)


def set_debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats() -> Optional[dict]:
    """The GPU's memory statistics, or None where there is no GPU (as
    JAX's returns None where the backend has none)."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats()
