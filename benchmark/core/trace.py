"""Host spans and the device trace of a traced run.

``Tracer.span(name)`` times a span of the benchmark's own on the host clock
and, while tracing, keeps its start and end (Unix time in ns, the clock the
profiler's events carry). ``Tracer.profiling()`` wraps a traced window in
``torch.profiler`` with device activity alone (kernels, copies, and the
runtime calls that launched them; no host operator events, whose recording
would slow the host-paced loops it measures); ``TraceData`` reads its events
in memory once the window has closed and gives each kernel the span its
launch fell in. Nothing is exported to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

from . import kernels as kernel_names

WINDOW = "window"


class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self.host = {}            # span name -> [seconds, count]
        self.spans = []           # (start_ns, end_ns, name) while tracing
        self.data = None          # TraceData once a profiled window closed

    @contextlib.contextmanager
    def span(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        if self.on:
            self.spans.append((w0, time.time_ns(), name))
        acc = self.host.setdefault(name, [0.0, 0])
        acc[0] += time.perf_counter() - t0
        acc[1] += 1

    @contextlib.contextmanager
    def profiling(self):
        """The profiler around the traced window (nothing when tracing is
        off); its events are read into ``self.data`` on exit."""
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        # device activity alone; a run without a card (tests) traces the host
        activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        with profile(activities=[activity]) as prof:
            yield
        self.data = TraceData.from_profile(prof, self.spans)


@dataclass
class TraceData:
    kernels: list = field(default_factory=list)   # (start_ns, end_ns, name, launch span)
    copies: list = field(default_factory=list)    # (start_ns, end_ns, name)
    spans: list = field(default_factory=list)     # (start_ns, end_ns, name), host side
    window: tuple = (0, 0)

    @classmethod
    def from_profile(cls, prof, host_spans: list) -> "TraceData":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        raw_kernels, copies, launches = [], [], {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if name.startswith(kernel_names.COPY):
                    copies.append((e.start_ns(), e.end_ns(), name))
                else:
                    raw_kernels.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
            elif name.startswith("cu"):         # runtime and driver launch calls
                launches[e.correlation_id()] = e.start_ns()
        window = next((s, e) for s, e, n in host_spans if n == WINDOW)
        spans = sorted(sp for sp in host_spans if sp[2] != WINDOW)
        out = cls(copies=copies, spans=spans, window=window)
        starts = [s[0] for s in spans]
        for start, end, name, corr in raw_kernels:
            t = launches.get(corr)
            out.kernels.append((start, end, name, None if t is None else out._span_at(starts, t)))
        return out

    def _span_at(self, starts: list, t: int):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]:
            return self.spans[i][2]
        return None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of kernel and copy intervals inside the window."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for s, e, *_ in self.kernels + self.copies
                     if e > lo and s < hi)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, pred=lambda name: True, span=None) -> float:
        return sum(e - s for s, e, n, sp in self.kernels
                   if pred(n) and (span is None or sp == span)) / 1e9

    def kernel_count(self, pred=lambda name: True, span=None) -> int:
        return sum(1 for s, e, n, sp in self.kernels
                   if pred(n) and (span is None or sp == span))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time inside the window by the host span it fell in."""
        by_name = {}
        for s, e, n, _ in self.kernels:
            by_name[n] = by_name.get(n, 0) + e - s
        for s, e, n in self.copies:
            by_name[n] = by_name.get(n, 0) + e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        starts = [s[0] for s in self.spans]
        gaps, prev = {}, self.window[0]
        for s, e in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if s > prev:
                where = self._span_at(starts, (s + prev) // 2) or "between_spans"
                gaps[where] = gaps.get(where, 0) + s - prev
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}
