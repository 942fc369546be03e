"""The program's own spans in a traced run, and the device's idle time by
those spans.

``kstar_torch.utils.profiling`` records ``(start_ns, end_ns, name, parent,
attrs)`` spans while a profiler session is active, on the clock the device
trace's events carry. ``in_window`` gives those inside the traced window
(none where the program records none); ``idle_ns`` sums the device's idle
gaps whose midpoint falls in one of the given spans, the rule
``TraceData.breakdown`` applies to the benchmark's own spans.
"""

from __future__ import annotations

import bisect


def in_window(run, name: str) -> list:
    """The program's spans named ``name`` inside the traced window."""
    if run.trace is None:
        return []
    try:
        from kstar_torch.utils.profiling import spans
    except ImportError:                 # a program without the recorder
        return []
    lo, hi = run.trace.window
    return [s for s in spans(name) if lo <= s[0] and s[1] <= hi]


def gaps(trace) -> tuple:
    """(midpoints, cumulative lengths): the device's idle gaps in the window,
    as ``TraceData.breakdown`` cuts them, in time order; ``cum[i]`` sums the
    first ``i`` gaps."""
    mids, cum, prev = [], [0], trace.window[0]
    for s, e in trace.busy_intervals() + [[trace.window[1], trace.window[1]]]:
        if s > prev:
            mids.append((s + prev) // 2)
            cum.append(cum[-1] + s - prev)
        prev = max(prev, e)
    return mids, cum


def idle_ns(run, spans: list) -> int:
    """Device idle (ns) whose gap midpoint falls in one of ``spans``
    (which do not overlap one another)."""
    mids, cum = gaps(run.trace)
    total = 0
    for s in spans:
        lo = bisect.bisect_left(mids, s[0])
        hi = bisect.bisect_right(mids, s[1])
        total += cum[hi] - cum[lo]
    return total


def idle_ms_per_step(run, stage: str):
    """Device idle (ms) falling in the program's ``stage`` spans, per
    ``train.step`` span in the window; None where there is none."""
    steps = in_window(run, "train.step")
    if not steps:
        return None
    return idle_ns(run, in_window(run, stage)) / 1e6 / len(steps)
