"""Window loop: the device's idle time whose gap midpoint falls in one of the
program's ``sweep.windows`` spans, over the chunks those spans dispatched
(device trace)."""

from benchmark.core.program_spans import idle_ns, in_window


def read(run):
    spans = in_window(run, "sweep.windows")
    chunks = sum(s.attrs["chunks"] for s in spans)
    if not chunks:
        return None
    return idle_ns(run, spans) / 1e6 / chunks
