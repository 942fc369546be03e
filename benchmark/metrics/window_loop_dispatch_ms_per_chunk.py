"""Window loop: host wall of the program's ``sweep.chunk`` spans over their
count, the time the host takes to launch one chunk's kernels, with no wait
for K1 in it (program span, in the traced run)."""

from benchmark.core.program_spans import in_window


def read(run):
    spans = in_window(run, "sweep.chunk")
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(spans)
