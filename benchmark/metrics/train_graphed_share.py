"""Train step: the share of the program's ``train.step`` spans in the traced
window that replayed the step's captured CUDA graph (their ``graphed``
attribute 1), over all of them (%, program span). None where the program
records no such span, or spans without the attribute."""

from benchmark.core.program_spans import in_window


def read(run):
    steps = in_window(run, "train.step")
    if not steps or any("graphed" not in s.attrs for s in steps):
        return None
    return 100.0 * sum(s.attrs["graphed"] for s in steps) / len(steps)
