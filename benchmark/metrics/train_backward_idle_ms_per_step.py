"""Train step: the device's idle time whose gap midpoint falls in one of the
program's ``train.backward`` spans, per ``train.step`` span in the traced
window (device trace)."""

from benchmark.core.program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, "train.backward")
