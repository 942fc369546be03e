"""Conv video model: the share of the conv epilogues (BatchNorm, LeakyReLU,
cast and residual join of a conv output) that ran as one kernel pass: the
``fused_epilogues`` over the ``epilogues`` of the program's ``sweep.chunk``
spans in the traced window (%, program counter). None where no span carries
them (a program without the counters, or a window of graphed chunks)."""

from benchmark.core.program_spans import in_window


def read(run):
    spans = [s for s in in_window(run, "sweep.chunk") if "epilogues" in s.attrs]
    total = sum(s.attrs["epilogues"] for s in spans)
    if not total:
        return None
    return 100.0 * sum(s.attrs["fused_epilogues"] for s in spans) / total
