"""Fusion head: the device time of its kernels (``fusion_head_roofline
head_kernel``: the f32 GEMMs of the benchmark's ``sweep_table`` spans) over
the traced window (%)."""

from benchmark.metrics.fusion_head_roofline import head_kernel


def read(run):
    if run.trace is None or "batch" not in run.counters:
        return None
    s = run.trace.kernel_seconds(head_kernel, span="sweep_table")
    return 100.0 * s / run.trace.window_s if s > 0 else None
