"""K1's device time over the traced window (%)."""

from benchmark.core.kernels import is_k1


def read(run):
    if run.trace is None:
        return None
    k1 = run.trace.kernel_seconds(is_k1)
    if k1 <= 0:
        return None
    return 100.0 * k1 / run.trace.window_s
