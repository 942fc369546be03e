"""Conv video model: device time of every other kernel (BatchNorm and
activation passes, layout conversions, K3's window gather) per clip swept
(device trace)."""

from benchmark.core.kernels import is_conv


def read(run):
    if run.trace is None or not run.counters.get("clips"):
        return None
    s = run.trace.kernel_seconds(lambda n: not is_conv(n))
    return s * 1e3 / run.counters["clips"] if s > 0 else None
