"""Conv video model: device time of the convolution kernels (cuDNN's, and
the 1x1x1 convolutions and Dense layers as GEMMs; ``core/kernels.py``) per
clip swept (device trace)."""

from benchmark.core.kernels import is_conv


def read(run):
    if run.trace is None or not run.counters.get("clips"):
        return None
    s = run.trace.kernel_seconds(is_conv)
    return s * 1e3 / run.counters["clips"] if s > 0 else None
