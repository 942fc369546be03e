"""The whole train step's share of the chip's bf16 tensor peak: three times
the configuration's forward operations per clip (``counts forward_ops``),
times the clips trained in the traced window, over its length (%)."""


def read(run):
    if run.trace is None or not run.counters.get("clips"):
        return None
    ops = 3.0 * run.counts.forward_ops(run.cfg, run.counters["image_size"]) * run.counters["clips"]
    return 100.0 * ops / (run.trace.window_s * run.peaks.BF16_TENSOR_OPS_PER_S)
