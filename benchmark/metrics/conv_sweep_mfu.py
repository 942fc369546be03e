"""The whole conv sweep's share of the chip's bf16 tensor peak: the
configuration's operations per clip (``counts clip_ops``) times the windows
swept in the traced window, over its length (%)."""


def read(run):
    if run.trace is None or not run.counters.get("clips"):
        return None
    ops = run.counts.clip_ops(run.cfg, run.counters["image_size"]) * run.counters["clips"]
    return 100.0 * ops / (run.trace.window_s * run.peaks.BF16_TENSOR_OPS_PER_S)
