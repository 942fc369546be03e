"""K1's share of its roofline: the least time the H100 could build the
traced shots' spatial-cls tables in (``counts table_ops``, operations at the
bf16 tensor peak or bytes at HBM bandwidth, the larger), over K1's device
time in the trace (%)."""

from benchmark.core.kernels import is_k1


def read(run):
    if run.trace is None:
        return None
    k1 = run.trace.kernel_seconds(is_k1)
    if k1 <= 0:
        return None
    img = run.counters["image_size"]
    bound = sum(run.peaks.bound_s(*run.counts.table_ops(run.cfg, img, t))
                for t in run.counters["shots"])
    return 100.0 * bound / k1
