"""Patch embedding: device time of the kernels launched inside the
benchmark's ``embed_all`` span, K1's left out, per 1,000 frames swept
(device trace)."""

from benchmark.core.kernels import is_k1


def read(run):
    if run.trace is None or not run.counters.get("frames"):
        return None
    if run.trace.kernel_count(span="embed_all") == 0:
        return None
    s = run.trace.kernel_seconds(lambda n: not is_k1(n), span="embed_all")
    return s * 1e3 / (run.counters["frames"] / 1e3)
