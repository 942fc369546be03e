"""Window loop: host wall of the benchmark's ``sweep_table`` spans, each
ending in the probabilities' copy to the host, from the later of the span's
start and the end of K1's kernel queued before it (the loop's kernels wait
behind K1 on the stream), per window chunk (host clock, in the traced run)."""

import bisect

from benchmark.core.kernels import is_k1


def read(run):
    if run.trace is None or not run.counters.get("chunks"):
        return None
    k1_ends = sorted(e for s, e, n, _ in run.trace.kernels if is_k1(n))
    wall = 0
    for start, end, name in run.trace.spans:
        if name != "sweep_table":
            continue
        i = bisect.bisect_right(k1_ends, end) - 1
        wall += end - max(start, k1_ends[i] if i >= 0 else start)
    return wall / 1e6 / run.counters["chunks"] if wall else None
