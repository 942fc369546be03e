"""Window loop: device kernels launched inside the benchmark's
``sweep_table`` spans per window chunk of the traced shots (device trace)."""


def read(run):
    if run.trace is None or not run.counters.get("chunks"):
        return None
    n = run.trace.kernel_count(span="sweep_table")
    return n / run.counters["chunks"] if n else None
