"""Train step: device kernels launched inside the benchmark's
``train_step`` spans per step traced (device trace)."""


def read(run):
    if run.trace is None or not run.counters.get("steps"):
        return None
    n = run.trace.kernel_count(span="train_step")
    return n / run.counters["steps"] if n else None
