"""The share of the traced window in which no kernel or copy ran on the
device: one minus the union of their intervals over the window (%). One
reader for ``device_idle_share.sweep``, ``.conv_sweep`` and ``.train``, each
moving its own cell's throughput."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
