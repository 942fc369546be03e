"""Window loop: the share of the windows dispatched that are real, the rest
the padding ``chunkify_starts`` adds to fill a shot's bucket of chunks:
the ``windows`` over the ``dispatched`` of the program's ``sweep.windows``
spans in the traced window (%). One reader for ``window_useful_share.sweep``
and ``.conv_sweep``, each moving its own cell's throughput."""

from benchmark.core.program_spans import in_window


def read(run):
    spans = in_window(run, "sweep.windows")
    dispatched = sum(s.attrs["dispatched"] for s in spans)
    if not dispatched:
        return None
    return 100.0 * sum(s.attrs["windows"] for s in spans) / dispatched
