"""The readers of the program's own spans (``core/program_spans.py`` and the
metrics on it): on the CPU tiny cells against the sweep loop's own counts, on a
hand-built trace against the gaps laid out by hand, and silent for a
program that records no span.

    python -m pytest benchmark/tests/test_program_spans.py -q
"""

from __future__ import annotations

import types

import pytest

from conftest import TINY, tiny_bench
from test_portbench_harness import run_cell

SPAN_METRICS = ["window_useful_share.sweep", "window_useful_share.conv_sweep",
                "window_loop_dispatch_ms_per_chunk", "window_loop_idle_ms_per_chunk",
                "train_forward_idle_ms_per_step", "train_backward_idle_ms_per_step",
                "train_update_idle_ms_per_step"]
SWEEPS = {"vivit-sweep-256px": "window_useful_share.sweep",
          "r2plus1d-sweep-128px": "window_useful_share.conv_sweep"}


@pytest.mark.parametrize("cell", list(SWEEPS))
def test_useful_share_is_the_loops_clips_over_its_padded_chunks(tmp_path, monkeypatch, cell):
    from benchmark import run

    seen = []
    real = run.per_layer
    monkeypatch.setattr(run, "per_layer", lambda ctx, rec: seen.append(rec) or real(ctx, rec))
    rc, res, err = run_cell(tiny_bench(tmp_path), f"tiny-{cell}", trace=1)
    assert rc == 0 and res["correct"], err
    (rec,) = seen
    c = rec["counters"]
    want = 100.0 * c["clips"] / (c["chunks"] * TINY[cell]["batch"])
    assert res["metrics"][SWEEPS[cell]]["value"] == pytest.approx(want, rel=1e-12)
    if cell == "vivit-sweep-256px":
        assert {"window_loop_dispatch_ms_per_chunk",
                "window_loop_idle_ms_per_chunk"} <= set(res["metrics"])


def test_train_idle_readers_report_in_the_tiny_cell(tmp_path):
    rc, res, err = run_cell(tiny_bench(tmp_path), "tiny-vivit-train-128px", trace=1)
    assert rc == 0 and res["correct"], err
    assert {"train_forward_idle_ms_per_step", "train_backward_idle_ms_per_step",
            "train_update_idle_ms_per_step"} <= set(res["metrics"])


def _span(start, end, name, **attrs):
    from kstar_torch.utils.profiling import SpanRecord

    return SpanRecord(start, end, name, None, attrs)


def _hand_built(monkeypatch, records):
    """A 1,000 ns window with the device busy in [100, 200], [300, 400] and
    [700, 900] (a copy among them): idle gaps of 100 / 100 / 300 / 100 ns at
    midpoints 50 / 250 / 550 / 950; the program's spans ``records``."""
    from benchmark.core.trace import TraceData
    from kstar_torch.utils import profiling

    trace = TraceData(kernels=[(100, 200, "k", None), (700, 900, "k", None)],
                      copies=[(300, 400, "Memcpy HtoD")], window=(0, 1000))
    monkeypatch.setattr(profiling, "spans",
                        lambda name=None: [s for s in records if name in (None, s.name)])
    return types.SimpleNamespace(trace=trace)


def _read(name, run):
    from benchmark.core.spec import Bench

    return Bench().metric(name).read(run)


def test_train_idle_by_stage_on_a_hand_built_trace(monkeypatch):
    run = _hand_built(monkeypatch, [
        _span(0, 260, "train.forward", step=7), _span(260, 600, "train.backward", step=7),
        _span(600, 1000, "train.update", step=7), _span(0, 1000, "train.step", step=7),
        _span(2000, 3000, "train.step", step=8)])                 # outside the window
    got = [_read(f"train_{s}_idle_ms_per_step", run) for s in ("forward", "backward", "update")]
    assert got == pytest.approx([200e-6, 300e-6, 100e-6])
    # the stages cover the step: together they take all the window's idle
    assert sum(got) * 1e6 == pytest.approx(1000 - run.trace.busy_s * 1e9)


def test_window_loop_readers_on_a_hand_built_trace(monkeypatch):
    run = _hand_built(monkeypatch, [
        _span(150, 290, "sweep.chunk", shot=1), _span(290, 580, "sweep.chunk", shot=1),
        _span(150, 600, "sweep.windows", shot=1, windows=200, dispatched=256, chunks=2),
        _span(900, 1000, "sweep.windows", shot=2, windows=30, dispatched=128, chunks=1)])
    # gaps at 250 and 550 in the first, at 950 in the second: 500 ns over 3 chunks
    assert _read("window_loop_idle_ms_per_chunk", run) == pytest.approx(500e-6 / 3)
    assert _read("window_loop_dispatch_ms_per_chunk", run) == pytest.approx(215e-6)
    assert _read("window_useful_share.sweep", run) == pytest.approx(100 * 230 / 384)


def test_readers_are_silent_for_a_program_without_spans(monkeypatch):
    """The parent's program has no recorder: every reader returns None."""
    from benchmark.core.trace import TraceData
    from kstar_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    run = types.SimpleNamespace(trace=TraceData(window=(0, 1000)))
    assert [_read(n, run) for n in SPAN_METRICS] == [None] * len(SPAN_METRICS)
    assert [_read(n, types.SimpleNamespace(trace=None)) for n in SPAN_METRICS] == [None] * 7


def test_every_span_metric_is_in_the_manifest():
    from benchmark.core.spec import Bench

    per_layer = {m["name"]: m for m in Bench().manifest["per_layer"]}
    assert set(SPAN_METRICS) <= set(per_layer)
    assert per_layer["window_useful_share.conv_sweep"]["workloads"] == ["r2plus1d-sweep-128px"]
