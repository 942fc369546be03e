"""The port's span recorder (``kstar_torch.utils.profiling``): off and free
of clock reads outside a profiler session, the sweep's and the train step's
spans inside one, and their clock against the profiler's own events.

    python -m pytest tests/test_torch_tracing.py -q
    python -m pytest tests/test_torch_tracing.py -q -m cuda   # on the GPU machine
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kstar_torch.config import LossConfig, OptimConfig, R2Plus1DConfig, ViViTConfig
from kstar_torch.infer.continuous import VideoSweeper, chunkify_starts
from kstar_torch.models import build_video_model
from kstar_torch.train import create_train_state, make_train_step
from kstar_torch.utils import profiling

L, CROP, BATCH = 6, 32, 4
MODELS = {
    "ViViT": ViViTConfig(image_size=CROP, patch_size=8, n_frames=L, dim=32, depth=1,
                         n_heads=2, d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0),
    "R2Plus1D": R2Plus1DConfig(image_size=CROP, n_frames=L, layer_sizes=(1, 1, 1, 1)),
}


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _model(name):
    return build_video_model(name, MODELS[name], dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0))


def _shots(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (n, CROP, CROP, 3), dtype=np.uint8))
            for n in lengths]


def _no_clock(monkeypatch):
    def refuse():
        raise AssertionError("a span read the clock with recording off")

    monkeypatch.setattr(profiling.time, "time_ns", refuse)


def test_span_is_the_shared_no_op_outside_a_profiler(monkeypatch):
    _no_clock(monkeypatch)
    sp = profiling.span("sweep.windows", shot=1)
    assert sp is profiling.NO_SPAN and profiling.span("other") is sp
    with sp as inner:
        inner.set(dispatched=8)
    assert profiling.spans() == []


@pytest.mark.parametrize("name", list(MODELS))
def test_untraced_sweep_and_step_read_no_clock(monkeypatch, name):
    """The program's spans cost no clock read off the profiler: a sweep and
    a train step run with the clock refused."""
    _no_clock(monkeypatch)
    sweeper = VideoSweeper(_model(name), L, CROP, BATCH, torch.float32, device="cpu")
    (frames,) = _shots([20])
    assert sweeper.sweep_device(frames, np.arange(10)).shape == (10,)
    if name == "ViViT":
        state = create_train_state(_model(name), OptimConfig(), steps_per_epoch=1)
        step = make_train_step(LossConfig())
        step(state, torch.zeros(2, L, CROP, CROP, 3), torch.tensor([0, 1]), torch.ones(2),
             torch.tensor([0.3, 0.5]))
    assert profiling.spans() == []


@pytest.mark.parametrize("name", list(MODELS))
def test_sweep_records_its_spans(name):
    """Two shots through ``embed_all`` and ``sweep_table``: ViViT's embed
    and table spans (the conv models have neither), one ``sweep.windows``
    per shot with ``chunkify_starts``'s counts (none of them replayed as a
    graph on the CPU), one ``sweep.chunk`` per chunk row under it, all with
    the sweeper's shot number."""
    sweeper = VideoSweeper(_model(name), L, CROP, BATCH, torch.float32, device="cpu")
    shots = _shots([30, 17])
    starts = [np.arange(len(f) - L - 1) for f in shots]
    with profile(activities=[ProfilerActivity.CPU]):
        for frames, st in zip(shots, starts):
            sweeper.sweep_table(sweeper.embed_all(frames), st)
    rec = profiling.spans()
    tokens = name == "ViViT"
    for shot, (frames, st) in enumerate(zip(shots, starts), start=1):
        mine = [s for s in rec if s.attrs.get("shot") == shot]
        chunks = chunkify_starts(st, BATCH)
        names = [s.name for s in mine]
        want = (["sweep.embed", "sweep.table"] if tokens else []) + (
            ["sweep.chunk"] * len(chunks) + ["sweep.windows"])
        assert names == want
        windows = mine[-1]
        assert windows.parent is None and windows.attrs == {
            "shot": shot, "windows": len(st), "dispatched": chunks.size,
            "chunks": len(chunks), "graphed": 0}
        assert all(s.parent == "sweep.windows" and windows.start_ns <= s.start_ns
                   and s.end_ns <= windows.end_ns for s in mine if s.name == "sweep.chunk")
        if tokens:
            assert mine[0].attrs == {"shot": shot, "frames": len(frames)}
            assert mine[1].attrs == {"shot": shot, "fused": sweeper.fused_table_active}
            assert mine[0].parent is None and mine[1].parent is None
            assert mine[0].end_ns <= mine[1].start_ns <= mine[1].end_ns <= windows.start_ns


def test_library_sweep_nests_the_sweep_spans():
    """``sweep_shots`` sweeps in ``library.sweep``: the shots' chunks are its
    children; the group's upload carries its bytes."""
    sweeper = VideoSweeper(_model("ViViT"), L, CROP, BATCH, torch.float32, device="cpu")
    shots = [f.numpy() for f in _shots([30, 17])]
    with profiling.recording() as rec:
        sweeper.sweep_shots(shots, [np.arange(len(f) - L - 1) for f in shots])
    (h2d,) = [s for s in rec if s.name == "library.h2d"]
    # frames to the 32-frame bucket; 6 chunks, the 23-window shot's bucket
    assert h2d.attrs["frames"] == (2, 32, CROP, CROP, 3) and h2d.attrs["chunks"] == (2, 6, BATCH)
    assert h2d.attrs["bytes"] == 2 * 32 * CROP * CROP * 3 + 8 * 2 * 6 * BATCH
    inner = [s for s in rec if s.name.startswith("sweep.")]
    assert {s.parent for s in inner} == {"library.sweep"}
    assert sorted({s.attrs["shot"] for s in inner}) == [1, 2]


def test_train_step_records_its_stages():
    state = create_train_state(_model("ViViT"), OptimConfig(), steps_per_epoch=1)
    step = make_train_step(LossConfig())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 2, L, CROP, CROP, 3))
                         .astype(np.float32))
    aux = (torch.ones(2), torch.tensor([0.3, 0.5]))
    step(state, x[0], torch.tensor([0, 1]), *aux)                 # draws 0, unrecorded
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, x[1], torch.tensor([1, 0]), *aux)
    rec = profiling.spans()
    assert [s.name for s in rec] == ["train.forward", "train.backward", "train.update",
                                     "train.step"]
    assert all(s.attrs == {"step": 1} for s in rec[:-1]) and state.draws == 2
    # on the CPU the step launches eagerly: nothing captured or replayed
    assert rec[-1].attrs == {"step": 1, "graphed": 0}
    assert step.graph_captures == step.graphed_steps == 0 and step.graph_of(state) is None
    outer = rec[-1]
    assert outer.parent is None and all(s.parent == "train.step" for s in rec[:-1])
    for a, b in zip(rec[:-1], rec[1:-1]):
        assert a.end_ns <= b.start_ns
    assert outer.start_ns <= rec[0].start_ns and rec[2].end_ns <= outer.end_ns


def test_parents_are_per_thread():
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            t = threading.Thread(target=lambda: seen.append(profiling.span("other").__enter__()
                                                            .parent))
            t.start()
            t.join(timeout=10)
            with profiling.span("inner") as sp:
                sp.set(n=3)
    assert not t.is_alive() and seen == [None]
    inner, outer = profiling.spans("inner")[0], profiling.spans("outer")[0]
    assert inner.parent == "outer" and inner.attrs == {"n": 3} and outer.parent is None


def test_span_holds_the_op_it_brackets_on_the_profilers_clock():
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            x @ x
    (sp,) = profiling.spans("mm")
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert sp.start_ns <= mm.start_ns() <= mm.end_ns() <= sp.end_ns


def test_recording_gives_the_spans_closed_inside_it():
    with profiling.recording() as rec:
        with profiling.span("a"):
            pass
    with profiling.span("b"):                       # off again: not recorded
        pass
    assert [s.name for s in rec] == ["a"] and [s.name for s in profiling.spans()] == ["a"]


@pytest.mark.cuda
def test_device_activity_alone_turns_recording_on():
    """Under ``activities=[CUDA]`` alone (the benchmark's traced runs) the
    spans record, and a span holds the launch call of a kernel launched in
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the GPU machine)")
    x = torch.randn(512, 512, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("mm"):
            x @ x
        torch.cuda.synchronize()
    (sp,) = profiling.spans("mm")
    launches = [e for e in prof.profiler.kineto_results.events()
                if e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                "cuLaunchKernelEx")]
    assert launches and any(sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns
                            for e in launches)
