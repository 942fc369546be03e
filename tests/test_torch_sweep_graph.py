"""``VideoSweeper``'s window graph: on a GPU the token path replays one
captured CUDA graph per chunk (the temporal transformer, pool, head and
softmax), the raw-frame path and the CPU launch eagerly.

    python -m pytest tests/test_torch_sweep_graph.py -q            # the CPU cases
    python -m pytest tests/test_torch_sweep_graph.py -q -m cuda    # on the GPU machine
"""

import numpy as np
import pytest
import torch

from kstar_torch.config import R2Plus1DConfig, ViViTConfig
from kstar_torch.infer.continuous import (VideoSweeper, chunkify_starts, gather_windows,
                                          table_rows, window_rows)
from kstar_torch.models import build_video_model
from kstar_torch.ops.preprocess import gather_normalize
from kstar_torch.utils import profiling

L, CROP, BATCH = 5, 32, 8
# 5, 20 and 50 windows: 1, 3 and 7 chunks of 8, in chunk buckets 1, 3 and 8,
# each with a padded final chunk
WINDOWS = (5, 20, 50)
MODELS = {
    "ViViT": ViViTConfig(image_size=CROP, patch_size=16, n_frames=L, dim=32, depth=2,
                         n_heads=2, d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0),
    "R2Plus1D": R2Plus1DConfig(image_size=CROP, n_frames=L, layer_sizes=(1, 1, 1, 1)),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _model(name, dtype=torch.float32):
    return build_video_model(name, MODELS[name], dtype=dtype,
                             generator=torch.Generator().manual_seed(0))


def _shots(dev, windows=WINDOWS, seed=0):
    """Frames on ``dev`` for shots of ``windows`` stride-1 windows each,
    with their starts."""
    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.integers(0, 256, (n + L + 1, CROP, CROP, 3),
                                            dtype=np.uint8)).to(dev) for n in windows]
    return frames, [np.arange(n, dtype=np.int64) for n in windows]


def _eager(sw, data, starts):
    """The chunks of ``starts`` through ``chunk_probs``, launched eagerly."""
    chunks = torch.from_numpy(chunkify_starts(starts, BATCH)).to(sw.device)
    return torch.cat([sw.chunk_probs(data, c) for c in chunks]).cpu().numpy()[:len(starts)]


def _n_chunks(starts_list):
    return sum(len(chunkify_starts(s, BATCH)) for s in starts_list)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_cpu_sweep_captures_nothing(name):
    """On the CPU both paths launch eagerly: no capture, no replayed chunk,
    each ``sweep.windows`` span's ``graphed`` 0."""
    sw = VideoSweeper(_model(name), L, CROP, BATCH, torch.float32, device="cpu")
    frames, starts = _shots("cpu")
    with profiling.recording() as rec:
        for f, s in zip(frames, starts):
            assert sw.sweep_device(f, s).shape == (len(s),)
    windows = [r for r in rec if r.name == "sweep.windows"]
    assert [w.attrs["chunks"] for w in windows] == [len(chunkify_starts(s, BATCH))
                                                    for s in starts]
    assert all(w.attrs["graphed"] == 0 for w in windows)
    assert sw.graph_captures == 0 and sw.graphed_chunks == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_rows_read_what_a_clamped_advanced_index_reads(dtype):
    """The one gather (``window_rows`` of the flattened table, read with
    one ``index_select`` in the graphed loop and in ``chunk_probs``) reads
    the windows that a clamp and advanced indexing of the (L, T, D) table
    read, the clamp at the shot's end and the bucket padding included."""
    sw = VideoSweeper(_model("ViViT"), L, CROP, BATCH, DTYPES[dtype], device="cpu")
    T, D = 23, 32
    data = torch.randn(L, T, D).to(DTYPES[dtype])
    chunks = torch.from_numpy(chunkify_starts(np.arange(T - 2), BATCH))
    rows = window_rows(data, chunks, sw._offsets)
    assert rows.shape == (len(chunks), BATCH * L)
    off = torch.arange(L)[None, :]
    for c, r in zip(chunks, rows):
        idx = torch.clamp(c[:, None] + sw._offsets[None, :], 0, T - 1)
        want = data[off, idx]
        got = torch.index_select(table_rows(data), 0, r).view(BATCH, L, D)
        assert torch.equal(got, want)
        assert torch.equal(gather_windows(data, c, sw._offsets), want)
        assert torch.equal(sw.chunk_probs(data, c), sw._window_probs(want))


# ---------------------------------------------------------------------------
# GPU
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_graphed_sweep_matches_eager(dev, dtype):
    """Three shots in three chunk buckets, each ending in a padded chunk:
    one capture, then replays, and the probabilities of the eager path to
    the bit; every chunk replayed and counted in its span."""
    dt = DTYPES[dtype]
    sw = VideoSweeper(_model("ViViT", dt), L, CROP, BATCH, dt, device=dev)
    frames, starts = _shots(dev)
    with profiling.recording() as rec:
        for f, s in zip(frames, starts):
            data = sw.embed_all(f)
            got = sw.sweep_table(data, s)
            np.testing.assert_array_equal(got, _eager(sw, data, s))
    assert sw.graph_captures == 1
    assert sw.graphed_chunks == _n_chunks(starts)
    windows = [r for r in rec if r.name == "sweep.windows"]
    assert [w.attrs["graphed"] for w in windows] == [w.attrs["chunks"] for w in windows]


@pytest.mark.cuda
def test_graph_follows_a_weight_changed_in_place(dev):
    """A weight updated in place between two sweeps is read by the next
    replay, without a second capture."""
    model = _model("ViViT")
    sw = VideoSweeper(model, L, CROP, BATCH, torch.float32, device=dev)
    (f,), (s,) = _shots(dev, windows=(20,))
    before = sw.sweep_device(f, s)
    with torch.no_grad():
        model.mlp_fc2.bias.add_(torch.tensor([2.0, -2.0], device=dev))
    data = sw.embed_all(f)
    after = sw.sweep_table(data, s)
    np.testing.assert_array_equal(after, _eager(sw, data, s))
    assert np.all(after > before)
    assert sw.graph_captures == 1


@pytest.mark.cuda
def test_new_parameter_storage_recaptures(dev):
    """A parameter given new storage is captured again, and the replays
    read it."""
    model = _model("ViViT")
    sw = VideoSweeper(model, L, CROP, BATCH, torch.float32, device=dev)
    (f,), (s,) = _shots(dev, windows=(20,))
    sw.sweep_device(f, s)
    model.mlp_fc2.weight.data = model.mlp_fc2.weight.data * 1.5
    data = sw.embed_all(f)
    np.testing.assert_array_equal(sw.sweep_table(data, s), _eager(sw, data, s))
    assert sw.graph_captures == 2
    assert sw.graphed_chunks == 2 * _n_chunks([s])


@pytest.mark.cuda
def test_raw_frame_path_stays_eager(dev):
    """R(2+1)D's raw windows: no capture, ``graphed`` 0 in every span, and
    the window-gather kernel launched once a chunk swept."""
    sw = VideoSweeper(_model("R2Plus1D", torch.bfloat16), L, CROP, BATCH, torch.bfloat16,
                      device=dev)
    frames, starts = _shots(dev)
    before = gather_normalize.launches
    with profiling.recording() as rec:
        for f, s in zip(frames, starts):
            sw.sweep_device(f, s)
    assert gather_normalize.launches - before == _n_chunks(starts)
    assert sw.graph_captures == 0 and sw.graphed_chunks == 0
    assert all(r.attrs["graphed"] == 0 for r in rec if r.name == "sweep.windows")
