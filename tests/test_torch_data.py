"""kstar_torch's data layer against kstar_tpu's on the CPU: the numpy/pandas
copies (windows, splits, synthetic, dataset, loader) give identical arrays,
labels and DataFrames from one seed; the loader's producer thread keeps its
two guarantees; the native window gather equals numpy indexing exactly."""

import shutil
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from kstar_torch.data import dataset as TD
from kstar_torch.data import loader as TL
from kstar_torch.data import native as TN
from kstar_torch.data import splits as TS
from kstar_torch.data import synthetic as TY
from kstar_torch.data import windows as TW
from kstar_tpu.config import Schema
from kstar_tpu.data import dataset as JD
from kstar_tpu.data import loader as JL
from kstar_tpu.data import splits as JS
from kstar_tpu.data import synthetic as JY
from kstar_tpu.data import windows as JW

KW = dict(n_shots=5, n_frames=160, height=32, width=32, seed=3, difficulty=0.5,
          n_normal=2, n_eval_disrupt=1, n_eval_normal=1)


@pytest.fixture(scope="module")
def data():
    return TY.make_dataset(**KW), JY.make_dataset(**KW)


def _eq_windows(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for f in ("shot", "starts", "labels", "video_starts", "ts_starts"):
        if hasattr(b, f):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_synthetic_dataset_identical(data):
    (ts_shots, t_df, t_ts), (js_shots, j_df, j_ts) = data
    pd.testing.assert_frame_equal(t_df, j_df)
    pd.testing.assert_frame_equal(t_ts, j_ts)
    for a, b in zip(ts_shots, js_shots):
        np.testing.assert_array_equal(a.frames, b.frames)
        pd.testing.assert_frame_equal(a.ts, b.ts)
        assert (a.shot, a.frame_startup, a.frame_cutoff, a.is_disrupt, a.lead_s) == \
            (b.shot, b.frame_startup, b.frame_cutoff, b.is_disrupt, b.lead_s)


@pytest.mark.parametrize("seq_len,dist", [(21, 3), (5, 1), (10, 0)])
def test_window_labelling_identical(data, seq_len, dist):
    (shots, df, _), _ = data
    for s in shots:
        row = df[df.shot == s.shot].iloc[0]
        times = s.ts.time.to_numpy()
        if s.is_disrupt:
            _eq_windows(TW.video_windows(s.shot, s.frame_startup, s.frame_tipminf, seq_len, dist),
                        JW.video_windows(s.shot, s.frame_startup, s.frame_tipminf, seq_len, dist))
            _eq_windows(TW.ts_windows(s.shot, times, s.tftsrt, s.tipminf, seq_len, dist),
                        JW.ts_windows(s.shot, times, s.tftsrt, s.tipminf, seq_len, dist))
            for mode in ("reference", "aligned"):
                args = (s.shot, times, s.tftsrt, s.tipminf, s.frame_startup,
                        s.frame_tipminf, len(s.frames), seq_len, dist)
                _eq_windows(TW.multimodal_windows(*args, pair_mode=mode),
                            JW.multimodal_windows(*args, pair_mode=mode))
        else:
            _eq_windows(TW.video_windows_normal(s.shot, s.frame_startup, s.frame_cutoff, seq_len),
                        JW.video_windows_normal(s.shot, s.frame_startup, s.frame_cutoff, seq_len))
            _eq_windows(TW.ts_windows_normal(s.shot, times, float(row.tftsrt), seq_len),
                        JW.ts_windows_normal(s.shot, times, float(row.tftsrt), seq_len))
            args = (s.shot, times, s.tftsrt, s.frame_startup, s.frame_cutoff, seq_len)
            _eq_windows(TW.multimodal_windows_normal(*args), JW.multimodal_windows_normal(*args))
    starts = np.array([0, 4, 9], np.int64)
    data2d = np.arange(60, dtype=np.float32).reshape(30, 2)
    np.testing.assert_array_equal(TW.gather_ts(data2d, starts, 5, 2), JW.gather_ts(data2d, starts, 5, 2))
    np.testing.assert_array_equal(TW.video_frame_indices(starts, seq_len),
                                  JW.video_frame_indices(starts, seq_len))
    np.testing.assert_array_equal(TW.multimodal_video_frame_indices(starts, seq_len, 2),
                                  JW.multimodal_video_frame_indices(starts, seq_len, 2))
    np.testing.assert_array_equal(TW.class_counts(np.array([0, 1, 1])),
                                  JW.class_counts(np.array([0, 1, 1])))


def test_splits_and_scalers_identical(data):
    (_, _, ts), _ = data
    shots = list(range(100, 131))
    assert TS.deterministic_split(shots, 0.2) == JS.deterministic_split(shots, 0.2)
    assert TS.split_shots(shots + [21310]) == JS.split_shots(shots + [21310])
    assert TS.random_split_shots(shots, seed=7) == JS.random_split_shots(shots, seed=7)
    cols = Schema.INPUT_FEATURES
    x = ts[cols].to_numpy()
    for kind in ("Robust", "Standard", "MinMax"):
        a, b = TS.Scaler(kind).fit(x), JS.Scaler(kind).fit(x)
        np.testing.assert_array_equal(a.transform(x), b.transform(x))
        np.testing.assert_array_equal(TS.Scaler.from_state(a.state_dict()).transform(x),
                                      b.transform(x))
    got, want = TS.prepare_0d_dataset(ts, cols, test_shot=None), \
        JS.prepare_0d_dataset(ts, cols, test_shot=None)
    for g, w in zip(got[:3], want[:3]):
        pd.testing.assert_frame_equal(g, w)
    np.testing.assert_array_equal(got[3].center_, want[3].center_)


@pytest.mark.parametrize("include_normal", [False, True])
def test_datasets_identical(data, include_normal):
    (t_shots, df, ts), (j_shots, _, _) = data
    cols = Schema.INPUT_FEATURES
    t_store = TD.VideoStore.from_arrays({s.shot: s.frames for s in t_shots})
    j_store = JD.VideoStore.from_arrays({s.shot: s.frames for s in j_shots})
    shots = sorted(t_store.arrays)
    pairs = [
        (TD.VideoDataset(t_store, df, shots, seq_len=7, include_normal=include_normal),
         JD.VideoDataset(j_store, df, shots, seq_len=7, include_normal=include_normal)),
        (TD.TSDataset(ts, df, cols, seq_len=7, include_normal=include_normal),
         JD.TSDataset(ts, df, cols, seq_len=7, include_normal=include_normal)),
        (TD.MultiModalDataset(t_store, ts, df, cols, shots, seq_len=7, dt=4.0 / 210.0,
                              include_normal=include_normal),
         JD.MultiModalDataset(j_store, ts, df, cols, shots, seq_len=7, dt=4.0 / 210.0,
                              include_normal=include_normal)),
    ]
    for a, b in pairs:
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.shot_ids, b.shot_ids)
        np.testing.assert_array_equal(a.class_counts(), b.class_counts())
        idx = np.random.default_rng(0).integers(0, len(a), size=9)
        (xa, ya), (xb, yb) = a.batch(idx), b.batch(idx)
        np.testing.assert_array_equal(ya, yb)
        for k in (xb.keys() if isinstance(xb, dict) else [None]):
            np.testing.assert_array_equal(xa if k is None else xa[k],
                                          xb if k is None else xb[k])
    assert TD.filter_valid_shots(ts, cols, shots) == JD.filter_valid_shots(ts, cols, shots)


def test_batch_orders_identical(data):
    labels = np.array([0] * 5 + [1] * 40)
    for n, bs in ((45, 8), (5, 8), (0, 4)):
        for kw in (dict(shuffle=True), dict(shuffle=False), dict(drop_last=False)):
            a = list(TL.epoch_batches(n, bs, np.random.default_rng(1), **kw))
            b = list(JL.epoch_batches(n, bs, np.random.default_rng(1), **kw))
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    ta, ja = TL.ImbalancedSampler(labels), JL.ImbalancedSampler(labels)
    np.testing.assert_array_equal(ta.sample(np.random.default_rng(2)),
                                  ja.sample(np.random.default_rng(2)))
    a = list(TL.epoch_batches(45, 8, np.random.default_rng(3), sampler=ta))
    b = list(JL.epoch_batches(45, 8, np.random.default_rng(3), sampler=ja))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for (ia, ma), (ib, mb) in zip(TL.eval_batches(45, 8), JL.eval_batches(45, 8)):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)


def test_threaded_and_grouped_batches_identical(data):
    (t_shots, df, _), (j_shots, _, _) = data
    mk = lambda D, sh: D.VideoDataset(D.VideoStore.from_arrays(
        {s.shot: s.frames for s in sh}), df, [s.shot for s in sh], seq_len=5)
    a, b = mk(TD, t_shots), mk(JD, j_shots)
    idx = list(TL.epoch_batches(len(a), 4, np.random.default_rng(0)))
    for (xa, ya), (xb, yb) in zip(TL.threaded_batches(a, idx), JL.threaded_batches(b, idx)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    got = list(TL.grouped_batches(a, idx, 3))
    want = list(JL.grouped_batches(b, idx, 3))
    assert [k for k, _ in got] == [k for k, _ in want] and got[0][0] == "stack"
    for (_, (xa, ya)), (_, (xb, yb)) in zip(got, want):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    # the put hook turns a (batch, labels) pair into tensors
    x, y = TL.to_device(a.batch(idx[0]), "cpu")
    assert x.dtype == torch.uint8 and torch.equal(y, torch.as_tensor(a.labels[idx[0]]))


def test_relay_reraises_producer_error_after_its_items():
    def body(send, stop):
        send(1)
        send(2)
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for item in TL._relay(body, depth=1):
            got.append(item)
    assert got == [1, 2]


def test_relay_abandoned_consumer_stops_producer():
    done = threading.Event()

    def body(send, stop):
        try:
            i = 0
            while send(i):          # forever, until the consumer goes away
                i += 1
        finally:
            done.set()

    gen = TL._relay(body, depth=2)
    assert [next(gen), next(gen)] == [0, 1]
    t0 = time.monotonic()
    gen.close()                     # the consumer abandons the epoch
    assert done.wait(timeout=5.0), "producer still parked on a full queue"
    assert time.monotonic() - t0 < 5.0


def test_native_gather_equals_numpy_indexing(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(50, 12, 9, 3), dtype=np.uint8)
    idx = rng.integers(-5, 60, size=(7, 11))
    want = frames[np.clip(idx, 0, 49)]
    if shutil.which("g++"):
        assert TN.get_lib() is not None
        assert TN.target().parent.name == "kstar_torch" and TN.target().exists()
    np.testing.assert_array_equal(TN.gather_windows_u8(frames, idx), want)
    np.testing.assert_array_equal(TN.gather_windows_u8(frames, idx, n_threads=3), want)
    mm = np.lib.format.open_memmap(tmp_path / "f.npy", mode="w+", dtype=np.uint8,
                                   shape=frames.shape)
    mm[:] = frames
    np.testing.assert_array_equal(TN.gather_windows_u8(mm, idx), want)
    store = TD.VideoStore.from_arrays({7: frames})
    np.testing.assert_array_equal(store.gather(7, idx), want)
    # the numpy fallback gives the same bytes
    monkeypatch.setattr(TN, "get_lib", lambda: None)
    np.testing.assert_array_equal(TN.gather_windows_u8(frames, idx), want)
    with pytest.raises(ValueError, match="uint8"):
        TN.gather_windows_u8(frames.astype(np.int16), idx)
