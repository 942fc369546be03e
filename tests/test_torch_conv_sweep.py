"""The conv video models through the port's sweep and stream, against
kstar_tpu's on the CPU at f32 (atol 1e-5 + rtol 1e-5 on probabilities).

R(2+1)D at 21-frame windows and SlowFast at 20 (its seq_len, a multiple of
alpha = 4), the small widths of ``test_torch_models_conv.py`` over 32 px
crops of 48 px frames. These models have no spatial-cls table, so every
sweep and stream takes the raw-frame path: the window gather
(``ops/preprocess.py gather_normalize``, its plain version on the CPU) and
the whole forward per chunk or block. ``sweep_shots``' memory-budgeted
groups give the per-shot sweeps' curves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.infer import continuous as tc
from kstar_torch.infer import streaming as ts
from kstar_torch.utils.profiling import recording
from kstar_tpu.infer import continuous as jc
from kstar_tpu.infer import streaming as js
from test_torch_models_conv import clips, conv_pair

IMG, CROP, BATCH = 48, 32, 8
SEQ = {"R2Plus1D": 21, "SlowFast": 20}
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pairs():
    x = clips()
    frames = np.random.default_rng(5).integers(0, 256, size=(52, IMG, IMG, 3), dtype=np.uint8)
    frames[30:] //= 2                      # a darker tail, so the curve moves
    return frames, {key: conv_pair(key, x, seed=3) for key in SEQ}


@pytest.mark.parametrize("key", list(SEQ))
def test_sweep_matches_jax(key, pairs):
    frames, models = pairs
    jm, v, tm = models[key]
    L = SEQ[key]
    starts = np.arange(len(frames) - L - 1)
    want = jc.VideoSweeper(jm, v["params"], v["batch_stats"], L, CROP, batch_size=BATCH,
                           compute_dtype=jnp.float32).sweep(frames, starts)
    sweeper = tc.VideoSweeper(tm, L, CROP, batch_size=BATCH, compute_dtype=torch.float32,
                              device="cpu")
    assert not sweeper._use_tokens and not sweeper.fused_table_active
    got = sweeper.sweep(frames, starts)
    assert got.shape == want.shape == (len(starts),)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.ptp(want) > 1e-3
    dev = sweeper.upload_shot(frames)
    np.testing.assert_allclose(sweeper.sweep_device(dev, starts), want, **TOL)


@pytest.mark.parametrize("key", list(SEQ))
def test_predict_video_shot_matches_jax(key, pairs):
    frames, models = pairs
    jm, v, tm = models[key]
    L = SEQ[key]
    args = dict(frame_srt=2, frame_end=36, seq_len=L, dist=3, crop_size=CROP,
                batch_size=BATCH, fps=10.0)
    tx_j, p_j = jc.predict_video_shot(jm, v["params"], v["batch_stats"], frames,
                                      compute_dtype=jnp.float32, **args)
    tx_t, p_t = tc.predict_video_shot(tm, frames, compute_dtype=torch.float32,
                                      device="cpu", **args)
    np.testing.assert_array_equal(tx_t, tx_j)
    np.testing.assert_allclose(p_t, p_j, **TOL)
    n_windows = (36 + 10 - 2) - L - 3                     # frames[2:46] minus L + dist
    assert len(p_t) == L + 2 + n_windows - 2


@pytest.mark.parametrize("key", list(SEQ))
def test_stream_blocks_match_jax(key, pairs):
    frames, models = pairs
    jm, v, tm = models[key]
    kw = dict(seq_len=SEQ[key], crop_size=CROP, fps=10.0, suppress_s=0.5, block_size=6)
    jp = js.StreamingPredictor(jm, v["params"], v["batch_stats"], compute_dtype=jnp.float32,
                               **kw)
    tp = ts.StreamingPredictor(tm, compute_dtype=torch.float32, device="cpu", **kw)
    want, got = [], []
    for i in range(0, 36, 6):
        want.append(jp.push_block(frames[i:i + 6]))
        got.append(tp.push_block(frames[i:i + 6]))
    want_p, got_p = (np.concatenate([o[0] for o in out]) for out in (want, got))
    np.testing.assert_allclose(got_p, want_p, **TOL)
    # single pushes give the blocks' probabilities
    one = ts.StreamingPredictor(tm, compute_dtype=torch.float32, device="cpu",
                                **{**kw, "block_size": 1})
    single = np.array([one.push(f)[0] for f in frames[:36]])
    np.testing.assert_allclose(single, got_p, **TOL)


@pytest.mark.parametrize("key", list(SEQ))
def test_sweep_shots_groups_match_single_sweeps(key, pairs):
    frames, models = pairs
    _, _, tm = models[key]
    L = SEQ[key]
    sweeper = tc.VideoSweeper(tm, L, CROP, batch_size=BATCH, compute_dtype=torch.float32,
                              device="cpu")
    shots = [frames[:40], frames[3:52], frames[10:45]]
    starts = [np.arange(len(s) - L - 1) for s in shots]
    # room for two 64-frame buckets per group: the three shots take two groups
    budget = 2 * 64 * CROP * CROP * 3
    with recording() as rec:
        got = sweeper.sweep_shots(shots, starts, hbm_budget_bytes=budget)
    assert [sp.attrs["frames"][0] for sp in rec if sp.name == "library.h2d"] == [2, 1]
    for shot, st, p in zip(shots, starts, got):
        np.testing.assert_allclose(p, sweeper.sweep(shot, st), **TOL)
