"""kstar_torch's multimodal sweep against kstar_tpu's, on the CPU, and the
video sweep's tri-state choice of the spatial-cls table.

* ``multimodal_ladders`` equals JAX's exactly, the clamp of ``ts_idx_end``
  included;
* ``MultiModalSweeper`` and ``predict_multimodal_shot`` equal JAX's at
  1e-5 (f32, the same flax weights) at tau 1 and tau 2: JAX on the CPU
  takes its scan over ``spatial_cls``, the port the plain table;
* the raw-frame branch (a model without ``spatial_cls``) equals the table
  branch;
* ``sweep_multimodal_prob_curves`` -> ``score_alarms`` rows equal JAX's;
* ``use_fused_table``: ``None`` at N = 257 tokens takes the plain table and
  says so, ``True`` raises, ``False`` takes the plain table, decided from
  the shape alone; the table's widths come from the video encoder (a TFN
  caps its ViViT's width at 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from kstar_torch.data import Scaler, VideoStore
from kstar_torch.data.synthetic import make_dataset
from kstar_torch.eval import alarms as ta
from kstar_torch.infer import continuous as tc
from kstar_torch.models import TFN as TTFN
from kstar_torch.models import TFNGB as TTFNGB
from kstar_torch.models import MultiModalConcat as TMultiModalConcat
from kstar_torch.models.vivit import ViViT
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.data import Scaler as JScaler
from kstar_tpu.data import VideoStore as JVideoStore
from kstar_tpu.eval import alarms as ja
from kstar_tpu.infer import continuous as jc
from kstar_tpu.models import TFNGB, MultiModalConcat

L, PX, F = 5, 32, 18
DT = 1.0 / 210.0
VIVIT_KW = dict(image_size=PX, patch_size=8, n_frames=L, dim=32, depth=1, n_heads=2,
                d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0)
TS_KW = dict(n_features=F, feature_dims=32, max_len=L, n_layers=1, n_heads=4,
             dim_feedforward=64, dropout=0.0, cls_dims=16, noise_std=0.0)
MODELS = {"concat": (MultiModalConcat, TMultiModalConcat),
          "TFN_GB": (TFNGB, TTFNGB)}
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(name, seed=0):
    jcls, tcls = MODELS[name]
    jm = jcls(vivit_kwargs=dict(VIVIT_KW), ts_kwargs=dict(TS_KW))
    x_v = np.zeros((1, L, PX, PX, 3), np.float32)
    x_t = np.zeros((1, L, F), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.key(seed), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, jnp.asarray(x_v), jnp.asarray(x_t)))
    params, stats = variables["params"], variables.get("batch_stats", {})
    tm = tcls(dict(VIVIT_KW), dict(TS_KW))
    tm.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jm, params, stats, tm


@pytest.fixture(scope="module")
def library():
    """Three synthetic disruptive shots (64 px, 256 frames) with a 0D table
    at 1/210 s, and both packages' scalers fitted on it."""
    shots, disrupt_df, ts_df = make_dataset(n_shots=3, n_frames=256, dt=DT, seed=3)
    arrays = {s.shot: s.frames for s in shots}
    cols = [c for c in ts_df.columns if c not in ("shot", "time")][:F]
    values = ts_df[cols].to_numpy(np.float32)
    return (arrays, disrupt_df, ts_df, cols, Scaler("Robust").fit(values),
            JScaler("Robust").fit(values))


def test_ladders_match_jax_with_the_clamp():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(50, 400))
        times = np.sort(rng.uniform(0.0, 2.0, n))
        t_srt = float(rng.uniform(0.0, 0.5))
        # t_end past the last sample: no row lies beyond it, so the
        # reference's end index is len(times) and must be clamped
        t_end = float(rng.choice([rng.uniform(1.0, 1.9), 5.0]))
        frame_srt, frame_end = int(rng.integers(0, 40)), int(rng.integers(60, 400))
        tau = int(rng.integers(1, 3))
        args = (times, frame_srt, frame_end, t_srt, t_end, 5, DT, tau)
        got, want = tc.multimodal_ladders(*args), jc.multimodal_ladders(*args)
        assert got == want
        assert max(got[1], default=0) <= n - 1


def _shot(library, shot):
    arrays, disrupt_df, ts_df, cols, scaler, jscaler = library
    r = disrupt_df[disrupt_df.shot == shot].iloc[0]
    d = ts_df[ts_df.shot == shot]
    return (arrays[shot], d[cols].to_numpy(np.float32), d["time"].to_numpy(), r,
            scaler, jscaler)


@pytest.mark.parametrize("name,tau", [("concat", 1), ("concat", 2), ("TFN_GB", 1)])
def test_sweeper_and_predict_shot_match_jax(name, tau, library):
    jm, params, stats, tm = _pair(name)
    shot = sorted(library[0])[0]
    frames, values, times, r, scaler, jscaler = _shot(library, shot)
    kw = dict(seq_len=L, dist=3, dt=DT, tau=tau, crop_size=PX, batch_size=16)
    args = (frames, values, times)
    meta = (int(r.frame_startup), int(r.frame_cutoff), float(r.tftsrt), float(r.tipminf))
    jx, jp = jc.predict_multimodal_shot(jm, params, stats, *args, jscaler, *meta,
                                        compute_dtype=jnp.float32, **kw)
    sweeper = tc.MultiModalSweeper(tm, L, tau, PX, 16, torch.float32, device="cpu")
    tx, tp = tc.predict_multimodal_shot(tm, *args, scaler, *meta, sweeper=sweeper, **kw)
    assert len(tx) == len(tp) == len(jp) > 0
    np.testing.assert_allclose(tx, jx, **TOL)
    np.testing.assert_allclose(tp, jp, **TOL)
    # the raw sweep of the window probabilities themselves
    data = scaler.transform(values)
    vk, tk = tc.multimodal_ladders(times, *meta, L, DT, tau)
    jsw = jc.MultiModalSweeper(jm, params, stats, L, tau, PX, 16, jnp.float32)
    np.testing.assert_allclose(sweeper.sweep(frames, data, vk, tk),
                               jsw.sweep(frames, jscaler.transform(values), vk, tk), **TOL)


class PixelsOnly(torch.nn.Module):
    """A fusion model without the spatial-cls fast path."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x_video, x_0d):
        return self.inner(x_video, x_0d)


@pytest.mark.parametrize("name", list(MODELS))
def test_raw_frame_branch_equals_the_table_branch(name, library):
    _, _, _, tm = _pair(name, seed=1)
    shot = sorted(library[0])[1]
    frames, values, times, r, scaler, _ = _shot(library, shot)
    data = scaler.transform(values)
    vk, tk = tc.multimodal_ladders(times, int(r.frame_startup), int(r.frame_cutoff),
                                   float(r.tftsrt), float(r.tipminf), L, DT, 1)
    fast = tc.MultiModalSweeper(tm, L, 1, PX, 16, torch.float32, device="cpu")
    raw = tc.MultiModalSweeper(PixelsOnly(tm), L, 1, PX, 16, torch.float32, device="cpu")
    assert not raw.fused_table_active
    np.testing.assert_allclose(raw.sweep(frames, data, vk, tk),
                               fast.sweep(frames, data, vk, tk), **TOL)


def test_alarm_rows_match_jax(library):
    arrays, disrupt_df, ts_df, cols, scaler, jscaler = library
    jm, params, stats, tm = _pair("concat", seed=2)
    shots = sorted(arrays)
    kw = dict(seq_len=L, dist=3, dt=DT, tau=1, crop_size=PX, batch_size=16)
    want = ja.sweep_multimodal_prob_curves(
        jm, params, stats, JVideoStore.from_arrays(arrays), ts_df, disrupt_df, shots,
        cols, jscaler, compute_dtype=jnp.float32, **kw)
    got = ta.sweep_multimodal_prob_curves(
        tm, VideoStore.from_arrays(arrays), ts_df, disrupt_df, shots, cols, scaler,
        compute_dtype=torch.float32, device="cpu", **kw)
    assert [c[0] for c in got] == [c[0] for c in want] == shots
    for (_, _, tx, tp), (_, _, jx, jp) in zip(got, want):
        np.testing.assert_allclose(tx, jx, **TOL)
        np.testing.assert_allclose(tp, jp, **TOL)
    thr = float(np.median(np.concatenate([c[3] for c in want])))
    g, w = ta.score_alarms(got, thr), ja.score_alarms(want, thr)
    assert g["summary"] == w["summary"]
    # the rows' flags and alarm times are equal; max_prob holds the curves' 1e-5
    pd.testing.assert_frame_equal(g["per_shot"], w["per_shot"], check_exact=False,
                                  rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        ta.threshold_tradeoff_from_curves(got).to_numpy(),
        ja.threshold_tradeoff_from_curves(want).to_numpy())


def _n257_vivit():
    """ViViT at patch 4 over a 64 px crop: 16 x 16 patches + cls = 257
    tokens, more than the spatial-table kernel takes (N <= 128)."""
    return ViViT(image_size=64, patch_size=4, n_frames=L, dim=32, depth=1, n_heads=2,
                 d_head=16, scale_dim=2, generator=torch.Generator().manual_seed(0))


def test_video_sweep_is_tri_state():
    model = _n257_vivit()
    frames = np.random.default_rng(0).integers(0, 255, (24, 64, 64, 3), dtype=np.uint8)
    starts = np.arange(24 - L - 1)
    plain = tc.VideoSweeper(model, L, 64, 8, torch.float32, use_fused_table=None,
                            device="cpu")
    assert plain.fused_table_active is False
    forced_off = tc.VideoSweeper(model, L, 64, 8, torch.float32, use_fused_table=False,
                                 device="cpu")
    assert forced_off.fused_table_active is False
    np.testing.assert_array_equal(plain.sweep(frames, starts), forced_off.sweep(frames, starts))
    with pytest.raises(ValueError, match="N <= 128"):
        tc.VideoSweeper(model, L, 64, 8, torch.float32, use_fused_table=True, device="cpu")
    # at patch 16 the same widths take the kernel's route (its wrapper runs
    # the plain version on the CPU)
    small = tc.VideoSweeper(model, L, 16, 8, torch.float32, device="cpu")
    assert small.fused_table_active is True


def test_multimodal_sweep_is_tri_state_and_reads_the_encoder():
    kw257 = dict(VIVIT_KW, image_size=64, patch_size=4)
    tm = TMultiModalConcat(kw257, dict(TS_KW))
    assert tc.MultiModalSweeper(tm, L, 1, 64, 8, torch.float32,
                                device="cpu").fused_table_active is False
    with pytest.raises(ValueError, match="not supported"):
        tc.MultiModalSweeper(tm, L, 1, 64, 8, torch.float32, use_fused_table=True,
                             device="cpu")
    # a TFN caps its ViViT at 128 wide: the table is built at the encoder's
    # width, not the kwargs'
    wide = dict(VIVIT_KW, dim=144)
    tfn = TTFN(wide, dict(TS_KW))
    assert tc.video_encoder(tfn).dim == 128
    sweeper = tc.MultiModalSweeper(tfn, L, 1, PX, 8, torch.float32, device="cpu")
    assert sweeper.fused_table_active is True
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (40, PX, PX, 3), dtype=np.uint8)
    data = rng.normal(size=(40, F)).astype(np.float32)
    vk = tk = list(range(12, 30))
    raw = tc.MultiModalSweeper(PixelsOnly(tfn), L, 1, PX, 8, torch.float32, device="cpu")
    np.testing.assert_allclose(sweeper.sweep(frames, data, vk, tk),
                               raw.sweep(frames, data, vk, tk), **TOL)
