"""kstar_torch library sweep and alarm scoring against kstar_tpu's (f32,
CPU): ``sweep_shots`` on ragged shots with bridged ViViT weights, its
grouping under a small memory budget, ``sweep_prob_curves`` over a stub
store, and the scoring and trade-off functions on the same seeded curves
and shot rows."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax import linen as nn

from kstar_torch.eval import alarms as ta
from kstar_torch.infer import continuous as tc
from kstar_torch.infer import latency as tl
from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.utils.profiling import recording
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.eval import alarms as ja
from kstar_tpu.infer import continuous as jc
from kstar_tpu.models.vivit import ViViT as JaxViViT

SEQ_LEN, IMG, CROP = 5, 40, 32
KW = dict(image_size=CROP, patch_size=16, n_frames=SEQ_LEN, dim=32, depth=1,
          n_heads=2, d_head=16, scale_dim=2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class JaxBrightness(nn.Module):
    """p_disrupt rises with the window's mean brightness."""

    @nn.compact
    def __call__(self, x, train=False):
        m = (x.astype(jnp.float32).mean(axis=(1, 2, 3, 4)) + 25.0) / 8.0
        return jnp.stack([m, -m], axis=-1)


class TorchBrightness(torch.nn.Module):
    def forward(self, x):
        m = (x.float().mean(dim=(1, 2, 3, 4)) + 25.0) / 8.0
        return torch.stack([m, -m], dim=-1)


def _shots(lengths, size, seed):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 255, size=(n, size, size, 3), dtype=np.uint8)
              for n in lengths]
    starts = [np.arange(max(n - SEQ_LEN - 1, 0), dtype=np.int64) for n in lengths]
    return frames, starts


@pytest.fixture(scope="module")
def vivit_pair():
    jm = JaxViViT(dtype=jnp.float32, **KW)
    key = jax.random.key(0)
    variables = jm.init({"params": key, "dropout": key},
                        jnp.zeros((1, SEQ_LEN, CROP, CROP, 3)), train=False)
    tm = TorchViViT(**KW)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jm, variables["params"], tm


# ---- sweep_shots ----

def test_sweep_shots_matches_jax_and_per_shot_sweeps(vivit_pair):
    jm, params, tm = vivit_pair
    frames, starts = _shots([23, 40, 31, 52, 17], IMG, seed=0)
    want = jc.VideoSweeper(jm, params, {}, SEQ_LEN, CROP, batch_size=8,
                           compute_dtype=jnp.float32).sweep_shots(frames, starts)
    sweeper = tc.VideoSweeper(tm, SEQ_LEN, CROP, batch_size=8,
                              compute_dtype=torch.float32, device="cpu")
    got = sweeper.sweep_shots(frames, starts)
    # three groups (2, 2, 1 shots): one bucket of 64 frames is 196,608 bytes
    tight = sweeper.sweep_shots(frames, starts, hbm_budget_bytes=2 * 196_608 + 1)
    assert len(got) == len(tight) == len(frames)
    for f, s, w, g, t in zip(frames, starts, want, got, tight):
        assert g.shape == t.shape == (len(s),)
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, sweeper.sweep(f, s), **TOL)
        np.testing.assert_allclose(t, g, **TOL)


LENGTHS = [33, 12, 47, 20, 25, 16, 41, 10, 30, 45, 14, 22, 36, 18, 27]
GROUPING = {
    # budget in shots of the largest bucket -> [(shots in the stack, frame bucket)]
    "one-group": (100, [(16, 48)]),             # 15 shots + 1 repeat of the last
    "eight": (8, [(8, 32), (8, 48)]),           # 8, then 7 + 1 repeat
    "four": (4, [(4, 16), (4, 32), (4, 40), (3, 48)]),
    "one": (1, [(1, tc.bucket_len(n)) for n in sorted(LENGTHS)]),
}


@pytest.mark.parametrize("budget_shots,groups", GROUPING.values(), ids=GROUPING.keys())
def test_sweep_shots_groups_under_a_budget(budget_shots, groups):
    """Ascending-length packing, a fixed group size, half-octave frame and
    chunk buckets, the last shot repeated to the group's bucket; results in
    input order whatever the grouping."""
    frames, starts = _shots(LENGTHS, 8, seed=1)
    sweeper = tc.VideoSweeper(TorchBrightness(), SEQ_LEN, 8, batch_size=8,
                              compute_dtype=torch.float32, device="cpu")
    item = 8 * 8 * 3 * tc.bucket_len(max(LENGTHS))
    with recording() as rec:
        got = sweeper.sweep_shots(frames, starts, hbm_budget_bytes=budget_shots * item)
    for f, s, g in zip(frames, starts, got):
        np.testing.assert_allclose(g, sweeper.sweep(f, s), **TOL)
    h2d = [sp for sp in rec if sp.name == "library.h2d"]
    shapes = [(sp.attrs["frames"], sp.attrs["chunks"]) for sp in h2d]
    assert [(f[0], f[1]) for f, _ in shapes] == groups
    for f_shape, c_shape in shapes:
        assert f_shape[2:] == (8, 8, 3) and c_shape[0] == f_shape[0] and c_shape[2] == 8
        # enough chunks for the longest shot the frame bucket can hold, bucketed
        assert c_shape[1] == tc.bucket_len(c_shape[1])
    for sp, (f, c) in zip(h2d, shapes):
        assert sp.attrs["bytes"] == int(np.prod(f)) + 8 * int(np.prod(c))
    # each group: prep, upload and sweep, one after another, each taking time
    phases = [sp for sp in rec if sp.name.startswith("library.")]
    assert [sp.name for sp in phases] == ["library.prep", "library.h2d",
                                          "library.sweep"] * len(groups)
    assert all(sp.end_ns > sp.start_ns and sp.parent is None for sp in phases)
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))


def test_sweep_shots_edge_cases():
    sweeper = tc.VideoSweeper(TorchBrightness(), SEQ_LEN, 8, batch_size=8,
                              compute_dtype=torch.float32, device="cpu")
    assert sweeper.sweep_shots([], []) == []
    assert sweeper._hbm_budget_bytes() == 4 << 30
    frames, starts = _shots([4, 30], 8, seed=2)        # the first has no window
    got = sweeper.sweep_shots(frames, starts)
    assert got[0].shape == (0,) and got[1].shape == (24,)


# ---- sweep_prob_curves and the entry points above it ----

class StubStore:
    """What the sweep reads of a VideoStore: membership and ``arrays``."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __contains__(self, shot):
        return shot in self.arrays


@pytest.fixture(scope="module")
def library():
    """Five dark 12x12 shots, with a bright flash before the quench of the
    disruptive ones; shot 9 has no metadata and shot 555 no frames."""
    rng = np.random.default_rng(3)
    arrays, rows = {}, []
    for i, (n, disrupt) in enumerate([(300, True), (420, True), (360, False),
                                      (280, True), (330, False)]):
        f = rng.integers(20, 70, size=(n, 12, 12, 3), dtype=np.uint8)
        if disrupt:
            f[n - 40 - 10 * i:n - 20] = 230
        elif i == 2:
            f[250:256] = 230                      # a brief spike on a normal shot
        arrays[100 + i] = f
        rows.append({"shot": 100 + i, "frame_startup": 5 + i, "frame_cutoff": n - 215,
                     "tftsrt": 0.1, "tipminf": (n - 20) / 210.0 if disrupt else np.nan,
                     "is_disrupt": disrupt})
    arrays[9] = arrays[100][:250]
    return StubStore(arrays), pd.DataFrame(rows), [100, 101, 9, 102, 103, 104, 555]


SWEEP_KW = dict(seq_len=SEQ_LEN, dist=3, crop_size=8, batch_size=16)


@pytest.fixture(scope="module")
def curves_pair(library):
    store, df, shots = library
    want = ja.sweep_prob_curves(JaxBrightness(), {}, {}, store, df, shots,
                                compute_dtype=jnp.float32, **SWEEP_KW)
    got = ta.sweep_prob_curves(TorchBrightness(), store, df, shots,
                               compute_dtype=torch.float32, device="cpu", **SWEEP_KW)
    return want, got


def test_sweep_prob_curves_matches_jax(curves_pair):
    want, got = curves_pair
    assert [c[0] for c in got] == [c[0] for c in want] == [100, 101, 102, 103, 104]
    for (_, rw, tw, pw), (_, rg, tg, pg) in zip(want, got):
        assert rg.equals(rw)
        np.testing.assert_array_equal(tg, tw)
        np.testing.assert_allclose(pg, pw, **TOL)
        assert pg.max() > 0.9 or not rg.is_disrupt    # the flash is seen


def _assert_frames_equal(got, want, atol=1e-12):
    """Equal frames; ``atol`` 1e-5 where a column (max_prob) carries swept
    probabilities, which the two packages compute to that tolerance."""
    pd.testing.assert_frame_equal(got, want, check_dtype=False, check_exact=False,
                                  rtol=0, atol=atol)


@pytest.mark.parametrize("thr,t_min,dwell", [(0.5, 0.2, 0.0), (0.9, 0.2, 0.02),
                                            (0.5, 1.0, 0.1), (0.3, 0.0, 0.0)])
def test_score_alarms_on_swept_curves_matches_jax(curves_pair, thr, t_min, dwell):
    want_curves, got_curves = curves_pair
    want = ja.score_alarms(want_curves, thr, t_min, dwell)
    got = ta.score_alarms(got_curves, thr, t_min, dwell)
    _assert_frames_equal(got["per_shot"], want["per_shot"], atol=1e-5)
    assert got["summary"] == want["summary"]
    assert got["summary"]["n_disrupt"] == 3 and got["summary"]["n_normal"] == 2


def test_evaluate_and_threshold_sweep_match_jax(library):
    store, df, shots = library
    kw = dict(t_min=0.2, min_dwell_s=0.02, **SWEEP_KW)
    want = ja.evaluate_video_alarms(JaxBrightness(), {}, {}, store, df, shots,
                                    threshold=0.6, compute_dtype=jnp.float32, **kw)
    got = ta.evaluate_video_alarms(TorchBrightness(), store, df, shots, threshold=0.6,
                                   compute_dtype=torch.float32, device="cpu", **kw)
    _assert_frames_equal(got["per_shot"], want["per_shot"], atol=1e-5)
    assert got["summary"] == want["summary"]
    assert got["summary"]["detected"] >= 2
    thresholds = (0.3, 0.6, 0.9)
    _assert_frames_equal(
        ta.threshold_sweep(TorchBrightness(), store, df, shots, thresholds,
                           compute_dtype=torch.float32, device="cpu", **kw),
        ja.threshold_sweep(JaxBrightness(), {}, {}, store, df, shots, thresholds,
                           compute_dtype=jnp.float32, **kw))


def test_nothing_to_sweep_returns_no_curves(library):
    store, df, _ = library
    assert ta.sweep_prob_curves(TorchBrightness(), store, df, [9, 555],
                                device="cpu", **SWEEP_KW) == []


# ---- scoring on seeded curves and made-up rows ----

@pytest.fixture(scope="module")
def seeded_curves():
    """Twelve noisy 100 Hz curves: disruptive shots ramp up before their
    quench (some fire early), normal shots carry short spikes."""
    rng = np.random.default_rng(5)
    curves = []
    for i in range(12):
        n = int(rng.integers(500, 900))
        t = np.arange(n) / 100.0
        p = rng.random(n).astype(np.float32) * 0.35
        disrupt = i % 3 != 2
        if disrupt:
            onset = int(rng.integers(120, n - 50))
            p[onset:] += np.linspace(0.1, 0.6, n - onset, dtype=np.float32)
            row = types.SimpleNamespace(tipminf=(n - 10) / 100.0, tftsrt=float(rng.random()),
                                        is_disrupt=True)
        else:
            for a in rng.integers(110, n - 30, size=3):
                p[a:a + int(rng.integers(2, 25))] = 0.97
            row = types.SimpleNamespace(tipminf=float("nan"), tftsrt=0.5, is_disrupt=False)
        curves.append((2000 + i, row, t, np.clip(p, 0, 1)))
    return curves


@pytest.mark.parametrize("thr,t_min,dwell", [(0.5, 1.0, 0.0), (0.5, 1.0, 0.1),
                                            (0.7, 0.5, 0.05), (0.95, 1.0, 0.4)])
def test_score_alarms_matches_jax(seeded_curves, thr, t_min, dwell):
    want = ja.score_alarms(seeded_curves, thr, t_min, dwell)
    got = ta.score_alarms(seeded_curves, thr, t_min, dwell)
    _assert_frames_equal(got["per_shot"], want["per_shot"])
    assert got["summary"] == want["summary"]
    rows, summary = ta.score_alarm_rows(seeded_curves, thr, t_min, dwell)
    assert summary == got["summary"] and len(rows) == 12
    for (_, _, t, p), row in zip(seeded_curves, rows):
        assert row["t_alarm"] == jc.alarm_times(t, p, thr, t_min, dwell)


TRADEOFFS = {
    "threshold": ("threshold_tradeoff_from_curves",
                  dict(thresholds=(0.3, 0.5, 0.8), t_min=0.5, min_dwell_s=0.05)),
    "threshold-defaults": ("threshold_tradeoff_from_curves", {}),
    "dwell": ("dwell_tradeoff_from_curves", dict(dwells=(0.0, 0.03, 0.2), threshold=0.6)),
    "dwell-defaults": ("dwell_tradeoff_from_curves", {}),
    "grid": ("operating_grid_from_curves", dict(thresholds=(0.4, 0.9), dwells=(0.0, 0.1))),
    "grid-defaults": ("operating_grid_from_curves", {}),
}


@pytest.mark.parametrize("name,kw", TRADEOFFS.values(), ids=TRADEOFFS.keys())
def test_tradeoffs_match_jax(seeded_curves, name, kw):
    got, want = getattr(ta, name)(seeded_curves, **kw), getattr(ja, name)(seeded_curves, **kw)
    assert list(got.columns) == list(want.columns)
    _assert_frames_equal(got, want)


def test_empty_and_one_sided_libraries_match_jax(seeded_curves):
    only_normal = [c for c in seeded_curves if not c[1].is_disrupt]
    only_disrupt = [c for c in seeded_curves if c[1].is_disrupt]
    for curves in (only_normal, only_disrupt, []):
        assert ta.score_alarms(curves)["summary"] == ja.score_alarms(curves)["summary"]


# ---- entry points and the latency harness ----

def test_entry_points_default_to_the_gpu(library):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    store, df, shots = library
    for call in (lambda: ta.sweep_prob_curves(TorchBrightness(), store, df, shots, **SWEEP_KW),
                 lambda: ta.evaluate_video_alarms(TorchBrightness(), store, df, shots,
                                                  **SWEEP_KW),
                 lambda: ta.threshold_sweep(TorchBrightness(), store, df, shots, **SWEEP_KW),
                 lambda: tl.measure_model(TorchBrightness(), (torch.zeros(2, 5, 8, 8, 3),))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_latency_harness_counts_and_keys():
    calls = []
    stats = tl.measure_forward(lambda x: calls.append(x.shape), (torch.zeros(3, 2),),
                               n_samples=5, warmup=2)
    assert len(calls) == 7
    assert set(stats) == {"mean_s", "std_s", "p50_s", "p99_s"}
    assert 0 < stats["p50_s"] <= stats["p99_s"]
    stats = tl.measure_model(TorchBrightness(), (torch.zeros(4, 5, 8, 8, 3),),
                             n_samples=3, warmup=1, device="cpu")
    assert stats["clips_per_s"] == pytest.approx(4 / stats["mean_s"])
