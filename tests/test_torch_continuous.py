"""kstar_torch continuous sweep against the kstar_tpu sweep on shared
weights (f32, CPU), and the numpy helpers against their JAX-package
originals on random inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch import resolve_device
from kstar_torch.data.augment import center_crop
from kstar_torch.infer import StreamingPredictor
from kstar_torch.infer import continuous as tc
from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.infer import continuous as jc
from kstar_tpu.models.vivit import ViViT as JaxViViT

SEQ_LEN, IMG, CROP = 5, 48, 32
KW = dict(image_size=CROP, patch_size=16, n_frames=SEQ_LEN, dim=32, depth=2,
          n_heads=2, d_head=16, scale_dim=2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    jm = JaxViViT(dtype=jnp.float32, **KW)
    key = jax.random.key(0)
    variables = jm.init({"params": key, "dropout": key},
                        jnp.zeros((1, SEQ_LEN, CROP, CROP, 3)), train=False)
    tm = TorchViViT(**KW)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    frames = np.random.default_rng(0).integers(0, 255, size=(40, IMG, IMG, 3),
                                               dtype=np.uint8)
    return jm, variables, tm, frames


class PixelsOnly(torch.nn.Module):
    """A video model without the ViViT token path: the sweeper gathers raw
    windows for it."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x)


def test_sweep_matches_jax(models):
    jm, variables, tm, frames = models
    starts = np.arange(len(frames) - SEQ_LEN - 1)
    want = jc.VideoSweeper(jm, variables["params"], {}, SEQ_LEN, CROP, batch_size=8,
                           compute_dtype=jnp.float32).sweep(frames, starts)
    sweeper = tc.VideoSweeper(tm, SEQ_LEN, CROP, batch_size=8,
                              compute_dtype=torch.float32, device="cpu")
    got = sweeper.sweep(frames, starts)
    assert got.shape == want.shape == (len(starts),)
    np.testing.assert_allclose(got, want, **TOL)
    # the shot stays loaded; sweep_device re-runs the preprocessing
    np.testing.assert_allclose(sweeper.sweep(None, starts[:7]), want[:7], **TOL)
    dev = sweeper.upload_shot(frames)
    np.testing.assert_allclose(sweeper.sweep_device(dev, starts), want, **TOL)
    assert sweeper.sweep_device(dev, starts[:0]).shape == (0,)


def test_raw_pixel_path_matches_token_path(models):
    _, _, tm, frames = models
    starts = np.arange(12)
    raw = tc.VideoSweeper(PixelsOnly(tm), SEQ_LEN, CROP, batch_size=8,
                          compute_dtype=torch.float32, device="cpu")
    assert not raw._use_tokens
    tok = tc.VideoSweeper(tm, SEQ_LEN, CROP, batch_size=8,
                          compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(raw.sweep(frames, starts), tok.sweep(frames, starts), **TOL)


def test_plain_table_option_matches_default(models):
    _, _, tm, frames = models
    starts = np.arange(9)
    a = tc.VideoSweeper(tm, SEQ_LEN, CROP, 8, torch.float32, device="cpu")
    b = tc.VideoSweeper(tm, SEQ_LEN, CROP, 8, torch.float32, use_fused_table=False,
                        device="cpu")
    np.testing.assert_array_equal(a.sweep(frames, starts), b.sweep(frames, starts))


def test_predict_video_shot_matches_jax(models):
    jm, variables, tm, frames = models
    # fps 10: the reference window covers frame_end + fps frames and the
    # startup suppression spans fps samples
    args = dict(frame_srt=3, frame_end=20, seq_len=SEQ_LEN, dist=3, crop_size=CROP,
                batch_size=8, fps=10.0)
    tx_j, p_j = jc.predict_video_shot(jm, variables["params"], {}, frames,
                                      compute_dtype=jnp.float32, **args)
    tx_t, p_t = tc.predict_video_shot(tm, frames, compute_dtype=torch.float32,
                                      device="cpu", **args)
    np.testing.assert_array_equal(tx_t, tx_j)
    np.testing.assert_allclose(p_t, p_j, **TOL)
    n_windows = (20 + 10 - 3) - SEQ_LEN - 3            # frames[3:30] minus L + dist
    assert len(p_t) == SEQ_LEN + 3 + n_windows - 2
    assert not p_t[:SEQ_LEN + 3].any()


def test_entry_points_default_to_the_gpu(models):
    _, _, tm, frames = models
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tc.VideoSweeper(tm, SEQ_LEN, CROP)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tc.predict_video_shot(tm, frames, 0, 10, SEQ_LEN, crop_size=CROP)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("shape", [(37, 53), (53, 37), (CROP, 45)], ids=str)
@pytest.mark.parametrize("entry", ["video_sweeper", "multimodal_sweeper", "streaming"])
def test_host_crops_are_center_crop(entry, shape):
    """``VideoSweeper.upload_shot``, ``MultiModalSweeper.upload_shot`` and
    ``StreamingPredictor``'s block prep crop frames of odd H != W, and a
    wide frame with H == crop < W, exactly as ``center_crop`` does."""
    frames = np.random.default_rng(4).integers(0, 256, size=(4, *shape, 3), dtype=np.uint8)
    model = torch.nn.Identity()
    if entry == "video_sweeper":
        got = tc.VideoSweeper(model, SEQ_LEN, CROP, device="cpu").upload_shot(frames)
    elif entry == "multimodal_sweeper":
        sw = tc.MultiModalSweeper(model, SEQ_LEN, crop_size=CROP, device="cpu")
        got = sw.upload_shot(frames, np.zeros((4, 18), np.float32))[0]   # 4 frames: no padding
    else:
        got = StreamingPredictor(model, SEQ_LEN, CROP, device="cpu")._prep(frames)
    np.testing.assert_array_equal(got.numpy(), center_crop(frames, CROP))


def test_bucket_and_chunks_match_jax():
    for n in list(range(0, 300)) + [1000, 4073, 4074, 65537]:
        assert tc.bucket_len(n) == jc.bucket_len(n), n
    rng = np.random.default_rng(1)
    for n, b in ((0, 8), (5, 8), (37, 8), (4074, 128)):
        starts = rng.integers(0, 5000, size=n)
        np.testing.assert_array_equal(tc.chunkify_starts(starts, b),
                                      np.asarray(jc.chunkify_starts(starts, b)))


@pytest.mark.parametrize("method,k", [("backward", 12), ("center", 16), ("backward", 1)])
def test_moving_average_matches_jax(method, k):
    x = np.random.default_rng(2).random(500) * 1.4 - 0.2
    np.testing.assert_array_equal(tc.moving_average(x, k, method),
                                  jc.moving_average(x, k, method))
    assert tc.moving_average(np.zeros(0), k, method).shape == (0,)


def test_startup_suppression_matches_jax():
    p = np.random.default_rng(3).random(400).astype(np.float32)
    for n in (0, 10, 210, 1000):
        np.testing.assert_array_equal(tc.startup_suppression(p, n),
                                      jc.startup_suppression(p, n))


@pytest.mark.parametrize("dwell", [0.0, 0.01, 0.05, 0.5, 10.0])
def test_alarm_and_warning_times_match_jax(dwell):
    rng = np.random.default_rng(4)
    t = np.arange(600) / 210.0
    for _ in range(20):
        p = np.clip(rng.random(600) * rng.random() * 1.3, 0, 1)
        a, b = tc.alarm_times(t, p, 0.5, 1.0, dwell), jc.alarm_times(t, p, 0.5, 1.0, dwell)
        assert a == b
        assert tc.warning_time(a, 2.5) == jc.warning_time(b, 2.5)
    assert tc.alarm_times(t[:1], np.ones(1), t_min=0.0, min_dwell_s=0.1) is None
