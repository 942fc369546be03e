"""kstar_torch.data.augment against kstar_tpu.data.augment on the CPU.

The random draws are made with ``jax.random`` exactly as ``_augment_clip``
makes them and fed to the port's ``apply_augment``; the augmented clips
must equal JAX's at atol 1e-4 (the tolerance of tests/test_augment_infer.py;
the only difference is the blur's summation order). Eval preprocessing
(crop, mean, cast) is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import AugmentConfig
from kstar_torch.data import augment as TA
from kstar_torch.data.device_pipe import DevicePreprocessor
from kstar_tpu.config import AugmentConfig as JAugmentConfig
from kstar_tpu.data import augment as JA

B, T, H, W = 6, 3, 32, 40


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_params(key, cfg) -> np.ndarray:
    """The ten draws of one clip, as ``_augment_clip`` makes them, in the
    port's column order."""
    k = jax.random.split(key, 12)
    u = lambda i, lo=0.0, hi=1.0: float(jax.random.uniform(k[i], (), minval=lo, maxval=hi))
    return np.array([
        np.floor(u(0, -cfg.bright_val, cfg.bright_val)), u(1),
        u(2, cfg.contrast_min, cfg.contrast_max), u(3), u(4), u(5),
        u(6, -cfg.vertical_ratio, cfg.vertical_ratio), u(7),
        u(8, -cfg.horizontal_ratio, cfg.horizontal_ratio), u(9)], np.float32)


def _clips(seed):
    return np.random.default_rng(seed).uniform(0, 255, size=(B, T, H, W, 3)).astype(np.float32)


CASES = {
    "all_on": dict(bright_p=1.0, contrast_p=1.0, blur_p=1.0, flip_p=1.0,
                   vertical_p=1.0, horizontal_p=1.0, contrast_max=1.6,
                   vertical_ratio=0.3, horizontal_ratio=0.3),
    "half": dict(bright_p=0.5, contrast_p=0.5, blur_p=0.5, flip_p=0.5,
                 vertical_p=0.5, horizontal_p=0.5, vertical_ratio=0.2,
                 horizontal_ratio=0.2),
    "defaults": {},
    "all_off": dict(bright_p=0.0, contrast_p=0.0, blur_p=0.0, flip_p=0.0,
                    vertical_p=0.0, horizontal_p=0.0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_augment_on_jax_draws_matches_augment_clip(case, seed):
    cfg_t, cfg_j = AugmentConfig(**CASES[case]), JAugmentConfig(**CASES[case])
    clips = _clips(seed)
    keys = jax.random.split(jax.random.key(seed), B)
    want = np.asarray(jax.vmap(lambda k, c: JA._augment_clip(k, c, cfg_j))(
        keys, jnp.asarray(clips)))
    params = np.stack([_jax_params(k, cfg_j) for k in keys])
    got = TA.apply_augment(torch.as_tensor(clips), torch.as_tensor(params), cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if case == "all_off":
        np.testing.assert_array_equal(got, clips)


def test_blur_matches_jax_blur_clip():
    clip = _clips(3)[0]
    want = np.asarray(JA._blur_clip(jnp.asarray(clip), 5))
    got = TA.blur(torch.as_tensor(clip), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(TA.gaussian_kernel1d(7), JA._gaussian_kernel1d(7))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("crop", [32, 17])
def test_eval_preprocess_is_exact(crop, out_dtype):
    video = np.random.default_rng(4).integers(0, 256, size=(B, T, 37, 45, 3), dtype=np.uint8)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(JA.preprocess_pure(None, jnp.asarray(video), crop, JAugmentConfig(),
                                         train=False, out_dtype=jdt).astype(jnp.float32))
    got = TA.preprocess(torch.as_tensor(video), crop, train=False, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (B, T, crop, crop, 3)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(TA.center_crop(torch.as_tensor(video), crop).numpy(),
                                  np.asarray(JA.center_crop(jnp.asarray(video), crop)))


def test_augment_params_ranges_and_determinism():
    cfg = AugmentConfig(contrast_max=1.5)
    g = torch.Generator().manual_seed(0)
    p = TA.augment_params(g, 4096, cfg)
    assert p.shape == (4096, TA.N_PARAMS) and p.dtype == torch.float32
    bright = p[:, TA.BRIGHT]
    assert torch.equal(bright, bright.floor())
    assert bright.min() >= -cfg.bright_val and bright.max() <= cfg.bright_val - 1
    assert p[:, TA.ALPHA].min() >= 1.0 and p[:, TA.ALPHA].max() < 1.5
    for col, r in ((TA.V_RATIO, cfg.vertical_ratio), (TA.H_RATIO, cfg.horizontal_ratio)):
        assert p[:, col].abs().max() <= r
    for col in (TA.BRIGHT_U, TA.CONTRAST_U, TA.BLUR_U, TA.FLIP_U, TA.V_U, TA.H_U):
        assert 0.0 <= float(p[:, col].min()) and float(p[:, col].max()) < 1.0
    assert torch.equal(TA.augment_params(torch.Generator().manual_seed(0), 4096, cfg), p)


def test_train_preprocess_is_crop_augment_normalize():
    video = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, size=(B, T, 36, 36, 3), dtype=np.uint8))
    cfg = AugmentConfig(**CASES["half"])
    got = TA.preprocess(video, 32, cfg, train=True, generator=torch.Generator().manual_seed(3))
    params = TA.augment_params(torch.Generator().manual_seed(3), B, cfg)
    want = TA.apply_augment(TA.center_crop(video, 32).float(), params, cfg) \
        - torch.tensor([90.0, 98.0, 102.0])
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        TA.preprocess(video, 32, cfg, train=True)


def test_pre_fns_and_device_preprocessor():
    video = np.random.default_rng(6).integers(0, 256, size=(B, T, 36, 36, 3), dtype=np.uint8)
    ts = np.random.default_rng(7).normal(size=(B, T, 4)).astype(np.float32)
    labels = np.arange(B) % 2
    pre_train, pre_eval = TA.make_pre_fns(32, out_dtype=torch.float32)
    out = pre_eval(None, {"video": torch.as_tensor(video), "0D": torch.as_tensor(ts)})
    assert torch.equal(out["0D"], torch.as_tensor(ts))
    assert torch.equal(out["video"], TA.preprocess(torch.as_tensor(video), 32, train=False))
    x, y = DevicePreprocessor(32, train=False, out_dtype=torch.float32, device="cpu")(
        (video, labels))
    assert torch.equal(x, out["video"]) and torch.equal(y, torch.as_tensor(labels))
    a = DevicePreprocessor(32, train=True, seed=1, device="cpu")((video, labels))[0]
    b = DevicePreprocessor(32, train=True, seed=1, device="cpu")((video, labels))[0]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
