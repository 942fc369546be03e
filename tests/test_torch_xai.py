"""kstar_torch.viz.xai against kstar_tpu.viz.xai on shared weights, f32 on
the CPU: the guided-backprop rule, Grad-CAM (R(2+1)D), guided-backprop
saliency (R(2+1)D and SlowFast), attention capture and rollout (ViViT).

The conv models are the tiny twins of ``tests/test_torch_models_conv.py``
(32 px, 8 frames, layer_sizes / layers (1, 1, 1, 1), seeded variables with
every statistic off its zeros/ones start); ViViT the one of
``tests/test_torch_vivit.py`` (flax init carried across). Tolerances: the
rule's gradient exact; the normalised maps (CAM, saliency, rollout) and the
attention maps at atol 1e-5: the two packages compute the same f32
arithmetic and differ only in summation order.

The saliency reference is the body of JAX's ``guided_backprop_saliency``
(``jax.grad`` of the class score inside ``guided_backprop()``, |g| maxed
over channels, normalised per clip) under ``jax.jit``: run eagerly, JAX's
function takes 20 s (R(2+1)D) and 42 s (SlowFast) on the CPU, and it parts
from its own jitted self by 4.4e-4 on 0.6% of R(2+1)D's pixels, where the
rule's ``g > 0`` test meets upstream gradients that are zero up to rounding
and the summation order decides the sign. The port agrees with the jitted
reference to 5e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.models import common as tcommon
from kstar_torch.viz import (collect_attention, gradcam_r2plus1d, guided_backprop,
                             guided_backprop_saliency, rollout,
                             vivit_attention_rollout)
from kstar_tpu.models import common as jcommon
from kstar_tpu.viz import xai as jxai
from test_torch_models_conv import clips, conv_pair
from test_torch_vivit import FRAMES, IMG

TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def video():
    return clips(n=2)


@pytest.fixture(scope="module")
def conv(video):
    return {key: conv_pair(key, video) for key in ("R2Plus1D", "SlowFast")}


@pytest.fixture(scope="module")
def vivit():
    """(flax ViViT, its variables, the port's twin) of
    ``tests/test_torch_vivit.py``'s small configuration, the init jitted."""
    from kstar_torch.models.vivit import ViViT as TorchViViT
    from kstar_torch.weights import state_dict_from_flax
    from kstar_tpu.models.vivit import ViViT as JaxViViT
    from test_torch_vivit import SMALL

    jm = JaxViViT(dtype=jnp.float32, **SMALL)
    key = jax.random.key(0)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda x: jm.init(
        {"params": key, "dropout": key}, x, train=False))(
        jnp.zeros((1, FRAMES, IMG, IMG, 3))))
    tm = TorchViViT(**SMALL).eval()
    tm.load_state_dict(state_dict_from_flax(v["params"]), strict=True)
    return jm, v, tm


def _vivit_clips(seed=0):
    return np.random.default_rng(seed).normal(size=(2, FRAMES, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("alpha", [0.01, 0.0])
def test_guided_rule_matches_jax(alpha):
    """Gradient passes only where input > 0 AND upstream grad > 0, for
    inputs and upstream gradients of both signs; the forward is the leaky
    ReLU."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=64).astype(np.float32)
    c = rng.normal(size=64).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(c * jcommon.guided_leaky_relu(x, alpha)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tcommon.guided_leaky_relu(xt, alpha)
    (got,) = torch.autograd.grad((torch.from_numpy(c) * y).sum(), xt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((x > 0) & (c > 0)).any() and (got.numpy()[(x <= 0) | (c <= 0)] == 0).all()
    np.testing.assert_array_equal(
        y.detach().numpy(), torch.nn.functional.leaky_relu(xt, alpha).detach().numpy())


def test_gradcam_matches_jax(conv, video):
    jm, v, tm = conv["R2Plus1D"]
    want = jxai.gradcam_r2plus1d(jm, v["params"], v["batch_stats"], jnp.asarray(video))
    got = gradcam_r2plus1d(tm, video, device="cpu")
    assert got.shape == want.shape == (2, 1, 32, 32) and got.dtype == np.float32
    assert got.max() == pytest.approx(1.0) and got.min() >= 0.0
    np.testing.assert_allclose(got, want, **TOL)


def test_gradcam_resize_matches_jax_bilinear_on_a_non_square_case():
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize(bilinear) when upsampling (3, 5) -> (32, 24)."""
    import torch.nn.functional as F

    cam = np.random.default_rng(2).uniform(size=(2, 3, 3, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(cam), (2, 3, 32, 24), "bilinear"))
    got = F.interpolate(torch.from_numpy(cam), size=(32, 24), mode="bilinear",
                        align_corners=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("key", ["R2Plus1D", "SlowFast"])
def test_guided_saliency_matches_jax_and_differs_from_the_plain_gradient(key, conv, video):
    jm, v, tm = conv[key]
    score = lambda x: jm.apply(v, x, train=False)[:, 0].sum()
    with jxai.guided_backprop():
        g = np.asarray(jax.jit(jax.grad(score))(jnp.asarray(video)))
    assert jcommon.GUIDED_BACKPROP[0] is False
    want = np.abs(g).max(axis=-1)
    want /= np.maximum(want.reshape(2, -1).max(axis=1)[:, None, None, None], 1e-8)
    got = guided_backprop_saliency(tm, video, device="cpu")
    assert got.shape == want.shape == video.shape[:4]
    np.testing.assert_allclose(got, want, **TOL)
    assert tcommon.GUIDED_BACKPROP[0] is False

    x = torch.from_numpy(video).requires_grad_(True)
    (g,) = torch.autograd.grad(tm(x)[:, 0].sum(), x)
    plain = g.abs().amax(-1).numpy()
    plain /= plain.reshape(2, -1).max(axis=1)[:, None, None, None]
    assert not np.allclose(plain, got, atol=1e-3)


@pytest.mark.parametrize("key", ["R2Plus1D", "SlowFast"])
def test_no_activation_bypasses_the_guided_rule(key, conv, video, monkeypatch):
    """Under the guided switch every ReLU and LeakyReLU of the conv stack
    goes through the guided Function (Swish and the squeeze-excite sigmoid
    stay as they are, as in JAX): plain F.relu / F.leaky_relu run zero
    times."""
    import torch.nn.functional as F

    _, _, tm = conv[key]
    calls = {"plain": 0, "guided": 0}
    for name in ("relu", "leaky_relu"):
        orig = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _o=orig, **k: (
            calls.__setitem__("plain", calls["plain"] + 1), _o(*a, **k))[1])
    orig_apply = tcommon.GuidedLeakyReLU.apply
    monkeypatch.setattr(tcommon.GuidedLeakyReLU, "apply", lambda *a: (
        calls.__setitem__("guided", calls["guided"] + 1), orig_apply(*a))[1])
    with guided_backprop(), torch.no_grad():
        tm(torch.from_numpy(video))
    assert calls["plain"] == 0 and calls["guided"] > 0


def test_guided_flag_restored_after_the_context_and_an_exception():
    assert tcommon.GUIDED_BACKPROP[0] is False
    with guided_backprop():
        assert tcommon.GUIDED_BACKPROP[0] is True
    assert tcommon.GUIDED_BACKPROP[0] is False
    with pytest.raises(RuntimeError, match="inside"):
        with guided_backprop():
            raise RuntimeError("inside")
    assert tcommon.GUIDED_BACKPROP[0] is False


@pytest.mark.parametrize("which", ["space", "temporal"])
def test_collect_attention_and_rollout_match_jax(which, vivit):
    jm, v, tm = vivit
    x = _vivit_clips()
    want = jxai.collect_attention(jm, v["params"], jnp.asarray(x), which)
    got = collect_attention(tm, x, which, device="cpu")
    assert len(got) == len(want) == 2
    n = 5 if which == "space" else FRAMES + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((2 * FRAMES if which == "space" else 2), 2, n, n)
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(rollout(got), jxai.rollout(want), **TOL)
    want_r = jxai.vivit_attention_rollout(jm, v["params"], jnp.asarray(x), which)
    got_r = vivit_attention_rollout(tm, x, which, device="cpu")
    assert got_r.shape == want_r.shape == ((2, FRAMES, 2, 2) if which == "space"
                                           else (2, FRAMES))
    np.testing.assert_allclose(got_r, want_r, **TOL)


def test_attention_layers_in_numeric_order_at_depth_11():
    """JAX sorts the sown maps by their numeric attn_<i> index (attn_10
    after attn_9, not after attn_1); the port collects attn_0 .. attn_10 in
    that order: map i is the one layer attn_i captures alone."""
    from kstar_torch.models import ViViT

    tm = ViViT(image_size=IMG, patch_size=16, n_frames=FRAMES, dim=16, depth=11,
               n_heads=1, d_head=8, scale_dim=1,
               generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_vivit_clips(1))
    got = collect_attention(tm, x, "temporal", device="cpu")
    assert len(got) == 11
    for i in range(11):
        layer = getattr(tm.encoder.temporal_transformer, f"attn_{i}")
        layer.capture = []
        with torch.no_grad():
            tm(x)
        np.testing.assert_array_equal(got[i], layer.capture[0].numpy())
        layer.capture = None
    assert not np.allclose(got[1], got[10])


def test_capture_leaves_the_logits_bit_identical_and_keeps_no_maps(vivit):
    _, _, tm = vivit
    x = torch.from_numpy(_vivit_clips(2))
    with torch.no_grad():
        before = tm(x)
        collect_attention(tm, x, "space", device="cpu")
        after = tm(x)
    assert torch.equal(before, after)
    assert all(m.capture is None for m in tm.modules() if hasattr(m, "capture"))


def test_collect_attention_refuses_the_fused_attention_model():
    from kstar_torch.models import ViViT

    model = ViViT(image_size=IMG, patch_size=16, n_frames=FRAMES, dim=32, depth=1,
                  n_heads=2, d_head=16, scale_dim=2, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=False"):
        collect_attention(model, _vivit_clips(), device="cpu")


def test_xai_runs_on_the_gpu_unless_asked(conv, video):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gradcam_r2plus1d(conv["R2Plus1D"][2], video)
