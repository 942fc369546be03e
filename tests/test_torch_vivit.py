"""kstar_torch ViViT against the flax ViViT of kstar_tpu, on shared weights.

Parameters come from the flax ``init`` and are carried across with
``kstar_torch.weights``; inputs come from a numpy seed. Everything runs in
f32 on the CPU, at atol/rtol 1e-5: both sides compute the same f32
arithmetic and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import ViViTConfig
from kstar_torch.models import build_video_model
from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.models.vivit import ViViT as JaxViViT

IMG, PATCH, FRAMES = 32, 16, 5
SMALL = dict(image_size=IMG, patch_size=PATCH, n_frames=FRAMES, dim=32, depth=2,
             n_heads=2, d_head=16, scale_dim=2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def make_pair(**overrides):
    """(flax model, flax variables, port model) with the port holding the
    flax init's parameters."""
    kw = {**SMALL, **overrides}
    jm = JaxViViT(dtype=jnp.float32, **kw)
    key = jax.random.key(0)
    variables = jm.init({"params": key, "dropout": key},
                        jnp.zeros((1, kw["n_frames"], kw["image_size"],
                                   kw["image_size"], 3)), train=False)
    tm = TorchViViT(**kw).eval()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _np(t):
    return t.detach().numpy()


def test_embed_frames(pair):
    jm, v, tm = pair
    x = np.random.default_rng(0).normal(size=(2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), method="embed_frames"))
    got = _np(tm.embed_frames(torch.from_numpy(x)))
    assert got.shape == (2, FRAMES, 4, SMALL["dim"])
    np.testing.assert_allclose(got, want, **TOL)
    # unbatched (T, H, W, C) input
    np.testing.assert_allclose(_np(tm.embed_frames(torch.from_numpy(x[0]))), want[0], **TOL)


@pytest.mark.parametrize("offset", [0, 3])
def test_spatial_cls(pair, offset):
    jm, v, tm = pair
    tokens = np.random.default_rng(1).normal(size=(7, 4, SMALL["dim"])).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(tokens), offset, method="spatial_cls"))
    got = _np(tm.spatial_cls(torch.from_numpy(tokens), offset))
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_spatial_cls(pair):
    jm, v, tm = pair
    win = np.random.default_rng(2).normal(size=(3, FRAMES, SMALL["dim"])).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(win), method="forward_spatial_cls"))
    got = _np(tm.forward_spatial_cls(torch.from_numpy(win)))
    np.testing.assert_allclose(got, want, **TOL)


def test_logits_and_split_methods(pair):
    jm, v, tm = pair
    x = np.random.default_rng(3).normal(size=(3, FRAMES, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(_np(tm(xt)), want, **TOL)
    tokens = tm.embed_frames(xt)
    np.testing.assert_allclose(_np(tm.forward_tokens(tokens)), want, **TOL)
    np.testing.assert_allclose(_np(tm.encode(xt)),
                               np.asarray(jm.apply(v, jnp.asarray(x), method="encode")),
                               **TOL)


def test_project_out_skipped_for_single_full_width_head():
    jm, v, tm = make_pair(n_heads=1, d_head=SMALL["dim"])
    assert not hasattr(tm.encoder.space_transformer.attn_0, "to_out")
    x = np.random.default_rng(4).normal(size=(2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def test_smaller_crop_prefix_slices_positions(pair):
    """A crop below image_size gives fewer patches than the positional
    embedding holds; both models add a prefix slice of it."""
    jm, v, tm = pair
    x = np.random.default_rng(5).normal(size=(2, 3, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def test_use_pallas_attention_matches_plain_on_cpu(pair):
    """On CPU tensors MHSA(use_pallas=True) runs the kernel's plain version;
    at f32 it equals the model's own attention."""
    jm, v, tm = pair
    tp = TorchViViT(**SMALL, use_pallas=True).eval()
    tp.load_state_dict(tm.state_dict())
    x = np.random.default_rng(6).normal(size=(2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tp(torch.from_numpy(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def test_state_dict_names_follow_flax(pair):
    _, v, tm = pair
    keys = set(tm.state_dict())
    assert "encoder.space_transformer.attn_0.to_qkv.weight" in keys
    assert "encoder.temporal_transformer.final_norm.weight" in keys
    assert {"mlp_fc1.weight", "mlp_ln.bias", "mlp_fc2.bias"} <= keys
    # Dense kernels are transposed into Linear layout
    k = np.asarray(v["params"]["encoder"]["patch_embed"]["kernel"])
    np.testing.assert_array_equal(_np(tm.encoder.patch_embed.weight), k.T)


def test_seeded_init_follows_flax_defaults():
    a = build_video_model("ViViT", ViViTConfig(), generator=torch.Generator().manual_seed(0))
    b = build_video_model("ViViT", ViViTConfig(), generator=torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.encoder.space_transformer.ff1_0.weight.detach()  # (1024, 128)
    assert abs(float(w.std()) - 128 ** -0.5) < 0.05 * 128 ** -0.5
    assert float(w.abs().max()) <= 2 * 128 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.count_nonzero(a.encoder.space_transformer.ff1_0.bias) == 0
    assert torch.all(a.encoder.space_transformer.attn_norm_0.weight == 1)
    assert abs(float(a.encoder.pos_embedding.detach().std()) - 1.0) < 0.02


def test_build_video_model_dispatch():
    m = build_video_model("ViViT", ViViTConfig(norm_dtype="bfloat16"), dtype=torch.bfloat16)
    assert m.dtype == torch.bfloat16
    assert m.encoder.space_transformer.attn_norm_0.dtype == torch.bfloat16
    from kstar_torch.config import SlowFastConfig
    from kstar_torch.models import SlowFast

    assert type(build_video_model("SlowFast", SlowFastConfig(layers=(1, 1, 1, 1)))) is SlowFast
    with pytest.raises(ValueError):
        build_video_model("NoSuchModel", ViViTConfig())
