"""kstar_torch spatial_table (CPU: the kernel's plain version) against the
kstar_tpu Pallas kernel in interpret mode and its XLA scan reference.

The f32 tolerance is the JAX test's own (tests/test_ops_spatial_table.py,
atol/rtol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.ops import spatial_table as tst
from kstar_torch.weights import spatial_weights_from_flax, vivit_state_dict_from_flax
from kstar_tpu.models.vivit import ViViT as JaxViViT
from kstar_tpu.ops import spatial_table as jst

SEQ_LEN, T = 5, 12
IMG, PATCH = 32, 16          # 4 patches + cls = 5 tokens
DIM, DEPTH, HEADS, DH = 32, 2, 2, 16
HP = dict(depth=DEPTH, n_heads=HEADS, d_head=DH)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup():
    model = JaxViViT(image_size=IMG, patch_size=PATCH, n_frames=SEQ_LEN, dim=DIM,
                     depth=DEPTH, n_heads=HEADS, d_head=DH, dtype=jnp.float32)
    key = jax.random.key(0)
    variables = model.init({"params": key, "dropout": key},
                           jnp.zeros((1, SEQ_LEN, IMG, IMG, 3)), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tokens = np.random.default_rng(1).standard_normal((T, 4, DIM)).astype(np.float32)
    return model, variables, params, tokens


def _xla(model, variables, tokens):
    return np.asarray(jst.spatial_table_xla(model, variables, jnp.asarray(tokens), SEQ_LEN))


def _pallas(variables, tokens, dtype):
    w = jst.extract_spatial_weights(variables["params"], SEQ_LEN, depth=DEPTH, dtype=dtype)
    padded = jnp.pad(jnp.asarray(tokens, dtype), ((0, 0), (1, 0), (0, 0)))
    return np.asarray(jst.spatial_table(padded, w, SEQ_LEN, block_f=4, compute_dtype=dtype,
                                        interpret=True, **HP), np.float32)


def _port(params, tokens, dtype):
    w = tst.extract_spatial_weights(params, SEQ_LEN, depth=DEPTH, dtype=dtype)
    padded = F.pad(torch.from_numpy(tokens).to(dtype), (0, 0, 1, 0))
    return tst.spatial_table(padded, w, SEQ_LEN, compute_dtype=dtype, **HP).float().numpy()


@pytest.mark.parametrize("n_patches", [4, 2], ids=["full_crop", "smaller_crop"])
def test_matches_pallas_interpret_and_xla_f32(setup, n_patches):
    """Full crop, and a crop below the training image size, where both
    packages prefix-slice the positional embedding."""
    model, variables, params, tokens = setup
    tokens = tokens[:, :n_patches]
    got = _port(params, tokens, torch.float32)
    assert got.shape == (SEQ_LEN, T, DIM)
    np.testing.assert_allclose(got, _pallas(variables, tokens, jnp.float32), **TOL)
    np.testing.assert_allclose(got, _xla(model, variables, tokens), **TOL)


def test_matches_pallas_interpret_bf16(setup):
    """bf16: both round at the same cast points, but XLA on the CPU may keep
    elementwise bf16 chains in f32 between them (and sums run in another
    order), so single values can land one bf16 ulp apart and carry that
    through two layers: 6.25e-2 (16 ulps at 1.0) elementwise, with the mean
    error held under one ulp at 1.0."""
    _, variables, params, tokens = setup
    got = _port(params, tokens, torch.bfloat16)
    want = _pallas(variables, tokens, jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=6.25e-2, rtol=6.25e-2)
    assert np.abs(got - want).mean() < 2 ** -8


def test_port_module_gives_the_same_bundle(setup):
    """extract_spatial_weights on the port module (Linear layout) equals the
    one on the flax tree, and the JAX bundle converts to the same."""
    _, variables, params, _ = setup
    tm = TorchViViT(image_size=IMG, patch_size=PATCH, n_frames=SEQ_LEN, dim=DIM,
                    depth=DEPTH, n_heads=HEADS, d_head=DH)
    tm.load_state_dict(vivit_state_dict_from_flax(params))
    from_tree = tst.extract_spatial_weights(params, SEQ_LEN, DEPTH, torch.float32)
    from_module = tst.extract_spatial_weights(tm, SEQ_LEN, DEPTH, torch.float32)
    jax_bundle = jax.tree_util.tree_map(
        np.asarray, jst.extract_spatial_weights(variables["params"], SEQ_LEN, depth=DEPTH,
                                                dtype=jnp.float32))
    converted = spatial_weights_from_flax(jax_bundle, torch.float32)
    for name in tst.SpatialWeights._fields:
        a, b, c = (getattr(w, name) for w in (from_tree, from_module, converted))
        for x, y, z in zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b, c))):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
            torch.testing.assert_close(x, z, rtol=0, atol=0)


def test_base_row0_is_space_token_plus_pos(setup):
    _, _, params, _ = setup
    w = tst.extract_spatial_weights(params, SEQ_LEN, DEPTH, torch.float32)
    enc = params["encoder"]
    pos, tok = enc["pos_embedding"][0], enc["space_token"][0, 0]
    np.testing.assert_allclose(w.base[:, 0].numpy(), pos[:SEQ_LEN, 0] + tok, atol=1e-6)
    np.testing.assert_array_equal(w.base[:, 1:].numpy(), pos[:SEQ_LEN, 1:])
    assert w.w_qkv[0].shape == (3 * HEADS * DH, DIM)        # Linear layout
    assert w.ln_a_s[0].dtype == torch.float32


def test_find_spatial_params_and_errors(setup):
    _, _, params, _ = setup
    flat = tst.find_spatial_params(params)
    assert flat is not None and "space_transformer" in flat
    assert tst.find_spatial_params({"a": {"b": params}}) is flat
    assert tst.find_spatial_params({"x": {"y": 1}}) is None
    with pytest.raises(ValueError, match="n_offsets"):
        tst.extract_spatial_weights(params, SEQ_LEN + 1, DEPTH)
    with pytest.raises(KeyError):
        tst.extract_spatial_weights({"x": {}}, SEQ_LEN, DEPTH)


def test_rejects_bad_inputs(setup):
    _, _, params, tokens = setup
    w = tst.extract_spatial_weights(params, SEQ_LEN, DEPTH, torch.float32)
    with pytest.raises(ValueError, match=r"\(T, N, D\)"):
        tst.spatial_table(torch.zeros(4, DIM), w, SEQ_LEN, **HP)
    with pytest.raises(ValueError, match="does not cover"):
        tst.spatial_table(torch.zeros(T, 9, DIM), w, SEQ_LEN, **HP)
    with pytest.raises(ValueError, match="unsupported device"):
        tst.spatial_table(torch.zeros(T, 5, DIM, device="meta"), w, SEQ_LEN, **HP)
