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
from kstar_torch.weights import spatial_weights_from_flax, state_dict_from_flax
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


# exp/demo_vivit.sh's ViViT: 64 px, patch 16 (16 patches + cls), dim 64, 4 x 32, MLP 256
DEMO = dict(image_size=64, patch_size=16, dim=64, depth=2, n_heads=4, d_head=32,
            scale_dim=4)


@pytest.fixture(scope="module")
def demo_setup():
    model = JaxViViT(n_frames=SEQ_LEN, dtype=jnp.float32, **DEMO)
    key = jax.random.key(2)
    variables = model.init({"params": key, "dropout": key},
                           jnp.zeros((1, SEQ_LEN, 64, 64, 3)), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tokens = np.random.default_rng(4).standard_normal((8, 16, 64)).astype(np.float32)
    return model, variables, params, tokens


def test_demo_widths_match_pallas_interpret_and_xla_f32(demo_setup):
    """The plain version at the demo ViViT's widths, which the second fast
    instance is compiled for, against the Pallas kernel in interpret mode
    and the XLA scan on the same inputs, at the JAX test's tolerance."""
    model, variables, params, tokens = demo_setup
    hp = dict(depth=2, n_heads=4, d_head=32)
    w = tst.extract_spatial_weights(params, SEQ_LEN, depth=2, dtype=torch.float32)
    got = tst.spatial_table(F.pad(torch.from_numpy(tokens), (0, 0, 1, 0)), w, SEQ_LEN,
                            compute_dtype=torch.float32, **hp).numpy()
    assert got.shape == (SEQ_LEN, 8, 64)
    jw = jst.extract_spatial_weights(variables["params"], SEQ_LEN, depth=2, dtype=jnp.float32)
    padded = jnp.pad(jnp.asarray(tokens), ((0, 0), (1, 0), (0, 0)))
    pallas = np.asarray(jst.spatial_table(padded, jw, SEQ_LEN, block_f=4,
                                          compute_dtype=jnp.float32, interpret=True, **hp))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, _xla(model, variables, tokens), **TOL)


def test_port_module_gives_the_same_bundle(setup):
    """extract_spatial_weights on the port module (Linear layout) equals the
    one on the flax tree, and the JAX bundle converts to the same."""
    _, variables, params, _ = setup
    tm = TorchViViT(image_size=IMG, patch_size=PATCH, n_frames=SEQ_LEN, dim=DIM,
                    depth=DEPTH, n_heads=HEADS, d_head=DH)
    tm.load_state_dict(state_dict_from_flax(params))
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


# ---- the fast instance's weight stream and its walk, on the CPU ------------

def _flagship_like(n_heads, scale_dim, depth, dim=128, d_head=64, n_frames=4, image_size=64,
                   seed=3):
    """A model at one of the fast instance's widths (dim 128 and d_head 64
    by default) with random weights, its bundle, and zero-cls-padded tokens
    (5 frames of 17 tokens at the default 64 px)."""
    g = torch.Generator().manual_seed(seed)
    model = TorchViViT(image_size=image_size, patch_size=16, n_frames=n_frames, dim=dim,
                       depth=depth, n_heads=n_heads, d_head=d_head, scale_dim=scale_dim,
                       generator=g)
    w = tst.extract_spatial_weights(model, n_frames, depth, torch.float32)
    n_tok = (image_size // 16) ** 2
    tokens = F.pad(torch.randn(5, n_tok, dim, generator=g), (0, 0, 1, 0))
    return w, tokens


WIDTHS = {"flagship": dict(n_heads=4, scale_dim=8, depth=2),      # MLP 1024
          "odd": dict(n_heads=3, scale_dim=3, depth=3),            # MLP 384, 3 chunks
          # exp/demo_vivit.sh's ViViT: dim 64, 4 x 32, MLP 256 (4 chunks of 64)
          "demo": dict(dim=64, d_head=32, n_heads=4, scale_dim=4, depth=2)}


def _widths(hp):
    """(D, d_head, MLP width, the fast instance) of a WIDTHS entry."""
    D, dh = hp.get("dim", 128), hp.get("d_head", 64)
    return D, dh, D * hp["scale_dim"], tst.fast_instance(D, dh)


@pytest.mark.parametrize("widths", list(WIDTHS), ids=list(WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_packed_weights_unpack_to_the_bundle(widths, dtype):
    hp = WIDTHS[widths]
    w, _ = _flagship_like(**hp)
    D, dh, M, inst = _widths(hp)
    packed = tst.pack_fast(w, hp["depth"], hp["n_heads"], dtype)
    assert packed.dtype == dtype and packed.numel() % 8 == 0    # 16-byte panels
    mc = inst.mlp_chunk
    per_layer = (hp["n_heads"] * (2 * dh * D + dh * D + D * dh)
                 + (M // mc) * 2 * mc * D + 2 * D + M)
    assert packed.numel() == hp["depth"] * per_layer
    got = tst.unpack_fast(packed, hp["depth"], hp["n_heads"], M, D, dh)
    for name, layers in got.items():
        assert len(layers) == hp["depth"]
        for d, m in enumerate(layers):
            assert torch.equal(m, getattr(w, name)[d].to(dtype)), (name, d)


def test_packed_stream_order_and_blocking():
    """Panels come in the order the kernel multiplies, each in the blocked
    layout the kernel reads: 8 x 8 core matrices of 64 contiguous elements,
    the core matrices of an 8-row group side by side along k."""
    w, _ = _flagship_like(**WIDTHS["odd"])
    packed = tst.pack_fast(w, 3, 3, torch.float32)
    kinds = [(d, kind, i) for d, kind, i, _ in tst.fast_panels(packed, 3, 3, 384, 128, 64)]
    layer0 = [k[1:] for k in kinds if k[0] == 0]
    assert layer0 == ([(kind, h) for h in range(3) for kind in ("qk", "v", "out")]
                      + [(kind, c) for c in range(3) for kind in ("ff1", "ff2")]
                      + [("b_out", 0), ("b_ff1", 0), ("b_ff2", 0)])
    assert [k[0] for k in kinds] == sorted(k[0] for k in kinds)
    first = packed[:128 * 128]                   # head 0: q rows, then k rows
    qk = torch.cat([w.w_qkv[0][:64], w.w_qkv[0][192:256]])
    for n, k in ((0, 0), (3, 5), (8, 0), (9, 17), (64, 0), (127, 127), (70, 64)):
        at = ((n // 8) * (128 // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8
        assert first[at] == qk[n, k], (n, k)
    assert torch.equal(first[:8], qk[0, :8]) and torch.equal(first[8:16], qk[1, :8])
    assert torch.equal(first[64:72], qk[0, 8:16])                     # the next core matrix
    out0 = packed[128 * 128 + 64 * 128:][:128 * 64]                   # head 0's out panel
    assert out0[(2 * (64 // 8) + 1) * 64 + 3 * 8 + 4] == w.w_out[0][19, 12]
    with pytest.raises(ValueError, match="walked"):
        list(tst.fast_panels(packed[:-8], 3, 3, 384, 128, 64))


_FLAGSHIP_FRAMES = [(65, 2), (17, 8), (72, 2), (73, 1), (80, 1), (37, 3), (10, 14), (5, 16),
                    (1, 16)]
_DEMO_FRAMES = [(17, 7), (65, 1), (64, 2), (80, 1), (37, 3), (10, 12), (5, 16), (1, 16)]


@pytest.mark.parametrize(
    "widths,n,frames",
    [pytest.param((128, 64), n, f, id=f"{n}-{f}") for n, f in _FLAGSHIP_FRAMES]
    + [pytest.param((64, 32), n, f, id=f"D64-{n}-{f}") for n, f in _DEMO_FRAMES])
def test_fast_frames_per_block(widths, n, frames):
    """As many frames as fit in the rows the instance's products compute
    (144 at D 128, 128 at D 64) and, with the last frame's keys padded to a
    multiple of 16, in the rows of q, k and v (160, 144); no more than the
    16 rows of the last layer's cls tile."""
    D, dh = widths
    inst = tst.fast_instance(D, dh)
    assert tst.fast_frames_per_block(n, D, dh) == frames
    fits = lambda f: (f * n <= inst.product_rows
                      and (f - 1) * n + -(-n // 16) * 16 <= inst.rows)
    assert fits(frames) and (frames == tst.FAST_MAX_FRAMES or not fits(frames + 1))
    assert tst.fast_applies(n, D, dh, 8 * inst.mlp_chunk)
    assert not tst.fast_applies(n, D, dh, 8 * inst.mlp_chunk + 16)
    assert not tst.fast_applies(n, 64, 64, 1024) and not tst.fast_applies(n, 128, 32, 1024)
    # past 80 tokens the flagship widths take the one-frame instances; the
    # demo widths have none
    assert tst.fast_applies(81, D, dh, 8 * inst.mlp_chunk) == (D == 128)


@pytest.mark.parametrize("widths", list(WIDTHS), ids=list(WIDTHS))
@pytest.mark.parametrize("cls_last", [False, True], ids=["all_rows", "cls_last"])
def test_packed_walk_reproduces_the_reference_f32(widths, cls_last):
    """The kernel's order of work (panel by panel, out-projection summed
    over heads and FF2 over chunks before the one rounding) is the same
    function as the plain version: f32, summation order only."""
    hp = WIDTHS[widths]
    w, tokens = _flagship_like(**hp)
    D, dh, M, _ = _widths(hp)
    packed = tst.pack_fast(w, hp["depth"], hp["n_heads"], torch.float32)
    wln = tst.pack_layer_norms(w, hp["depth"])
    got = tst.packed_walk_reference(tokens, packed, wln, w.base, hp["depth"], hp["n_heads"],
                                    dh, M, torch.float32, cls_last=cls_last)
    want = tst.spatial_table_reference(tokens, w, 4, depth=hp["depth"],
                                       n_heads=hp["n_heads"], d_head=dh,
                                       compute_dtype=torch.float32)
    assert got.shape == want.shape == (4, 5, D)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("widths", list(WIDTHS), ids=list(WIDTHS))
def test_cls_only_last_layer_is_bit_identical_f32(widths):
    """The table keeps the cls row, so the last layer needs K and V for all
    rows and everything else for row 0 alone: the same arithmetic for that
    row, bit for bit."""
    hp = WIDTHS[widths]
    w, tokens = _flagship_like(**hp)
    _, dh, M, _ = _widths(hp)
    packed = tst.pack_fast(w, hp["depth"], hp["n_heads"], torch.float32)
    wln = tst.pack_layer_norms(w, hp["depth"])
    walk = lambda cls_last: tst.packed_walk_reference(
        tokens, packed, wln, w.base, hp["depth"], hp["n_heads"], dh, M, torch.float32,
        cls_last=cls_last)
    assert torch.equal(walk(True), walk(False))


def _walk_bf16_against_the_plain_version(widths):
    hp = WIDTHS[widths]
    w, tokens = _flagship_like(**hp)
    _, dh, M, _ = _widths(hp)
    packed = tst.pack_fast(w, 2, 4, torch.bfloat16)
    got = tst.packed_walk_reference(tokens, packed, tst.pack_layer_norms(w, 2), w.base,
                                    2, 4, dh, M, torch.bfloat16).float()
    want = tst.spatial_table_reference(tokens, w, 4, d_head=dh,
                                       compute_dtype=torch.bfloat16).float()
    torch.testing.assert_close(got, want, atol=6.25e-2, rtol=6.25e-2)
    assert (got - want).abs().mean() < 2 ** -8


def test_packed_walk_bf16_within_the_kernel_tolerance():
    """bf16 cast points: the walk rounds where the kernel does (the sums over
    heads and chunks once, not per head and chunk), within the tolerance the
    kernel is held to against the plain version."""
    _walk_bf16_against_the_plain_version("flagship")


def test_packed_walk_bf16_within_the_kernel_tolerance_at_the_demo_widths():
    """The same at the demo ViViT's widths (D 64, 4 x 32, MLP in four
    chunks of 64)."""
    _walk_bf16_against_the_plain_version("demo")


def test_packed_weights_are_cached_per_bundle_and_dtype():
    w, _ = _flagship_like(**WIDTHS["flagship"])
    cpu = torch.device("cpu")
    a = tst._packed_weights(w, 2, 4, torch.bfloat16, cpu, mlp_chunk=128)
    b = tst._packed_weights(w, 2, 4, torch.bfloat16, cpu, mlp_chunk=128)
    assert a[0] is b[0] and a[1] is b[1]
    c = tst._packed_weights(w, 2, 4, torch.float32, cpu, mlp_chunk=0)
    assert c[0] is not a[0] and torch.equal(c[0], tst.pack_general(w, 2, torch.float32))
    e = tst._packed_weights(w, 2, 4, torch.bfloat16, cpu, mlp_chunk=64)   # the cluster's chunks
    assert e[0] is not a[0] and torch.equal(e[0], tst.pack_fast(w, 2, 4, mlp_chunk=64))
    w.w_ff1[0].mul_(2.0)                      # an in-place update invalidates the entry
    d = tst._packed_weights(w, 2, 4, torch.bfloat16, cpu, mlp_chunk=128)
    assert d[0] is not a[0] and not torch.equal(d[0], a[0])
