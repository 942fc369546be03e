"""The spatial-cls table past 80 tokens: every patch-16 crop of the stored
256 px frames (N 81..257) at the flagship ViViT's widths takes a fast
instance of the CUDA kernel (bf16: one frame a block up to N 144, a
two-block cluster up to N 257; f32: one frame over a cluster of
ceil(N / 80) blocks). On the CPU: the wrapper's plan, the weight stream in
the cluster's MLP chunks and the two-pass attention walked in plain
PyTorch against the plain version, the plain version at N 257 against the
JAX package's table, and the f32 cluster's walk against JAX's XLA table at
N 257 and its Pallas kernel (interpret mode) at N 101.

Tolerances: f32, summation order only (1e-5, and the JAX test's 2e-5);
bf16, the kernel's limit against the plain version (6.25e-2 + 6.25e-2 |x|,
mean <= 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.ops import spatial_table as tst
from kstar_tpu.models.vivit import ViViT as JaxViViT
from kstar_tpu.ops import spatial_table as jst

KEY_BLOCK = 64                     # keys per block of the two-pass core (KSTAR_KEY_TILES)
OLD_REFUSAL = ("it takes N <= 128, D <= 256, d_head <= 128, with D, d_head and the "
               "MLP width multiples of 16")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _refusal(N, M=1024, dtype=torch.bfloat16, D=128, n_heads=4, d_head=64):
    return tst.kernel_refusal(1, N, D, 2, n_heads, d_head, M, dtype)


@pytest.mark.parametrize("M", [1024, 512], ids=["MLP1024", "fusion_MLP512"])
def test_every_n_from_81_to_257_takes_a_fast_instance(M):
    """At D 128 / d_head 64 in bf16 the plan takes N 81..257 on a fast
    instance: one frame a block up to the block's 144 rows, then one frame
    over a cluster of two blocks, in MLP chunks of 128 and 64."""
    for N in range(81, 258):
        inst = tst.fast_instance(128, 64, N)
        assert tst.fast_applies(N, 128, 64, M), N
        assert tst.fast_frames_per_block(N, 128, 64) == 1, N
        assert _refusal(N, M) is None, N
        cluster = 1 if N <= 144 else 2
        assert (inst.cluster, inst.mlp_chunk) == ((1, 128) if cluster == 1 else (2, 64)), N
        assert inst.max_n >= N and cluster * inst.product_rows >= N
        assert tst.fast_instance_name(N, 128, 64) == f"fast_D128_N{N}_C{cluster}"
    # up to 80 the packed instance and its names are unchanged
    assert tst.fast_instance_name(65, 128, 64) == "fast_D128_F2"
    assert tst.fast_instance_name(17, 64, 32) == "fast_D64_F7"


@pytest.mark.parametrize("n_heads", [4, 2], ids=["4x64", "2x64"])
def test_the_patch16_crops_of_the_stored_frame(n_heads):
    """The 144 .. 256 px crops of a 256 px frame at patch 16 (N 82, 101,
    122, 145, 170, 197, 226, 257) at any head count of d_head 64."""
    for crop in range(144, 257, 16):
        N = (crop // 16) ** 2 + 1
        assert _refusal(N, n_heads=n_heads) is None and tst.fast_applies(N, 128, 64, 1024)


def test_what_stays_refused():
    """N 258 and past at the flagship widths (in both dtypes), an MLP that
    is no multiple of the instance's chunk past the general instance's N
    128, and every N past 128 at widths no fast instance is compiled for
    (D 32, the demo's D 64) keep their refusals, the last with the old
    message. f32 at N 129..257 at the flagship widths takes the f32
    cluster."""
    for N in (258, 289, 401):
        assert not tst.fast_applies(N, 128, 64, 1024)
        assert "N <= 128" in _refusal(N) and "N <= 257" in _refusal(N)
        assert not tst.fast_applies(N, 128, 64, 1024, torch.float32)
        assert "N <= 257 in float32" in _refusal(N, dtype=torch.float32)
    for N in (129, 145, 257):
        assert _refusal(N, dtype=torch.float32) is None         # the f32 cluster
        assert _refusal(N, M=1024 + 16) is not None            # no multiple of 64 or 128
        assert _refusal(N, M=1024 + 16, dtype=torch.float32) is not None
    assert _refusal(128, dtype=torch.float32) is None
    assert _refusal(145, M=192) is None and _refusal(129, M=192) is not None   # chunks 64, 128
    assert _refusal(257, M=64, D=32, n_heads=2, d_head=16) == OLD_REFUSAL
    assert _refusal(257, M=64, D=32, n_heads=2, d_head=16, dtype=torch.float32) == OLD_REFUSAL
    assert _refusal(97, M=256, D=64, d_head=32) is None          # the general instance
    assert "N <= 80 in bfloat16" in _refusal(129, M=256, D=64, d_head=32)
    assert _refusal(129, M=256, D=64, d_head=32, dtype=torch.float32) == OLD_REFUSAL + (
        " (N <= 80 in bfloat16 at D 64, d_head 32)")


def _flagship(image_size, seed=11, n_frames=2, scale_dim=8, depth=2, frames=2):
    """A flagship-width ViViT (dim 128, 4 x 64) at this crop with random
    weights, its bundle in f32, and zero-cls-padded random tokens."""
    g = torch.Generator().manual_seed(seed)
    model = TorchViViT(image_size=image_size, patch_size=16, n_frames=n_frames, dim=128,
                       depth=depth, n_heads=4, d_head=64, scale_dim=scale_dim, generator=g)
    w = tst.extract_spatial_weights(model, n_frames, depth, torch.float32)
    n_tok = (image_size // 16) ** 2
    tokens = F.pad(torch.randn(frames, n_tok, 128, generator=g), (0, 0, 1, 0))
    return w, tokens


def _walk(w, tokens, dtype, inst, **kw):
    packed = tst.pack_fast(w, 2, 4, dtype, mlp_chunk=inst.mlp_chunk)
    M = w.w_ff1[0].shape[0]
    return tst.packed_walk_reference(tokens, packed, tst.pack_layer_norms(w, 2), w.base, 2, 4,
                                     64, M, dtype, mlp_chunk=inst.mlp_chunk, **kw)


@pytest.mark.parametrize("image_size", [256, 160], ids=["N257", "N101"])
def test_two_pass_walk_is_the_plain_function_f32(image_size):
    """The instance's weight stream (MLP chunks of 64 for the cluster, 128
    for one block) walked panel by panel, with the softmax in two passes
    over blocks of 64 keys and the last layer for the cls row only: the
    plain version's function, f32, summation order only."""
    w, tokens = _flagship(image_size)
    inst = tst.fast_instance(128, 64, tokens.shape[1])
    got = _walk(w, tokens, torch.float32, inst, key_block=KEY_BLOCK)
    want = tst.spatial_table_reference(tokens, w, 2, compute_dtype=torch.float32)
    assert got.shape == want.shape == (2, 2, 128)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_two_pass_walk_bf16_within_the_kernel_tolerance_at_n257():
    """bf16 at N 257 (the cluster's stream, the two-pass softmax with P
    normalised and rounded before P V, the sums over heads and chunks
    rounded once): within the limit the kernel is held to against the
    plain version."""
    w, tokens = _flagship(256)
    inst = tst.fast_instance(128, 64, 257)
    assert inst.cluster == 2
    got = _walk(w, tokens, torch.bfloat16, inst, key_block=KEY_BLOCK).float()
    want = tst.spatial_table_reference(tokens, w, 2, compute_dtype=torch.bfloat16).float()
    torch.testing.assert_close(got, want, atol=6.25e-2, rtol=6.25e-2)
    assert (got - want).abs().mean() < 2 ** -8


def test_two_pass_probs_is_the_softmax():
    """The two passes over key blocks give the softmax of the whole row,
    whatever the block size and a ragged last block."""
    s = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 16, 257)) * 4)
    want = torch.softmax(s, -1)
    for block in (16, 64, 100, 257, 512):
        torch.testing.assert_close(tst.two_pass_probs(s, block), want, atol=1e-12, rtol=1e-12)


def test_cluster_stream_unpacks_to_the_bundle():
    """The cluster's stream (q and k of a head are one panel in memory; the
    kernel copies them as two) in MLP chunks of 64, fusion MLP 512."""
    w, _ = _flagship(64, scale_dim=4)
    packed = tst.pack_fast(w, 2, 4, torch.bfloat16, mlp_chunk=64)
    assert packed.numel() == tst.pack_fast(w, 2, 4, torch.bfloat16).numel()
    got = tst.unpack_fast(packed, 2, 4, 512, 128, 64, mlp_chunk=64)
    for name, layers in got.items():
        for d, m in enumerate(layers):
            assert torch.equal(m, getattr(w, name)[d].to(torch.bfloat16)), (name, d)
    kinds = [(k, i) for d, k, i, _ in tst.fast_panels(packed, 2, 4, 512, 128, 64, 64) if d == 0]
    assert [k for k, _ in kinds].count("ff1") == 8


SEQ_LEN, T_JAX = 3, 16
SMALL = dict(dim=32, depth=2, n_heads=2, d_head=16)
SMALL_HP = dict(depth=2, n_heads=2, d_head=16)


@pytest.fixture(scope="module")
def jax_full_frame():
    """A small-width JAX ViViT over the full 256 px frame at patch 16 (256
    patches + cls = 257 tokens), f32, its parameters drawn with numpy in the
    shapes ``init`` gives (the eager init at 256 px takes seconds), and 16
    frames of random tokens."""
    model = JaxViViT(image_size=256, patch_size=16, n_frames=SEQ_LEN, dtype=jnp.float32,
                     **SMALL)
    key = jax.random.key(4)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key},
                                               jnp.zeros((1, SEQ_LEN, 256, 256, 3)),
                                               train=False))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"])
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tokens = np.random.default_rng(5).standard_normal((T_JAX, 256, 32)).astype(np.float32)
    return model, variables, params, tokens


def test_plain_table_at_n257_matches_jax(jax_full_frame):
    """The port's plain table at N 257 (what the kernel is held to on the
    card) against the JAX package's XLA table on the same inputs, f32, to
    the JAX test's 2e-5."""
    model, variables, params, tokens = jax_full_frame
    w = tst.extract_spatial_weights(params, SEQ_LEN, depth=2, dtype=torch.float32)
    got = tst.spatial_table(F.pad(torch.from_numpy(tokens), (0, 0, 1, 0)), w, SEQ_LEN,
                            depth=2, n_heads=2, d_head=16, compute_dtype=torch.float32)
    assert got.shape == (SEQ_LEN, T_JAX, 32)
    want = np.asarray(jst.spatial_table_xla(model, variables, jnp.asarray(tokens), SEQ_LEN))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def _f32_cluster_walk(params, tokens, N, C):
    """The f32 cluster's walk (a cluster of C blocks over N tokens, split
    TF32, MLP chunks of 64, tiles of 8 x 16) at the small JAX widths."""
    w = tst.extract_spatial_weights(params, SEQ_LEN, depth=2, dtype=torch.float32)
    M = w.w_ff1[0].shape[0]
    packed = tst.pack_fast(w, 2, 2, torch.float32, mlp_chunk=64, layout="tile8x16")
    padded = F.pad(torch.from_numpy(tokens), (0, 0, 1, 0))
    assert padded.shape[1] == N
    return tst.packed_walk_reference(padded, packed, tst.pack_layer_norms(w, 2), w.base, 2, 2,
                                     16, M, torch.float32, mlp_chunk=64, layout="tile8x16",
                                     split=True, cluster=C).numpy()


def test_f32_cluster_walk_at_n257_matches_jax(jax_full_frame):
    """The f32 cluster's arithmetic at N 257 (five blocks' rows, the online
    softmax over them in two merged halves, split TF32) against the JAX
    package's XLA table, f32, to the JAX test's 2e-5."""
    model, variables, params, tokens = jax_full_frame
    got = _f32_cluster_walk(params, tokens, 257, 5)
    want = np.asarray(jst.spatial_table_xla(model, variables, jnp.asarray(tokens), SEQ_LEN))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_f32_cluster_walk_at_n101_matches_pallas_interpret():
    """At the 160 px crop (N 101, a cluster of two) the f32 cluster's walk
    against JAX's spatial_table kernel in interpret mode, f32, at the
    smallest frame count it takes (one block of two frames), to 2e-5."""
    model = JaxViViT(image_size=160, patch_size=16, n_frames=SEQ_LEN, dtype=jnp.float32,
                     **SMALL)
    key = jax.random.key(7)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key},
                                               jnp.zeros((1, SEQ_LEN, 160, 160, 3)),
                                               train=False))
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"])
    tokens = np.random.default_rng(9).standard_normal((2, 100, 32)).astype(np.float32)
    got = _f32_cluster_walk(params, tokens, 101, 2)
    jw = jst.extract_spatial_weights(jax.tree_util.tree_map(jnp.asarray, params), SEQ_LEN,
                                     depth=2, dtype=jnp.float32)
    jpad = jnp.pad(jnp.asarray(tokens), ((0, 0), (1, 0), (0, 0)))
    want = np.asarray(jst.spatial_table(jpad, jw, SEQ_LEN, block_f=2,
                                        compute_dtype=jnp.float32, interpret=True, **SMALL_HP))
    assert got.shape == want.shape == (SEQ_LEN, 2, 32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_spills_reads_one_kernel_of_a_ptxas_report():
    """``_build.spills`` picks the one kernel whose mangled name holds every
    given part (the f32 cluster's test names its Shape) and reads its spill
    bytes; an ambiguous or missing match raises."""
    from kstar_torch.ops import _build

    report = "\n".join([
        "ptxas info    : Compiling entry function '_Z4tf32I5ShapeILi128ELi64ELi64ELi80ELi80ELi1EEE' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4tf32I5ShapeILi128ELi64ELi64ELi80ELi80ELi1EEE",
        "16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 213 registers, used 1 barriers, 16 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_Z4tf32I5ShapeILi128ELi64ELi64ELi64ELi257ELi5EEE' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4tf32I5ShapeILi128ELi64ELi64ELi64ELi257ELi5EEE",
        "32 bytes stack frame, 52 bytes spill stores, 92 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 32 bytes cumulative stack size"])
    assert _build.spills(report, ("tf32", "ELi257E")) == (52, 92)
    assert _build.spills(report, ("tf32", "ELi80ELi1E")) == (0, 0)
    for entry in (("tf32",), ("bf16",)):
        with pytest.raises(ValueError):
            _build.spills(report, entry)
