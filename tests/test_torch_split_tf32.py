"""The f32 kernels' split-TF32 arithmetic in plain PyTorch, on the CPU.

The f32 instances of the spatial-table and fused-attention kernels run
their products on the tensor cores in split TF32: each f32 operand x is
split into hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna``: nearest, ties
away from zero), and a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b.
Here that arithmetic (``ops.attention.tf32_round``, ``split_tf32_matmul``,
``strip_attention_emulation(p_mode="split_tf32")``,
``packed_walk_reference(split=True)`` over the f32 instance's weight
stream) is held against f64 and against the JAX package's kernels (Pallas
in interpret mode, and the XLA table) at the f32 tolerance of their tests,
2e-5; and the wrapper's routing of f32 calls to the new instance is checked
without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.ops import attention as tat
from kstar_torch.ops import spatial_table as tst
from kstar_tpu.models.vivit import ViViT as JaxViViT
from kstar_tpu.ops import attention as jat
from kstar_tpu.ops import spatial_table as jst

F32_TOL = 2e-5                 # the JAX f32 tests' atol and rtol


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32)


def test_tf32_round_is_cvt_rna():
    """Nearest on the bit pattern with ties away from zero, the 13 low bits
    cleared; a carry may reach the exponent; values already in TF32 stay."""
    one = 0x3F800000
    cases = {one + 0x1000: one + 0x2000,             # a tie rounds away from zero
             one + 0x0FFF: one,                      # just below the tie
             one + 0x1001: one + 0x2000,
             one + 0x3000: one + 0x4000,             # a tie above an odd tf32 value
             0x3FFFFFFF: 0x40000000,                 # the carry into the exponent
             one + 0x2000: one + 0x2000,             # already tf32
             0x7F800000: 0x7F800000}                 # inf
    for src, want in cases.items():
        for sign in (0, 0x80000000):
            got = tat.tf32_round(_f32([src | sign])).view(torch.int32).item() & 0xFFFFFFFF
            assert got == (want | sign), (hex(src | sign), hex(got))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    r = tat.tf32_round(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2 ** -11
    assert torch.isnan(tat.tf32_round(torch.tensor([float("nan")]))).all()


def test_split_pair_holds_22_bits():
    """hi + lo equals x to about 2^-22 relative (lo's own rounding)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1 << 14).astype(np.float32))
    hi, lo = tat.split_tf32(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2 ** -21
    assert float((lo.abs() / x.abs()).max()) <= 2 ** -11


@pytest.mark.parametrize("K", [64, 128, 1024])
def test_split_product_within_f32_tolerance(K):
    """a (64, K) of unit normals times b (K, 64) of variance 1/K, outputs
    O(1) as the kernels' products are: the split product lands well inside
    2e-5 of an f64 product (under a quarter of it), where a single TF32
    product (hi_a hi_b) misses 2e-5 on the same draws."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    b = (rng.standard_normal((K, 64)) / np.sqrt(K)).astype(np.float32)
    want = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    split = tat.split_tf32_matmul(ta, tb).double()
    single = (tat.tf32_round(ta) @ tat.tf32_round(tb)).double()     # one TF32 product
    limit = F32_TOL + F32_TOL * want.abs()
    assert bool(((split - want).abs() <= limit / 4).all())
    assert not bool(((single - want).abs() <= limit).all())
    # the split is as good as a plain f32 product, up to summation noise
    plain = (ta @ tb).double()
    assert float((split - want).abs().max()) <= 4 * float((plain - want).abs().max()) + 1e-6


def _qkv(n, d=64, seed=0, logit_peak=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 3, n, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    if logit_peak is not None:
        q = (q * (logit_peak / np.abs(q @ k.transpose(0, 1, 3, 2) * scale).max())).astype(
            np.float32)
    return q, k, v, scale


@pytest.mark.parametrize("n", [22, 65, 130])
def test_strip_emulation_split_tf32_matches_pallas_interpret(n):
    """The f32 tensor-core instance's arithmetic (16-query strips, one
    block of 32 or 80 keys, both products in split TF32, P unnormalised)
    against JAX's fused_attention in interpret mode, f32, at 2e-5; 130
    keys (the scalar instance's in f32 on the card) cross two of the
    emulation's key blocks, with the running max."""
    q, k, v, scale = _qkv(n, seed=n)
    want = np.asarray(jat.fused_attention(*map(jnp.asarray, (q, k, v)), scale, interpret=True))
    got = tat.strip_attention_emulation(*map(torch.from_numpy, (q, k, v)), scale,
                                        p_mode="split_tf32")
    assert got.dtype == torch.float32 and got.shape == (2, 3, n, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def _split_matmul_f64(a, b):
    """The split-TF32 product with its three products summed in f64: the
    split's own error, without f32 summation."""
    (ah, al), (bh, bl) = tat.split_tf32(a), tat.split_tf32(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("n", [65, 300])
def test_strip_emulation_split_tf32_large_logits(n):
    """|s| up to 80, the key blocks also forced to 32 (every row crosses
    blocks and rescales its partial output). At |s| 80 the f32 rounding of
    the scores alone moves any f32 computation by about 2e-5 (the plain
    version lands 2.2e-5 from an f64 softmax on these draws), so the split
    is held to what it adds: with its products summed in f64 it is within
    half of 2e-5 of the f64 attention (a score of 80 off by ~2^-20
    relative moves P by ~8e-6), and with f32 sums (the emulation) no
    further from it than the plain f32 version plus that half."""
    q, k, v, scale = _qkv(n, seed=7, logit_peak=80.0)
    q, k, v = map(torch.from_numpy, (q, k, v))
    exact = torch.softmax((q.double() @ k.double().transpose(-1, -2)) * scale, -1) @ v.double()
    split = _split_matmul_f64(torch.softmax(_split_matmul_f64(q, k.transpose(-1, -2)) * scale,
                                            -1).float(), v)
    assert float((split - exact).abs().max()) <= F32_TOL / 2
    plain_err = float((tat.fused_attention_reference(q, k, v, scale).double() - exact).abs().max())
    for key_block in (None, 32):
        got = tat.strip_attention_emulation(q, k, v, scale, p_mode="split_tf32",
                                            key_block=key_block)
        assert bool(torch.isfinite(got).all())
        assert float((got.double() - exact).abs().max()) <= plain_err + F32_TOL / 2


# ---- the spatial table's f32 instance -------------------------------------

SEQ_LEN, T = 5, 12
IMG, PATCH = 32, 16          # 4 patches + cls = 5 tokens
DIM, DEPTH, HEADS, DH = 32, 2, 2, 16
HP = dict(depth=DEPTH, n_heads=HEADS, d_head=DH)


@pytest.fixture(scope="module")
def small():
    """tests/test_torch_spatial_table.py's small JAX ViViT (dim 32, 2 x 16,
    MLP 256, 5 tokens) and its tokens."""
    model = JaxViViT(image_size=IMG, patch_size=PATCH, n_frames=SEQ_LEN, dim=DIM,
                     depth=DEPTH, n_heads=HEADS, d_head=DH, dtype=jnp.float32)
    key = jax.random.key(0)
    variables = model.init({"params": key, "dropout": key},
                           jnp.zeros((1, SEQ_LEN, IMG, IMG, 3)), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tokens = np.random.default_rng(1).standard_normal((T, 4, DIM)).astype(np.float32)
    return model, variables, params, tokens


@pytest.mark.parametrize("n_patches", [4, 2], ids=["full_crop", "smaller_crop"])
def test_split_tf32_walk_matches_jax_table(small, n_patches):
    """The f32 instance's walk (its weight stream in 8 x 16 tiles, MLP
    chunks of 64, every product in split TF32, the online softmax's
    unnormalised P, the last layer for the cls row) against JAX's
    spatial_table in interpret mode and its XLA table, f32, at the JAX
    test's 2e-5."""
    model, variables, params, tokens = small
    tokens = tokens[:, :n_patches]
    w = tst.extract_spatial_weights(params, SEQ_LEN, depth=DEPTH, dtype=torch.float32)
    M = w.w_ff1[0].shape[0]
    packed = tst.pack_fast(w, DEPTH, HEADS, torch.float32, mlp_chunk=64, layout="tile8x16")
    padded = F.pad(torch.from_numpy(tokens), (0, 0, 1, 0))
    got = tst.packed_walk_reference(padded, packed, tst.pack_layer_norms(w, DEPTH), w.base,
                                    DEPTH, HEADS, DH, M, torch.float32, mlp_chunk=64,
                                    layout="tile8x16", split=True).numpy()
    assert got.shape == (SEQ_LEN, T, DIM)
    jw = jst.extract_spatial_weights(variables["params"], SEQ_LEN, depth=DEPTH,
                                     dtype=jnp.float32)
    jpad = jnp.pad(jnp.asarray(tokens), ((0, 0), (1, 0), (0, 0)))
    pallas = np.asarray(jst.spatial_table(jpad, jw, SEQ_LEN, block_f=4,
                                          compute_dtype=jnp.float32, interpret=True, **HP))
    xla = np.asarray(jst.spatial_table_xla(model, variables, jnp.asarray(tokens), SEQ_LEN))
    np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got, xla, atol=F32_TOL, rtol=F32_TOL)


def _flagship(image_size, seed=3, frames=5, scale_dim=8, depth=2, n_heads=4):
    """A flagship-width ViViT (dim 128, d_head 64, by default 4 heads and
    depth 2) with random weights at this crop, its f32 bundle and
    zero-cls-padded random tokens."""
    g = torch.Generator().manual_seed(seed)
    model = TorchViViT(image_size=image_size, patch_size=16, n_frames=4, dim=128, depth=depth,
                       n_heads=n_heads, d_head=64, scale_dim=scale_dim, generator=g)
    w = tst.extract_spatial_weights(model, 4, depth, torch.float32)
    n_tok = (image_size // 16) ** 2
    tokens = F.pad(torch.randn(frames, n_tok, 128, generator=g), (0, 0, 1, 0))
    return w, tokens


@pytest.mark.parametrize("image_size,depth,n_heads,scale_dim",
                         [(64, 2, 4, 8), (128, 2, 4, 8), (64, 3, 3, 3)],
                         ids=["N17", "N65", "N17_depth3_3heads_MLP384"])
def test_split_tf32_walk_is_the_plain_function_at_the_flagship_widths(image_size, depth,
                                                                        n_heads, scale_dim):
    """At the widths the f32 instance is compiled for (D 128, d_head 64, N
    17 and 65, MLP 1024 in chunks of 64; and 3 layers of 3 heads, MLP 384):
    its walk equals the plain f32 table up to summation order and the
    split's ~2^-21 per product (1e-5)."""
    w, tokens = _flagship(image_size, depth=depth, n_heads=n_heads, scale_dim=scale_dim)
    M = 128 * scale_dim
    inst = tst.fast_instance(128, 64, tokens.shape[1], torch.float32)
    packed = tst.pack_fast(w, depth, n_heads, torch.float32, mlp_chunk=inst.mlp_chunk,
                           layout=inst.layout)
    got = tst.packed_walk_reference(tokens, packed, tst.pack_layer_norms(w, depth), w.base,
                                    depth, n_heads, 64, M, torch.float32,
                                    mlp_chunk=inst.mlp_chunk, layout=inst.layout, split=True)
    want = tst.spatial_table_reference(tokens, w, 4, depth=depth, n_heads=n_heads,
                                       compute_dtype=torch.float32)
    assert got.shape == want.shape == (4, 5, 128)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_f32_stream_in_tiles_unpacks_to_the_bundle():
    """The f32 instance's stream: the fast instance's order of panels in 8 x
    16 tiles (element (n, k) of a panel at ((n // 8) * (K // 16) + k // 16)
    * 128 + (n % 8) * 16 + k % 16), MLP chunks of 64; the same elements as
    the core8x8 stream."""
    w, _ = _flagship(64)
    packed = tst.pack_fast(w, 2, 4, torch.float32, mlp_chunk=64, layout="tile8x16")
    assert packed.numel() == tst.pack_fast(w, 2, 4, torch.float32, mlp_chunk=64).numel()
    got = tst.unpack_fast(packed, 2, 4, 1024, 128, 64, mlp_chunk=64, layout="tile8x16")
    for name, layers in got.items():
        for d, m in enumerate(layers):
            assert torch.equal(m, getattr(w, name)[d]), (name, d)
    qk = torch.cat([w.w_qkv[0][:64], w.w_qkv[0][256:320]])      # head 0's q rows, k rows
    for n, k in ((0, 0), (3, 5), (8, 0), (9, 17), (64, 0), (127, 127), (70, 40)):
        at = ((n // 8) * (128 // 16) + k // 16) * 128 + (n % 8) * 16 + k % 16
        assert packed[at] == qk[n, k], (n, k)
    # lane (g, t) of a warp reads row g, columns 4t .. 4t + 3 of a tile
    assert torch.equal(packed[4 * 5:4 * 5 + 4], qk[1, 4:8])


@pytest.mark.parametrize("n,frames", [(65, 1), (17, 3), (80, 1), (37, 1), (16, 5), (5, 13),
                                      (1, 16)])
def test_f32_instance_frames_per_block(n, frames):
    """The f32 instance packs as many frames of N tokens as fit in its 80
    rows with the last frame's keys padded to 16, at most 16."""
    inst = tst.fast_instance(128, 64, n, torch.float32)
    assert (inst.rows, inst.product_rows, inst.mlp_chunk) == (80, 80, 64)
    assert tst.fast_frames_per_block(n, 128, 64, torch.float32) == frames
    fits = lambda f: (f - 1) * n + -(-n // 16) * 16 <= inst.rows
    assert fits(frames) and (frames == tst.FAST_MAX_FRAMES or not fits(frames + 1))


def _instance(N, D, d_head, M, dtype):
    """The instance ``spatial_table`` would report for a call at these
    widths, or None where the kernel refuses it (the plain table runs)."""
    if tst.kernel_refusal(1, N, D, 2, 4, d_head, M, dtype) is not None:
        return None
    if tst.fast_applies(N, D, d_head, M, dtype):
        return tst.fast_instance_name(N, D, d_head, dtype)
    return "general"


@pytest.mark.parametrize("M", [1024, 512], ids=["MLP1024", "fusion_MLP512"])
def test_f32_routing(M):
    """f32 at the flagship widths: N 17 and 65 take the packed f32
    instance, N 81..257 one frame over an f32 cluster, N 258 and past are
    refused; an MLP that is no multiple of 64 keeps the general instance up
    to N 128 and is refused past it.
    bf16 routes are unchanged, and the demo widths (D 64) stay on the
    general instance in f32."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert _instance(65, 128, 64, M, f32) == "fast_f32_D128_F1"
    assert _instance(17, 128, 64, M, f32) == "fast_f32_D128_F3"
    for n, c in ((81, 2), (101, 2), (128, 2), (129, 3), (145, 3), (197, 4), (256, 4), (257, 5)):
        assert _instance(n, 128, 64, M, f32) == f"fast_f32_D128_N{n}_C{c}"
    for n in (258, 289, 401):
        assert _instance(n, 128, 64, M, f32) is None
        assert "N <= 257 in float32" in tst.kernel_refusal(1, n, 128, 2, 4, 64, M, f32)
    assert _instance(65, 128, 64, M + 16, f32) == "general"
    assert _instance(101, 128, 64, M + 16, f32) == "general"
    assert _instance(145, 128, 64, M + 16, f32) is None
    assert _instance(65, 128, 64, M, bf16) == "fast_D128_F2"
    assert _instance(17, 128, 64, M, bf16) == "fast_D128_F8"
    assert _instance(101, 128, 64, M, bf16) == "fast_D128_N101_C1"
    assert _instance(257, 128, 64, M, bf16) == "fast_D128_N257_C2"
    assert _instance(17, 64, 32, 256, bf16) == "fast_D64_F7"
    assert _instance(17, 64, 32, 256, f32) == "general"
    assert _instance(17, 96, 48, 192, f32) == "general"


@pytest.mark.parametrize("M", [1024, 512], ids=["MLP1024", "fusion_MLP512"])
def test_every_n_from_81_to_257_takes_an_f32_cluster(M):
    """Past 80 tokens at D 128 / d_head 64 in f32 one frame spreads over a
    cluster of blocks of 64 rows, C = ceil(ceil(N / 16) / 4) of them (at
    most four 16-row tiles a block: 2 up to N 128, 3 up to 192, 4 up to 256,
    5 at 257), MLP chunks of 64, any head count; the kernel's plan is asked
    for nothing a CPU cannot answer."""
    for N in range(81, 258):
        inst = tst.fast_instance(128, 64, N, torch.float32)
        C = -(-(-(-N // 16)) // tst.F32_CLUSTER_TILES)
        assert (inst.cluster, inst.mlp_chunk, inst.rows, inst.layout) == (C, 64, 64, "tile8x16")
        assert tst.fast_applies(N, 128, 64, M, torch.float32), N
        assert tst.fast_frames_per_block(N, 128, 64, torch.float32) == 1
        for n_heads in (4, 2):
            assert tst.kernel_refusal(1, N, 128, 2, n_heads, 64, M, torch.float32) is None, N
        assert tst.fast_instance_name(N, 128, 64, torch.float32) == f"fast_f32_D128_N{N}_C{C}"
    # the patch-16 crops of the stored 256 px frame past 128 px
    crops = [(c // 16) ** 2 + 1 for c in range(144, 257, 16)]
    assert crops == [82, 101, 122, 145, 170, 197, 226, 257]


def test_cluster_row_split():
    """A frame's rows over its cluster, at every N 81..257: every row in
    exactly one block, in whole 16-row tiles but the frame's last, at most
    64 rows (4 tiles) a block, the tile counts within one of each other and
    block 0 (the cls row's) among the smallest."""
    assert tst.cluster_row_split(257, 5) == [(0, 48), (48, 48), (96, 48), (144, 64), (208, 49)]
    assert tst.cluster_row_split(101, 2) == [(0, 48), (48, 53)]
    for N in range(81, 258):
        C = tst.fast_instance(128, 64, N, torch.float32).cluster
        split = tst.cluster_row_split(N, C)
        assert len(split) == C and split[0][0] == 0
        for (r0, n), (r1, _) in zip(split, split[1:]):
            assert r0 + n == r1 and n % 16 == 0
        assert split[-1][0] + split[-1][1] == N
        tiles = [-(-n // 16) for _, n in split]
        assert max(tiles) <= 4 and max(tiles) - min(tiles) <= 1 and tiles[0] == min(tiles)


def _cluster_walk(w, tokens, depth=2, n_heads=4, M=1024):
    N = tokens.shape[1]
    inst = tst.fast_instance(128, 64, N, torch.float32)
    packed = tst.pack_fast(w, depth, n_heads, torch.float32, mlp_chunk=inst.mlp_chunk,
                           layout=inst.layout)
    return tst.packed_walk_reference(tokens, packed, tst.pack_layer_norms(w, depth), w.base,
                                     depth, n_heads, 64, M, torch.float32,
                                     mlp_chunk=inst.mlp_chunk, layout=inst.layout, split=True,
                                     cluster=inst.cluster)


@pytest.mark.parametrize("image_size", [160, 192, 256], ids=["N101", "N145", "N257"])
def test_f32_cluster_walk_is_the_plain_function(image_size):
    """The f32 cluster's walk at the flagship widths (its stream in 8 x 16
    tiles and MLP chunks of 64, every product in split TF32, the attention
    over the blocks of its row split with a running max and sum and each
    block's P V summed apart, in two merged halves of the blocks, the last
    layer for the cls row, one merged part per block): the plain f32 table
    up to summation order and the split's ~2^-21 per product (1e-5)."""
    w, tokens = _flagship(image_size, frames=2)
    got = _cluster_walk(w, tokens)
    want = tst.spatial_table_reference(tokens, w, 4, compute_dtype=torch.float32)
    assert got.shape == want.shape == (4, 2, 128)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _large_logits(w, tokens, peak=80.0):
    """The bundle with every layer's q rows scaled so that the first layer's
    scores (offset 0) peak at |s| = ``peak``."""
    inner = w.w_qkv[0].shape[0] // 3
    h = tst._layer_norm(tokens + w.base[0, :tokens.shape[1]], w.ln_a_s[0], w.ln_a_b[0])
    q, k = h @ w.w_qkv[0][:inner].T, h @ w.w_qkv[0][inner:2 * inner].T
    s = torch.einsum("tnhd,tmhd->thnm", q.unflatten(-1, (-1, 64)), k.unflatten(-1, (-1, 64)))
    a = peak / float((s * 64 ** -0.5).abs().max())
    return w._replace(w_qkv=tuple(torch.cat([m[:inner] * a, m[inner:]]) for m in w.w_qkv))


def test_f32_cluster_walk_large_logits():
    """Scores up to |s| 80 at N 257: there the f32 rounding of the scores
    alone moves the table (the same walk without the split, summation order
    only, lands 1.6e-5 from the plain table on these draws), so the split
    walk is held to what it adds, 1e-5 beyond that, and to the limits the
    kernel is held to on the card (1e-4 + 1e-4 |x|, mean 1e-5)."""
    w, tokens = _flagship(256, frames=2)
    w = _large_logits(w, tokens)
    got = _cluster_walk(w, tokens)
    want = tst.spatial_table_reference(tokens, w, 4, compute_dtype=torch.float32)
    packed = tst.pack_fast(w, 2, 4, torch.float32, mlp_chunk=64, layout="tile8x16")
    order_only = tst.packed_walk_reference(tokens, packed, tst.pack_layer_norms(w, 2), w.base, 2,
                                           4, 64, 1024, torch.float32, mlp_chunk=64,
                                           layout="tile8x16")
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert float(err.max()) <= float((order_only - want).abs().max()) + 1e-5
    assert bool((err <= 1e-4 + 1e-4 * want.abs()).all()) and float(err.mean()) <= 1e-5


def test_f32_stream_is_cached_apart_from_bf16():
    """The f32 stream is packed once per bundle in its own layout, beside
    the bf16 one and the general f32 one."""
    w, _ = _flagship(64)
    cpu = torch.device("cpu")
    a = tst._packed_weights(w, 2, 4, torch.float32, cpu, mlp_chunk=64, layout="tile8x16")
    b = tst._packed_weights(w, 2, 4, torch.float32, cpu, mlp_chunk=64, layout="tile8x16")
    c = tst._packed_weights(w, 2, 4, torch.float32, cpu, mlp_chunk=0)
    d = tst._packed_weights(w, 2, 4, torch.bfloat16, cpu, mlp_chunk=64)
    assert a[0] is b[0] and a[0] is not c[0] and a[0] is not d[0]
    assert torch.equal(a[0], tst.pack_fast(w, 2, 4, torch.float32, 64, "tile8x16"))
    assert torch.equal(c[0], tst.pack_general(w, 2, torch.float32))
