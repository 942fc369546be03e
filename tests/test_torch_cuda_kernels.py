"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. They need an NVIDIA Hopper card and nvcc, so they skip elsewhere;
run them with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``
on the GPU machine (chip_smoke.py makes the same checks at the flagship
shapes)."""

import pytest
import torch
import torch.nn.functional as F

from kstar_torch.models.vivit import ViViT
from kstar_torch.ops import attention as tat
from kstar_torch.ops import preprocess as tpp
from kstar_torch.ops import spatial_table as tst

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel vs plain: f32 differs in summation order only; bf16 may land one
# bf16 ulp apart at a cast point and carry it through two layers
TABLE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6.25e-2, 6.25e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("crop", [32, 16], ids=["N5", "N2"])
def test_spatial_table_kernel_matches_plain(dev, dtype, crop):
    g = torch.Generator().manual_seed(0)
    model = ViViT(image_size=32, patch_size=16, n_frames=5, dim=32, depth=2, n_heads=2,
                  d_head=16, scale_dim=2, generator=g).to(dev)
    n_tok = (crop // 16) ** 2
    tokens = F.pad(torch.randn(37, n_tok, 32, generator=g).to(dev, dtype), (0, 0, 1, 0))
    w = tst.extract_spatial_weights(model, 5, 2, dtype)
    before = tst.spatial_table.launches
    got = tst.spatial_table(tokens, w, 5, 2, 2, 16, dtype)
    torch.cuda.synchronize()
    assert tst.spatial_table.launches == before + 1
    want = tst.spatial_table_reference(tokens, w, 5, 2, 2, 16, dtype)
    atol, rtol = TABLE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def flagship():
    """The flagship ViViT (dim 128, depth 2, 4 heads x 64, MLP 1024, 128 px)
    with random weights, and 61 frames of zero-cls-padded random tokens."""
    g = torch.Generator().manual_seed(5)
    model = ViViT(generator=g)
    tokens = F.pad(torch.randn(61, 64, 128, generator=g), (0, 0, 1, 0))
    return model, tokens


def _table_case(dev, model, tokens, dtype, n_off=3, **widths):
    hp = dict(depth=2, n_heads=4, d_head=64)
    hp.update(widths)
    w = tst.extract_spatial_weights(model.to(dev), n_off, hp["depth"], dtype)
    x = tokens.to(dev, dtype)
    before = tst.spatial_table.launches
    got = tst.spatial_table(x, w, n_off, compute_dtype=dtype, **hp)
    torch.cuda.synchronize()
    assert tst.spatial_table.launches == before + 1
    want = tst.spatial_table_reference(x, w, n_off, compute_dtype=dtype, **hp)
    atol, rtol = TABLE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        assert (got.float() - want.float()).abs().mean() <= 2 ** -8
    return got


@pytest.mark.parametrize("n_tok", [65, 17, 5], ids=["N65", "N17", "N5"])
@pytest.mark.parametrize("t_case", ["1", "F-1", "F", "F+1", "61"])
def test_spatial_table_fast_instance_ragged_frames(dev, flagship, n_tok, t_case):
    """Flagship widths in bf16: F frames share a block (2 at N 65, 8 at
    N 17, the cap of 16 at N 5), and a frame count that is no multiple of F is masked at the
    edge."""
    model, tokens = flagship
    F_blk = tst.fast_frames_per_block(n_tok, 128, 64)
    T = {"1": 1, "F-1": max(F_blk - 1, 1), "F": F_blk, "F+1": F_blk + 1, "61": 61}[t_case]
    _table_case(dev, model, tokens[:T, :n_tok], torch.bfloat16)
    assert tst.spatial_table.instance == f"fast_D128_F{F_blk}"


def test_spatial_table_fast_instance_frames_do_not_mix(dev, flagship):
    """Frames that share a block do not see each other: a frame's row of the
    table is the same whichever neighbours it is packed with."""
    model, tokens = flagship
    full = _table_case(dev, model, tokens[:9], torch.bfloat16)
    shifted = _table_case(dev, model, tokens[1:9], torch.bfloat16)
    assert torch.equal(full[:, 1:], shifted)


def test_spatial_table_fast_instance_misaligned_tokens(dev, flagship):
    """Tokens that start 2 bytes into their storage are copied to an aligned
    buffer by the wrapper (the fast instance loads 16 bytes at a time)."""
    model, tokens = flagship
    t = tokens[:5].to(dev, torch.bfloat16)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    buf[1:] = t.reshape(-1)
    _table_case(dev, model, buf[1:].view(t.shape), torch.bfloat16)
    assert tst.spatial_table.instance.startswith("fast")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spatial_table_general_instance_at_flagship_like_widths(dev, dtype):
    """A width no fast instance is compiled for (dim 96, 2 heads x 48, MLP
    192) and f32 at any width take the general instance."""
    g = torch.Generator().manual_seed(6)
    model = ViViT(image_size=64, patch_size=16, n_frames=5, dim=96, depth=2, n_heads=2,
                  d_head=48, scale_dim=2, generator=g)
    tokens = F.pad(torch.randn(7, 16, 96, generator=g), (0, 0, 1, 0))
    _table_case(dev, model, tokens, dtype, n_heads=2, d_head=48)
    assert tst.spatial_table.instance == "general"


@pytest.fixture(scope="module")
def demo_vivit():
    """exp/demo_vivit.sh's ViViT (64 px, dim 64, depth 2, 4 heads x 32, MLP
    256) with random weights, and 61 frames of zero-cls-padded tokens."""
    g = torch.Generator().manual_seed(9)
    model = ViViT(image_size=64, patch_size=16, n_frames=5, dim=64, depth=2, n_heads=4,
                  d_head=32, scale_dim=4, generator=g)
    tokens = F.pad(torch.randn(61, 16, 64, generator=g), (0, 0, 1, 0))
    return model, tokens


@pytest.mark.parametrize("t_case", ["1", "F-1", "F", "F+1", "61"])
def test_spatial_table_demo_instance_ragged_frames(dev, demo_vivit, t_case):
    """The demo ViViT's widths in bf16 take the fast instance compiled for
    D 64 / d_head 32 (7 frames of 17 tokens per block), and a frame count
    that is no multiple of 7 is masked at the edge."""
    model, tokens = demo_vivit
    F_blk = tst.fast_frames_per_block(17, 64, 32)
    assert F_blk == 7
    T = {"1": 1, "F-1": F_blk - 1, "F": F_blk, "F+1": F_blk + 1, "61": 61}[t_case]
    _table_case(dev, model, tokens[:T], torch.bfloat16, n_off=5, n_heads=4, d_head=32)
    assert tst.spatial_table.instance == "fast_D64_F7"


def test_spatial_table_demo_instance_frames_do_not_mix(dev, demo_vivit):
    """Frames that share a block of the demo-width instance do not see each
    other: a frame's row is the same whichever neighbours it is packed
    with."""
    model, tokens = demo_vivit
    hp = dict(n_off=5, n_heads=4, d_head=32)
    full = _table_case(dev, model, tokens[:15], torch.bfloat16, **hp)
    shifted = _table_case(dev, model, tokens[1:15], torch.bfloat16, **hp)
    assert torch.equal(full[:, 1:], shifted)


@pytest.mark.parametrize("n_tok,frames", [(5, 16), (65, 1)], ids=["N5", "N65"])
def test_spatial_table_demo_instance_other_crops(dev, n_tok, frames):
    """Other crops at the demo widths (and an MLP of 192, three chunks of
    64) take the same instance with the frames per block their N allows."""
    g = torch.Generator().manual_seed(10)
    model = ViViT(image_size=128, patch_size=16, n_frames=5, dim=64, depth=2, n_heads=2,
                  d_head=32, scale_dim=3, generator=g)
    tokens = F.pad(torch.randn(23, n_tok - 1, 64, generator=g), (0, 0, 1, 0))
    _table_case(dev, model, tokens, torch.bfloat16, n_heads=2, d_head=32)
    assert tst.spatial_table.instance == f"fast_D64_F{frames}"


def test_spatial_table_fast_instances_fit_the_card(dev):
    """Each fast instance as the card takes it: the demo width's block fits
    twice on an SM, the flagship's once."""
    demo = tst.fast_kernel_attributes(64, 32)
    flagship = tst.fast_kernel_attributes(128, 64)
    assert demo["blocks_per_sm"] == 2 and demo["threads"] == 256
    assert flagship["blocks_per_sm"] == 1 and flagship["threads"] == 384
    assert demo["registers"] <= 128 and flagship["registers"] <= 168


def test_spatial_table_f32_flagship_takes_the_f32_instance(dev, flagship):
    """f32 at the flagship widths no longer takes the general instance: up
    to 80 tokens (N 65, N 17) the packed f32 instance (split-TF32 products)
    takes the call, within the f32 limits of the plain version; past it (N
    101) an f32 cluster of two blocks does; where no instance takes the call
    (N 145, an MLP of 368) it is refused."""
    model, tokens = flagship
    _table_case(dev, model, tokens[:3], torch.float32, n_off=2)
    assert tst.spatial_table.instance == "fast_f32_D128_F1"
    _table_case(dev, model, tokens[:7, :17], torch.float32, n_off=2)
    assert tst.spatial_table.instance == "fast_f32_D128_F3"
    g = torch.Generator().manual_seed(13)
    wide = ViViT(image_size=160, generator=g)
    x = F.pad(torch.randn(3, 100, 128, generator=g), (0, 0, 1, 0))
    assert tst.kernel_refusal(3, 101, 128, 2, 4, 64, 1024, torch.float32, dev) is None
    _table_case(dev, wide, x, torch.float32, n_off=2)
    assert tst.spatial_table.instance == "fast_f32_D128_N101_C2"
    odd = ViViT(image_size=192, scale_dim=3, generator=g).to(dev)     # MLP 384: chunks of 64
    w = tst.extract_spatial_weights(odd, 2, 2, torch.float32)
    w = w._replace(w_ff1=tuple(m[:368] for m in w.w_ff1), b_ff1=tuple(b[:368] for b in w.b_ff1),
                   w_ff2=tuple(m[:, :368] for m in w.w_ff2))            # MLP 368: none
    with pytest.raises(ValueError, match="not supported"):
        tst.spatial_table(F.pad(torch.randn(2, 144, 128, generator=g), (0, 0, 1, 0)).to(dev),
                          w, 2, compute_dtype=torch.float32)


@pytest.mark.parametrize("n_tok", [65, 17, 5, 80], ids=["N65", "N17", "N5", "N80"])
@pytest.mark.parametrize("t_case", ["1", "F-1", "F", "F+1", "61"])
def test_spatial_table_f32_instance_ragged_frames(dev, flagship, n_tok, t_case):
    """The f32 instance at the flagship widths: F frames share a block (1
    at N 65 and 80, 3 at N 17, 13 at N 5) and a frame count that is no
    multiple of F is masked at the edge; within TABLE_TOL[float32]."""
    model, tokens = flagship
    F_blk = tst.fast_frames_per_block(n_tok, 128, 64, torch.float32)
    T = {"1": 1, "F-1": max(F_blk - 1, 1), "F": F_blk, "F+1": F_blk + 1, "61": 61}[t_case]
    x = tokens[:T, :n_tok]
    if n_tok > tokens.shape[1]:
        g = torch.Generator().manual_seed(14)
        x = F.pad(torch.randn(T, n_tok - 1, 128, generator=g), (0, 0, 1, 0))
        model = ViViT(image_size=144, generator=g)
    _table_case(dev, model, x, torch.float32)
    assert tst.spatial_table.instance == f"fast_f32_D128_F{F_blk}"


def test_spatial_table_f32_instance_frames_do_not_mix(dev, flagship):
    """Frames that share a block of the f32 instance do not see each other."""
    model, tokens = flagship
    full = _table_case(dev, model, tokens[:9, :17], torch.float32)
    shifted = _table_case(dev, model, tokens[1:9, :17], torch.float32)
    assert torch.equal(full[:, 1:], shifted)


@pytest.mark.parametrize("M", [1024, 512], ids=["MLP1024", "MLP512"])
def test_spatial_table_f32_instance_at_the_fusion_mlp(dev, M):
    g = torch.Generator().manual_seed(15)
    model = ViViT(scale_dim=M // 128, generator=g)
    tokens = F.pad(torch.randn(11, 64, 128, generator=g), (0, 0, 1, 0))
    _table_case(dev, model, tokens, torch.float32)
    assert tst.spatial_table.instance == "fast_f32_D128_F1"


@pytest.mark.parametrize("depth,n_heads,scale_dim", [(1, 4, 8), (3, 2, 3)],
                         ids=["depth1", "depth3_2heads_MLP384"])
def test_spatial_table_f32_instance_other_depths_and_heads(dev, depth, n_heads, scale_dim):
    """The f32 instance at D 128 / d_head 64 with one layer (the last layer
    is the first: its cls tiles start from a zeroed q region) and with
    three layers of two heads and an MLP of 384 (six chunks of 64)."""
    g = torch.Generator().manual_seed(16)
    model = ViViT(depth=depth, n_heads=n_heads, scale_dim=scale_dim, generator=g)
    tokens = F.pad(torch.randn(9, 64, 128, generator=g), (0, 0, 1, 0))
    _table_case(dev, model, tokens, torch.float32, depth=depth, n_heads=n_heads)
    assert tst.spatial_table.instance == "fast_f32_D128_F1"


def test_spatial_table_f32_instance_fits_the_card(dev):
    """The f32 instance as the card takes it: 256 threads, one block per
    SM, its 226,816 bytes of shared memory."""
    att = tst.fast_kernel_attributes(128, 64, 65, torch.float32)
    assert att["threads"] == 256 and att["blocks_per_sm"] == 1
    assert att["dynamic_smem_bytes"] == 226816 and att["cluster_size"] == 1


def test_spatial_table_rejects_unsupported_shapes(dev):
    g = torch.Generator().manual_seed(0)
    model = ViViT(image_size=32, patch_size=16, n_frames=5, dim=40, depth=1, n_heads=2,
                  d_head=20, scale_dim=2, generator=g).to(dev)
    w = tst.extract_spatial_weights(model, 5, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="not supported"):
        tst.spatial_table(torch.zeros(4, 5, 40, device=dev), w, 5, 1, 2, 20)


@pytest.mark.parametrize("n_tok", [65, 17], ids=["N65", "N17"])
def test_spatial_table_fast_instance_at_the_fusion_mlp(dev, n_tok):
    """The fusion CLI's ViViT (scale_dim 4: an MLP of 512, not 1024) takes
    the fast instance and matches the plain version."""
    g = torch.Generator().manual_seed(7)
    model = ViViT(scale_dim=4, generator=g)
    tokens = F.pad(torch.randn(37, n_tok - 1, 128, generator=g), (0, 0, 1, 0))
    _table_case(dev, model, tokens, torch.bfloat16)
    assert tst.spatial_table.instance == f"fast_D128_F{tst.fast_frames_per_block(n_tok, 128, 64)}"


def test_video_sweep_falls_back_where_the_kernel_refuses(dev):
    """N = 401 tokens (patch 4 over 80 px), past the kernel's largest
    instance: ``use_fused_table=None`` builds the plain table on the GPU
    without a launch, ``True`` raises; at patch 16 the same sweeper
    launches the kernel once per shot."""
    import numpy as np

    from kstar_torch.infer.continuous import VideoSweeper

    model = ViViT(image_size=80, patch_size=4, n_frames=5, dim=128, depth=1, n_heads=2,
                  d_head=64, scale_dim=2, generator=torch.Generator().manual_seed(8))
    frames = np.random.default_rng(0).integers(0, 255, (40, 80, 80, 3), dtype=np.uint8)
    starts = np.arange(30)
    before = tst.spatial_table.launches
    plain = VideoSweeper(model, 5, 80, 16, torch.bfloat16, device=dev)
    p_none = plain.sweep(frames, starts)
    assert plain.fused_table_active is False and tst.spatial_table.launches == before
    forced = VideoSweeper(model, 5, 80, 16, torch.bfloat16, use_fused_table=False, device=dev)
    np.testing.assert_array_equal(p_none, forced.sweep(frames, starts))
    with pytest.raises(ValueError, match="not supported"):
        VideoSweeper(model, 5, 80, 16, torch.bfloat16, use_fused_table=True, device=dev)
    small = VideoSweeper(model, 5, 16, 16, torch.bfloat16, device=dev)
    assert small.fused_table_active is True
    small.sweep(frames, starts)
    assert tst.spatial_table.launches == before + 1


def test_video_sweep_takes_the_kernel_at_257_tokens(dev):
    """N = 257 tokens (patch 4 over 64 px, the shape the kernel refused
    before its cluster instance): ``use_fused_table=None`` takes the kernel,
    launches it once per shot, and its curve is the plain table's within
    the sweep's limits (max 0.05, mean 5e-3)."""
    import numpy as np

    from kstar_torch.infer.continuous import VideoSweeper

    model = ViViT(image_size=64, patch_size=4, n_frames=5, dim=128, depth=1, n_heads=2,
                  d_head=64, scale_dim=2, generator=torch.Generator().manual_seed(8))
    frames = np.random.default_rng(0).integers(0, 255, (40, 64, 64, 3), dtype=np.uint8)
    starts = np.arange(30)
    before = tst.spatial_table.launches
    fused = VideoSweeper(model, 5, 64, 16, torch.bfloat16, device=dev)
    assert fused.fused_table_active is True
    p_kernel = fused.sweep(frames, starts)
    assert tst.spatial_table.launches == before + 1
    assert tst.spatial_table.instance == "fast_D128_N257_C2"
    p_plain = VideoSweeper(model, 5, 64, 16, torch.bfloat16, use_fused_table=False,
                           device=dev).sweep(frames, starts)
    err = np.abs(p_kernel - p_plain)
    assert np.isfinite(p_kernel).all() and err.max() <= 5e-2 and err.mean() <= 5e-3


@pytest.fixture(scope="module")
def full_frame():
    """The flagship ViViT at image_size 256 (a positional embedding for 257
    tokens) with random weights, an MLP of 1024 and of 512, and 23 frames
    of zero-cls-padded random tokens at the full frame."""
    g = torch.Generator().manual_seed(12)
    models = {M: ViViT(image_size=256, scale_dim=M // 128, generator=g) for M in (1024, 512)}
    tokens = F.pad(torch.randn(23, 256, 128, generator=g), (0, 0, 1, 0))
    return models, tokens


@pytest.mark.parametrize("M", [1024, 512], ids=["MLP1024", "MLP512"])
@pytest.mark.parametrize("n_tok", [81, 101, 144, 145, 197, 257])
def test_spatial_table_one_frame_instances(dev, full_frame, n_tok, M):
    """Past 80 tokens at the flagship widths in bf16: one frame a block up
    to 144 tokens, one frame over a two-block cluster up to 257 (the
    patch-16 crops of the stored 256 px frame), each against the plain
    version; frames are independent (a frame's row is the same in another
    call)."""
    models, tokens = full_frame
    x = tokens[:, :n_tok]
    full = _table_case(dev, models[M], x, torch.bfloat16)
    assert tst.spatial_table.instance == f"fast_D128_N{n_tok}_C{1 if n_tok <= 144 else 2}"
    assert torch.equal(full[:, 3:5], _table_case(dev, models[M], x[3:5], torch.bfloat16))


def test_spatial_table_one_frame_instances_fit_the_card(dev):
    """The one-frame instances as the card takes them: one block per SM,
    384 threads; the cluster instance's two blocks fit beside each other."""
    one = tst.fast_kernel_attributes(128, 64, 101)
    two = tst.fast_kernel_attributes(128, 64, 257)
    assert one["blocks_per_sm"] == 1 and one["threads"] == 384 and one["cluster_size"] == 1
    assert two["blocks_per_sm"] == 1 and two["threads"] == 384 and two["cluster_size"] == 2
    assert two["active_clusters"] >= 1 and two["dynamic_smem_bytes"] <= 232448


# the f32 cluster's shapes: the patch-16 crops of the stored 256 px frame
# past 128 px (101, 145, 197, 257) and the edges of each cluster size
F32_CLUSTER_N = [81, 101, 128, 129, 145, 160, 161, 192, 193, 197, 240, 241, 256, 257]


def _f32_cluster_name(n_tok):
    return f"fast_f32_D128_N{n_tok}_C{tst.fast_instance(128, 64, n_tok, torch.float32).cluster}"


@pytest.mark.parametrize("M", [1024, 512], ids=["MLP1024", "MLP512"])
@pytest.mark.parametrize("n_tok", F32_CLUSTER_N)
def test_spatial_table_f32_cluster_instances(dev, full_frame, n_tok, M):
    """Past 80 tokens at the flagship widths in f32: one frame over a
    cluster of 64-row blocks of the f32 instance (2 up to N 128, 3 up to
    192, 4 up to 256, 5 at 257), 23 frames, against the plain version within
    TABLE_TOL[float32] and a mean of 1e-5; frames are independent (a frame's
    row is the same in another call)."""
    models, tokens = full_frame
    x = tokens[:, :n_tok]
    full = _table_case(dev, models[M], x, torch.float32)
    assert tst.spatial_table.instance == _f32_cluster_name(n_tok)
    want = tst.spatial_table_reference(x.to(dev), tst.extract_spatial_weights(
        models[M], 3, 2, torch.float32), 3, compute_dtype=torch.float32)
    assert float((full - want).abs().mean()) <= 1e-5
    assert torch.equal(full[:, 3:5], _table_case(dev, models[M], x[3:5], torch.float32))


@pytest.mark.parametrize("n_tok", [101, 197, 257])
def test_spatial_table_f32_cluster_two_heads(dev, n_tok):
    """Two heads of 64 (inner 128), MLP 512, one layer and three layers."""
    g = torch.Generator().manual_seed(17)
    for depth in (1, 3):
        model = ViViT(image_size=256, n_heads=2, depth=depth, scale_dim=4, generator=g)
        x = F.pad(torch.randn(9, n_tok - 1, 128, generator=g), (0, 0, 1, 0))
        _table_case(dev, model, x, torch.float32, depth=depth, n_heads=2)
        assert tst.spatial_table.instance == _f32_cluster_name(n_tok)


def _large_logits(w, x, peak=80.0):
    """The bundle with every layer's q rows scaled so that the first layer's
    scores (offset 0) peak at |s| = ``peak``."""
    inner = w.w_qkv[0].shape[0] // 3
    h = tst._layer_norm(x + w.base[0, :x.shape[1]], w.ln_a_s[0], w.ln_a_b[0])
    q, k = h @ w.w_qkv[0][:inner].T, h @ w.w_qkv[0][inner:2 * inner].T
    s = torch.einsum("tnhd,tmhd->thnm", q.unflatten(-1, (-1, 64)), k.unflatten(-1, (-1, 64)))
    a = peak / float((s * 64 ** -0.5).abs().max())
    return w._replace(w_qkv=tuple(torch.cat([m[:inner] * a, m[inner:]]) for m in w.w_qkv))


@pytest.mark.parametrize("n_tok", [101, 145, 257])
def test_spatial_table_f32_cluster_large_logits(dev, full_frame, n_tok):
    """Scores up to |s| 80 (every layer's q rows scaled): the cluster's
    exponentials, running max and merged parts stay within the f32 limits
    of the plain version (1e-4 + 1e-4 |x|, mean 1e-5)."""
    models, tokens = full_frame
    x = tokens[:7, :n_tok].to(dev)
    w = _large_logits(tst.extract_spatial_weights(models[1024].to(dev), 3, 2, torch.float32), x)
    got = tst.spatial_table(x, w, 3, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tst.spatial_table.instance == _f32_cluster_name(n_tok)
    want = tst.spatial_table_reference(x, w, 3, compute_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert float((got - want).abs().mean()) <= 1e-5


@pytest.mark.parametrize("n_tok", [101, 145, 197, 257])
def test_spatial_table_f32_cluster_fits_the_card(dev, n_tok):
    """The f32 cluster as the card takes it: 256 threads and one block an
    SM, its shared memory under the device's opt-in limit, no spill (as
    ptxas reports it), the cluster size of its N, and clusters of it
    resident."""
    from kstar_torch.ops import _build

    att = tst.fast_kernel_attributes(128, 64, n_tok, torch.float32)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert att["threads"] == 256 and att["blocks_per_sm"] == 1 and att["registers"] <= 255
    assert att["dynamic_smem_bytes"] + att["static_smem_bytes"] <= limit
    report = _build.ptxas_report("spatial_table")
    assert _build.spills(report, ("spatial_table_tf32_kernel", "ELi257E")) == (0, 0)
    assert att["cluster_size"] == tst.fast_instance(128, 64, n_tok, torch.float32).cluster
    assert att["active_clusters"] > 0


def test_video_sweep_takes_the_f32_cluster_at_257_tokens(dev):
    """An f32 sweep at 257 tokens (patch 4 over 64 px) takes the f32
    cluster with ``use_fused_table=None`` and with ``True``, one launch a
    shot, and its curve is the plain f32 table's within the f32 curve
    limits (1e-4, mean 1e-5)."""
    import numpy as np

    from kstar_torch.infer.continuous import VideoSweeper

    model = ViViT(image_size=64, patch_size=4, n_frames=5, dim=128, depth=1, n_heads=2,
                  d_head=64, scale_dim=2, generator=torch.Generator().manual_seed(8))
    frames = np.random.default_rng(0).integers(0, 255, (40, 64, 64, 3), dtype=np.uint8)
    starts = np.arange(30)
    for fused in (None, True):
        before = tst.spatial_table.launches
        sw = VideoSweeper(model, 5, 64, 16, torch.float32, use_fused_table=fused, device=dev)
        assert sw.fused_table_active is True
        p_kernel = sw.sweep(frames, starts)
        assert tst.spatial_table.launches == before + 1
        assert tst.spatial_table.instance == "fast_f32_D128_N257_C5"
    p_plain = VideoSweeper(model, 5, 64, 16, torch.float32, use_fused_table=False,
                           device=dev).sweep(frames, starts)
    err = np.abs(p_kernel - p_plain)
    assert np.isfinite(p_kernel).all() and err.max() <= 1e-4 and err.mean() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(22, 64), (65, 64), (130, 32), (7, 256)])
def test_fused_attention_kernel_matches_plain(dev, dtype, n, d):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(3, 4, n, d, generator=g, device=dev).to(dtype) for _ in range(3))
    before = tat.fused_attention.launches
    got = tat.fused_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert tat.fused_attention.launches == before + 1
    want = tat.fused_attention_reference(q, k, v, d ** -0.5)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _attention_case(dev, dtype, n, d, logit_peak=None, seed=3):
    """q, k, v (3, 4, n, d) on the card; with ``logit_peak`` q is scaled so
    that the largest |logit| reaches it (the running-max path)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(3, 4, n, d, generator=g, device=dev) for _ in range(3))
    scale = d ** -0.5
    if logit_peak is not None:
        q = q * (logit_peak / ((q @ k.transpose(-1, -2)) * scale).abs().max())
    return q.to(dtype), k.to(dtype), v.to(dtype), scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 40])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 64, 65, 130])
def test_fused_attention_kernel_shapes(dev, dtype, n, d):
    """Every strip and key-block edge, the widths of both instances (40 and
    256 take the scalar one in bf16 too, f32 also past 80 keys), against the
    plain version."""
    q, k, v, scale = _attention_case(dev, dtype, n, d)
    got = tat.fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    # f32 takes its tensor-core instance only up to 80 keys
    tensor_cores = d in (16, 32, 64, 128) and (dtype == torch.bfloat16 or n <= 80)
    kind = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert tat.fused_attention.instance.startswith(kind if tensor_cores else "scalar")
    want = tat.fused_attention_reference(q, k, v, scale)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [65, 130, 300])
def test_fused_attention_kernel_large_logits(dev, dtype, n):
    """|s| up to 80: exp(s) alone would overflow bf16's and strain f32's
    range, so the (running) max must be subtracted first; 130 and 300 keys
    cross key blocks, where the running max rescales the partial output."""
    q, k, v, scale = _attention_case(dev, dtype, n, 64, logit_peak=80.0)
    got = tat.fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    want = tat.fused_attention_reference(q, k, v, scale)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_attention_kernel_noncontiguous_and_misaligned(dev, dtype):
    """A permuted q (made contiguous by the wrapper) and inputs that start
    one element into their storage (bf16: no 16-byte alignment, so the
    scalar instance)."""
    q, k, v, scale = _attention_case(dev, dtype, 65, 64)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)      # same values, other strides
    assert not qt.is_contiguous()
    got = tat.fused_attention(qt, k, v, scale)
    want = tat.fused_attention_reference(q, k, v, scale)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    got = tat.fused_attention(shifted(q), shifted(k), shifted(v), scale)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert tat.fused_attention.instance == "scalar"
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_fused_attention_emulation_tracks_the_kernel(dev):
    """The plain-PyTorch walk of the tensor-core instance's arithmetic (the
    CPU tests' stand-in) lands within one bf16 ulp of the kernel."""
    q, k, v, scale = _attention_case(dev, torch.bfloat16, 65, 64)
    got = tat.fused_attention(q, k, v, scale).float().cpu()
    emu = tat.strip_attention_emulation(q.cpu(), k.cpu(), v.cpu(), scale).float()
    torch.testing.assert_close(got, emu, atol=2 ** -8, rtol=2 ** -7)


@pytest.mark.parametrize("shape", [(168, 4, 65, 64), (8, 4, 22, 64), (336, 4, 65, 64),
                                   (16, 4, 22, 64)])
def test_fused_attention_f32_takes_its_tensor_core_instance(dev, shape):
    """f32 at ViViT's shapes (chip_smoke.py's rows) takes the split-TF32
    tensor-core instance, within ATTN_TOL of the plain version."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    got = tat.fused_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    block = 32 if shape[2] <= 32 else 80
    assert tat.fused_attention.instance == f"tf32x3_keys{block}"
    want = tat.fused_attention_reference(q, k, v, 0.125)
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("n", [22, 65, 80])
def test_fused_attention_f32_large_logits_against_f64(dev, n):
    """|s| up to 80 on the split-TF32 instance, against an f64 softmax: at
    that scale the f32 rounding of the scores alone moves any f32
    computation by ~2e-5 (the plain version too), so the kernel is held to
    the plain version's own distance from f64 plus half of ATTN_TOL, what
    the split adds (tests/test_torch_split_tf32.py)."""
    q, k, v, scale = _attention_case(dev, torch.float32, n, 64, logit_peak=80.0)
    got = tat.fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert tat.fused_attention.instance.startswith("tf32x3")
    exact = torch.softmax((q.double() @ k.double().transpose(-1, -2)) * scale, -1) @ v.double()
    plain = tat.fused_attention_reference(q, k, v, scale).double()
    plain_err = float((plain - exact).abs().max())
    assert bool(torch.isfinite(got).all())
    assert float((got.double() - exact).abs().max()) <= plain_err + ATTN_TOL[torch.float32] / 2


def test_fused_attention_f32_emulation_tracks_the_kernel(dev):
    """The plain-PyTorch walk of the f32 instance's split-TF32 arithmetic
    lands within ATTN_TOL of the kernel (summation order only)."""
    q, k, v, scale = _attention_case(dev, torch.float32, 80, 64)
    got = tat.fused_attention(q, k, v, scale).cpu()
    emu = tat.strip_attention_emulation(q.cpu(), k.cpu(), v.cpu(), scale, p_mode="split_tf32")
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got, emu, atol=tol, rtol=tol)


def test_fused_attention_rejects_wide_heads(dev):
    q = torch.zeros(1, 1, 4, 264, device=dev)
    with pytest.raises(ValueError, match="not supported"):
        tat.fused_attention(q, q, q, 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw,skip", [((128, 128), 0), ((64, 64), 0), ((5, 7), 0),
                                     ((16, 16), 1), ((5, 5), 1)],
                         ids=["128", "64", "5x7-scalar", "16-offset", "5-misaligned"])
def test_gather_normalize_kernel_equals_plain(dev, dtype, hw, skip):
    """Exact (uint8 minus an integer mean is representable): vector path,
    scalar path for a frame that is no multiple of the chunk, and frames
    that start ``skip`` frames into their storage (a view, as the streaming
    buffer's tail is)."""
    g = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (41, *hw, 3), dtype=torch.uint8, generator=g).to(dev)[skip:]
    starts = torch.tensor([-9, -1, 0, 7, 18, 19, 20, 36, 39, 500], device=dev)
    before = tpp.gather_normalize.launches
    got = tpp.gather_normalize(frames, starts, 21, dtype)
    torch.cuda.synchronize()
    assert tpp.gather_normalize.launches == before + 1
    assert torch.equal(got, tpp.gather_normalize_reference(frames, starts, 21, dtype))


@pytest.mark.parametrize("seq_len", [20, 21], ids=["L20-SlowFast", "L21-R2Plus1D"])
def test_gather_normalize_at_the_conv_sweep_chunk(dev, seq_len):
    """The conv models' sweep chunk: 128 windows of 20 (SlowFast) or 21
    (R(2+1)D) frames from a 4096-frame 128 px shot, bf16, exact."""
    g = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (4096, 128, 128, 3), dtype=torch.uint8,
                           generator=g).to(dev)
    starts = torch.arange(128, device=dev) + 4096 - 128 - seq_len
    got = tpp.gather_normalize(frames, starts, seq_len, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (128, seq_len, 128, 128, 3)
    assert torch.equal(got, tpp.gather_normalize_reference(frames, starts, seq_len,
                                                           torch.bfloat16))


def test_gather_normalize_offsets_beyond_2_31_bytes(dev):
    frames = torch.zeros(45_000, 128, 128, 3, dtype=torch.uint8, device=dev)  # 2.2 GB
    frames[-30:] = torch.randint(0, 256, (30, 128, 128, 3), dtype=torch.uint8, device=dev)
    starts = torch.tensor([44_970, 44_975, 44_999], device=dev)
    got = tpp.gather_normalize(frames, starts, 21)
    torch.cuda.synchronize()
    assert torch.equal(got, tpp.gather_normalize_reference(frames, starts, 21))


def test_gather_normalize_rejects_on_the_gpu(dev):
    with pytest.raises(ValueError, match="channels"):
        tpp.gather_normalize(torch.zeros(4, 8, 8, 4, dtype=torch.uint8, device=dev),
                             torch.zeros(2, dtype=torch.int64, device=dev), 2)
    with pytest.raises(ValueError, match="not supported"):
        tpp.gather_normalize(torch.zeros(4, 8, 8, 3, dtype=torch.uint8, device=dev),
                             torch.zeros(2, dtype=torch.int64, device=dev), 2, torch.float16)
