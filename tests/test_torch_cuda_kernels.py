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


def test_spatial_table_rejects_unsupported_shapes(dev):
    g = torch.Generator().manual_seed(0)
    model = ViViT(image_size=32, patch_size=16, n_frames=5, dim=40, depth=1, n_heads=2,
                  d_head=20, scale_dim=2, generator=g).to(dev)
    w = tst.extract_spatial_weights(model, 5, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="not supported"):
        tst.spatial_table(torch.zeros(4, 5, 40, device=dev), w, 5, 1, 2, 20)


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
