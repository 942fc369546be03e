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
