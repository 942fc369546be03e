"""kstar_torch fused_attention (CPU: the kernel's plain version) against the
kstar_tpu Pallas kernel in interpret mode, at ViViT's sequence lengths.

Both compute in f32 throughout; the tolerance covers summation order only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.ops import attention as tat
from kstar_tpu.ops import attention as jat

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(n, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 3, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [22, 65])
def test_matches_pallas_interpret(n):
    q, k, v = _qkv(n)
    scale = 64 ** -0.5
    want = np.asarray(jat.fused_attention(*map(jnp.asarray, (q, k, v)), scale, interpret=True))
    got = tat.fused_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32 and got.shape == (2, 3, n, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [22, 65])
def test_bf16_output_in_input_dtype(n):
    """bf16 inputs: computed in f32 from the bf16 values, cast once."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(n, seed=1))
    got = tat.fused_attention(q, k, v, 0.125)
    want = jat.fused_attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                 for x in (q, k, v)), 0.125, interpret=True)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at the output's magnitude
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_reference_attention_matches_jax():
    q, k, v = _qkv(65, seed=2)
    want = np.asarray(jat.reference_attention(*map(jnp.asarray, (q, k, v)), 0.125))
    got = tat.reference_attention(*map(torch.from_numpy, (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rejects_unsupported_device():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tat.fused_attention(q, q, q, 0.5)


# ---- the tensor-core instance's arithmetic, in plain PyTorch ---------------

def _bf16_case(n, d, seed, logit_peak=None):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, n, d)).astype(np.float32))
               for _ in range(3))
    scale = d ** -0.5
    if logit_peak is not None:
        q = q * (logit_peak / ((q @ k.transpose(-1, -2)) * scale).abs().max())
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), scale


@pytest.mark.parametrize("n,d", [(1, 64), (15, 16), (16, 32), (17, 64), (22, 64), (64, 128),
                                 (65, 64), (130, 64), (300, 32)])
def test_strip_emulation_hi_lo_within_kernel_tolerance(n, d):
    """16-query strips, keys in blocks padded to 16 and masked past N, the
    running max across blocks, P as a bf16 hi + lo pair: within the bf16
    kernel's tolerance (1e-2) of the plain version."""
    q, k, v, scale = _bf16_case(n, d, seed=n)
    got = tat.strip_attention_emulation(q, k, v, scale)
    want = tat.fused_attention_reference(q, k, v, scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("n", [65, 130, 300])
def test_strip_emulation_large_logits_running_max(n):
    """|s| up to 80 (exp(80) overflows bf16 and, summed, strains f32): the
    max is subtracted first, and across key blocks the partial output is
    rescaled. Forcing 32-key blocks makes every case cross blocks."""
    q, k, v, scale = _bf16_case(n, 64, seed=7, logit_peak=80.0)
    want = tat.fused_attention_reference(q, k, v, scale).float()
    for key_block in (None, 32):
        got = tat.strip_attention_emulation(q, k, v, scale, key_block=key_block).float()
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)


def test_strip_emulation_p_precision():
    """Why the kernel carries P as hi + lo: the pair is as good as an f32 P
    (the error left is the output's own rounding, one bf16 ulp), one bf16 P
    costs about another ulp."""
    q, k, v, scale = _bf16_case(65, 64, seed=11)
    want = tat.fused_attention_reference(q, k, v, scale).float()
    err = {mode: (tat.strip_attention_emulation(q, k, v, scale, p_mode=mode).float()
                  - want).abs() for mode in ("hi_lo", "bf16", "f32")}
    assert err["hi_lo"].max() <= err["f32"].max() + 2 ** -9
    assert err["hi_lo"].mean() <= 1.05 * err["f32"].mean() + 1e-6
    assert err["bf16"].mean() > 1.3 * err["hi_lo"].mean()


def test_strip_emulation_key_block_choice():
    assert tat.KEY_BLOCKS == (32, 80, 128)
    q, k, v, scale = _bf16_case(40, 64, seed=5)
    a = tat.strip_attention_emulation(q, k, v, scale)                 # one block of 80
    b = tat.strip_attention_emulation(q, k, v, scale, key_block=80)
    assert torch.equal(a, b)
