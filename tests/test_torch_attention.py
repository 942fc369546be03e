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
