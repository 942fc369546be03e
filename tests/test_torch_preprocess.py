"""kstar_torch window gather + normalise against the kstar_tpu versions (the
XLA definition and the Pallas kernel in interpret mode) on the same seeded
frames. uint8 values minus integer means are exact in f32 and bf16, so the
tolerance is 0 everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.ops import preprocess as tp
from kstar_tpu.ops import preprocess as jp

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# inside the shot; clipped at both ends (start -1 reads frame 0, 39 reads past T-1)
STARTS = {"inside": [0, 5, 17, 35], "clipped": [-7, -1, 33, 36, 39, 60]}
T, L = 40, 4


def _frames(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (T, h, w, 3), dtype=np.uint8)


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") else x.float().numpy()


@pytest.mark.parametrize("starts", STARTS.values(), ids=STARTS.keys())
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_matches_xla_and_pallas(dtype, starts):
    tdt, jdt = dtype
    frames = _frames(16, 128)          # 128*3 lanes, 16 sublanes: Mosaic's tiling
    assert jp.supports_shape(16, 128)
    starts = np.asarray(starts, np.int64)
    want = jp.gather_normalize_xla(jnp.asarray(frames), jnp.asarray(starts), L, jdt)
    pallas = jp.gather_normalize_pallas(jnp.asarray(frames), jnp.asarray(starts), L,
                                        jdt, interpret=True)
    ref = tp.gather_normalize_reference(torch.from_numpy(frames),
                                        torch.from_numpy(starts), L, tdt)
    got = tp.gather_normalize(torch.from_numpy(frames), torch.from_numpy(starts), L, tdt)
    assert got.dtype == ref.dtype == tdt
    assert got.shape == ref.shape == (len(starts), L, 16, 128, 3)
    for other in (pallas, ref, got):
        np.testing.assert_array_equal(_f32(other), _f32(want))


@pytest.mark.parametrize("hw", [(16, 16), (5, 7), (1, 1)], ids=str)
def test_odd_sizes_match_xla(hw):
    frames = _frames(*hw, seed=1)
    starts = np.asarray(STARTS["clipped"], np.int64)
    want = jp.gather_normalize_xla(jnp.asarray(frames), jnp.asarray(starts), L, jnp.float32)
    got = tp.gather_normalize(torch.from_numpy(frames), torch.from_numpy(starts), L,
                              torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matches_the_inline_gathers_of_streaming_and_the_sweep():
    """Subtracting in bf16 (streaming.py:83, continuous.py:234 of the JAX
    package) equals subtract-in-f32-then-round."""
    frames = torch.from_numpy(_frames(8, 8, seed=2))
    starts = torch.arange(6)
    idx = starts[:, None] + torch.arange(L)[None, :] + 1
    inline = frames[idx].to(torch.bfloat16) - torch.tensor(
        tp.PIXEL_MEAN_BGR, dtype=torch.bfloat16)
    got = tp.gather_normalize(frames, starts, L, torch.bfloat16)
    assert torch.equal(got, inline)


def test_int32_starts_and_empty_batch():
    frames = torch.from_numpy(_frames(4, 4))
    a = tp.gather_normalize(frames, torch.tensor([3, 9], dtype=torch.int32), L)
    b = tp.gather_normalize(frames, torch.tensor([3, 9]), L)
    assert torch.equal(a, b)
    assert tp.gather_normalize(frames, torch.zeros(0, dtype=torch.int64), L).shape \
        == (0, L, 4, 4, 3)


@pytest.mark.parametrize("h,w,c,ok", [
    (128, 128, 3, True), (64, 64, 3, True), (5, 7, 3, True), (1, 1, 3, True),
    (128, 128, 1, False), (128, 128, 4, False), (0, 128, 3, False),
    (4096, 4096, 3, False)])
def test_supports_shape(h, w, c, ok):
    assert tp.supports_shape(h, w, c) is ok


@pytest.mark.parametrize("frames,starts", [
    (torch.zeros(4, 8, 8, 1, dtype=torch.uint8), torch.zeros(2, dtype=torch.int64)),
    (torch.zeros(4, 8, 8, 4, dtype=torch.uint8), torch.zeros(2, dtype=torch.int64)),
    (torch.zeros(4, 8, 8, 3), torch.zeros(2, dtype=torch.int64)),
    (torch.zeros(0, 8, 8, 3, dtype=torch.uint8), torch.zeros(2, dtype=torch.int64)),
    (torch.zeros(4, 8, 8, 3, dtype=torch.uint8), torch.zeros(2)),
    (torch.zeros(4, 8, 8, 3, dtype=torch.uint8), torch.zeros(2, 1, dtype=torch.int64)),
], ids=["C1", "C4", "float-frames", "no-frames", "float-starts", "2d-starts"])
def test_rejects_bad_inputs(frames, starts):
    with pytest.raises(ValueError, match="gather_normalize"):
        tp.gather_normalize(frames, starts, L)
