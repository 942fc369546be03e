"""kstar_torch's mixup and video CutMix against kstar_tpu's, on the CPU.

The draws (lam, the permutation, the box and span centres) are taken from
JAX's own keys, split as ``kstar_tpu/train/mixup.py`` splits them, and fed
to the port's apply functions: the mixed batches, labels and mixing weights
must equal JAX's exactly in f32. JAX's "both" mode draws cx and t0 from one
key; the test feeds that same pair, so it holds the apply function only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.train import mixup as tm
from kstar_tpu.train import mixup as jm

B, T, H, W, C = 6, 7, 9, 11, 3


@pytest.fixture(scope="module")
def video():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, T, H, W, C)).astype(np.float32),
            rng.integers(0, 2, size=B).astype(np.int32))


def _t(a):
    return torch.as_tensor(np.array(a))


def _equal(got, want):
    assert np.array_equal(got.numpy(), np.asarray(want)), \
        float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("seed,alpha", [(0, 1.0), (1, 0.4), (2, 2.0)])
def test_mixup_equals_jax(video, seed, alpha):
    x, y = video
    key = jax.random.key(seed)
    jx, jya, jyb, jlam = jm.mixup(key, jnp.asarray(x), jnp.asarray(y), alpha)
    k1, k2 = jax.random.split(key)
    lam = float(jax.random.beta(k1, alpha, alpha))
    perm = _t(jax.random.permutation(k2, B)).long()
    tx, tya, tyb, tlam = tm.mixup_apply(_t(x), _t(y), lam, perm)
    _equal(tx, jx)
    _equal(tya, jya)
    _equal(tyb, jyb)
    _equal(tlam, jlam)


@pytest.mark.parametrize("mode", ["spatio", "temporal", "both"])
@pytest.mark.parametrize("seed", [0, 3])
def test_video_cutmix_equals_jax(video, mode, seed):
    x, y = video
    key = jax.random.key(seed)
    jx, jya, jyb, jlam = jm.video_cutmix(key, jnp.asarray(x), jnp.asarray(y), mode=mode)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lam = float(jax.random.beta(k1, 1.0, 1.0))
    perm = _t(jax.random.permutation(k2, B)).long()
    cx = int(jax.random.randint(k3, (), 0, W))
    cy = int(jax.random.randint(k4, (), 0, H))
    t0 = int(jax.random.randint(k3, (), 0, T))
    tx, tya, tyb, tlam = tm.video_cutmix_apply(_t(x), _t(y), mode, lam, perm, cx, cy, t0)
    _equal(tx, jx)
    _equal(tya, jya)
    _equal(tyb, jyb)
    _equal(tlam, jlam)
    assert not np.array_equal(tx.numpy(), x) or float(tlam) == 1.0


def test_mixup_loss_equals_jax(video):
    from kstar_torch.losses import classification_loss as t_loss
    from kstar_tpu.losses import classification_loss as j_loss

    _, y = video
    logits = np.random.default_rng(1).normal(size=(B, 2)).astype(np.float32)
    y_b = y[::-1].copy()
    want = jm.mixup_loss(lambda lg, yy: j_loss(lg, yy, "Focal"), jnp.asarray(logits),
                         jnp.asarray(y), jnp.asarray(y_b), jnp.float32(0.3))
    got = tm.mixup_loss(lambda lg, yy: t_loss(lg, yy, "Focal"), _t(logits),
                        _t(y).long(), _t(y_b).long(), torch.tensor(0.3))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_draws_are_reproducible_and_in_range():
    gen = lambda: torch.Generator().manual_seed(5)
    x = torch.zeros(B, T, H, W, C)
    for mode in tm.CUTMIX_MODES:
        a = tm.video_cutmix_draw(gen(), x.shape, mode)
        b = tm.video_cutmix_draw(gen(), x.shape, mode)
        assert a[0] == b[0] and torch.equal(a[1], b[1]) and a[2:] == b[2:]
        lam, perm, cx, cy, t0 = a
        assert 0.0 <= lam <= 1.0 and sorted(perm.tolist()) == list(range(B))
        assert (cx is None) == (mode == "temporal") and (t0 is None) == (mode == "spatio")
        assert cx is None or (0 <= cx < W and 0 <= cy < H)
        assert t0 is None or 0 <= t0 < T
    lam, _ = tm.mixup_draw(gen(), B, alpha=0.0)
    assert lam == 1.0
    with pytest.raises(ValueError, match="mode must be one of"):
        tm.video_cutmix(gen(), x, torch.zeros(B), mode="frames")
    # the mixed batch is the one-call form of draw + apply
    xr = torch.randn(B, T, H, W, C, generator=torch.Generator().manual_seed(0))
    yr = torch.arange(B)
    one = tm.video_cutmix(gen(), xr, yr, mode="both")
    two = tm.video_cutmix_apply(xr, yr, "both", *tm.video_cutmix_draw(gen(), xr.shape, "both"))
    assert all(torch.equal(a, b) for a, b in zip(one, two))
