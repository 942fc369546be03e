"""kstar_torch.losses against kstar_tpu.losses: values AND gradients of CE,
Focal, LDAM, Gradient Blending and CCA, and the numpy weight schedules, on
inputs made from a numpy seed, at the tolerance of tests/test_losses.py
(rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch import losses as TL
from kstar_tpu import losses as JL

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed=0, n=16):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(n, 2))).astype(np.float32)
    labels = rng.integers(0, 2, size=n).astype(np.int64)
    weight = np.array([2.5, 0.7], np.float32)
    mask = (rng.uniform(size=n) > 0.25).astype(np.float32)
    return logits, labels, weight, mask


def _both(jfn, tfn, logits, *args):
    """(jax value, jax grad wrt logits, torch value, torch grad)."""
    jv, jg = jax.value_and_grad(lambda x: jfn(x, *[jnp.asarray(a) for a in args]))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tv = tfn(x, *[torch.as_tensor(a) for a in args])
    tv.backward()
    return np.asarray(jv), np.asarray(jg), tv.detach().numpy(), x.grad.numpy()


def _check(jfn, tfn, logits, *args):
    jv, jg, tv, tg = _both(jfn, tfn, logits, *args)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


@pytest.mark.parametrize("with_weight", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("kind", ["CE", "Focal", "LDAM"])
def test_classification_losses_and_grads(kind, with_weight, with_mask):
    logits, labels, weight, mask = _inputs()
    m_list = JL.ldam_margins(np.array([30, 170]), 0.5)
    w = weight if with_weight else None
    mk = mask if with_mask else None

    def jfn(x, y):
        return JL.classification_loss(
            x, y, kind, weight=None if w is None else jnp.asarray(w),
            mask=None if mk is None else jnp.asarray(mk), gamma=2.0,
            m_list=jnp.asarray(m_list), s=1.5)

    def tfn(x, y):
        return TL.classification_loss(
            x, y, kind, weight=None if w is None else torch.as_tensor(w),
            mask=None if mk is None else torch.as_tensor(mk), gamma=2.0,
            m_list=torch.as_tensor(m_list), s=1.5)

    _check(jfn, tfn, logits, labels)


def test_reductions_are_sum_and_weighted_mean():
    """CE/Focal sum over the batch; LDAM is a weighted mean (not torch's
    default mean for CE)."""
    logits, labels, weight, _ = _inputs(1)
    x, y = torch.as_tensor(logits), torch.as_tensor(labels)
    per = torch.nn.functional.cross_entropy(x, y, reduction="none")
    torch.testing.assert_close(TL.ce_loss(x, y), per.sum())
    m0 = torch.zeros(2)
    w = torch.as_tensor(weight)
    torch.testing.assert_close(TL.ldam_loss(x, y, m0, weight=w),
                               (per * w[y]).sum() / w[y].sum())
    # an all-zero mask: the denominator is floored at 1e-8, the loss is 0
    assert float(TL.ldam_loss(x, y, m0, mask=torch.zeros(len(y)))) == 0.0


def test_bf16_logits_go_to_f32():
    logits, labels, _, _ = _inputs(2)
    x16 = torch.as_tensor(logits).to(torch.bfloat16)
    got = TL.focal_loss(x16, torch.as_tensor(labels))
    assert got.dtype == torch.float32
    want = JL.focal_loss(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gradient_blending_loss_and_grads():
    rng = np.random.default_rng(3)
    outs = [(2 * rng.normal(size=(12, 2))).astype(np.float32) for _ in range(3)]
    labels = rng.integers(0, 2, size=12)
    gb = np.array([0.2, 0.3, 0.5], np.float32)
    jv, jgs = jax.value_and_grad(
        lambda a, b, c: JL.gradient_blending_loss(a, b, c, jnp.asarray(labels),
                                                  jnp.asarray(gb), "Focal",
                                                  loss_scale=0.5),
        argnums=(0, 1, 2))(*map(jnp.asarray, outs))
    ts = [torch.tensor(o, requires_grad=True) for o in outs]
    tv = TL.gradient_blending_loss(*ts, torch.as_tensor(labels), torch.as_tensor(gb),
                                   "Focal", loss_scale=0.5)
    tv.backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL)
    for t, jg in zip(ts, jgs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("all_sv", [False, True])
def test_cca_loss_and_grads(all_sv):
    rng = np.random.default_rng(4)
    h1 = rng.normal(size=(64, 6)).astype(np.float32)
    h2 = (h1[:, :4] @ rng.normal(size=(4, 5)) + 0.5 * rng.normal(size=(64, 5))).astype(np.float32)
    jv, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: JL.cca_loss(a, b, 3, use_all_singular_values=all_sv),
        argnums=(0, 1))(jnp.asarray(h1), jnp.asarray(h2))
    t1, t2 = (torch.tensor(h, requires_grad=True) for h in (h1, h2))
    tv = TL.cca_loss(t1, t2, 3, use_all_singular_values=all_sv)
    tv.backward()
    # the value holds rtol 1e-5. The gradients pass through two independent
    # f32 eigensolvers and eigh's backward, which divides by eigenvalue
    # gaps: they agree to 1e-5-3.5e-5 of their largest element (8 seeds, N
    # 64 and 256), so they are held at 5e-5 of it
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-5)
    for t, jg in ((t1, jg1), (t2, jg2)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0,
                                   atol=5e-5 * np.abs(jg).max())


@pytest.mark.parametrize("counts", [[30, 170], [5, 500], [100, 100], [0, 12]])
def test_numpy_weights_equal(counts):
    np.testing.assert_array_equal(TL.ldam_margins(counts, 0.5), JL.ldam_margins(counts, 0.5))
    np.testing.assert_array_equal(TL.inverse_freq_weights(counts),
                                  JL.inverse_freq_weights(counts))
    for epoch in range(0, 12, 3):
        np.testing.assert_array_equal(TL.drw_weights(epoch, 12, counts, 0.25),
                                      JL.drw_weights(epoch, 12, counts, 0.25))


@pytest.mark.parametrize("sign", ["same", "mixed"])
def test_estimate_gb_weights_equal(sign):
    tr = {"vis": [1.0, 0.6], "ts": [1.0, 0.7], "multi": [1.0, 0.5]}
    va = {"vis": [1.1, 0.8], "ts": [1.2, 0.9 if sign == "same" else 1.4],
          "multi": [1.05, 0.7]}
    assert TL.estimate_gb_weights(tr, va) == JL.estimate_gb_weights(tr, va)
