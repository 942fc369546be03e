"""kstar_torch's SubBatchNorm and its multigrid helpers against kstar_tpu's
on the CPU at f32 (atol 1e-5 + rtol 1e-5 throughout: the same arithmetic in
another summation order).

The batch is interleave-sensitive: sample i has the mean i % 4 * 3, so
interleaved splits (sample a*s + g in split g) and contiguous ones
(``torch.chunk``) give different statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.models import (SubBatchNorm, aggregate_batch_stats, aggregate_subbn_stats,
                                reset_bn_splits_long_cycle)
from kstar_tpu.models.subbn import SubBatchNorm as JSubBatchNorm
from kstar_tpu.models.subbn import aggregate_batch_stats as j_aggregate_batch_stats
from kstar_tpu.models.subbn import reset_bn_splits_long_cycle as j_reset_bn_splits_long_cycle

N, C = 8, 6
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def batch(seed=0, n=N, spatial=(2, 3, 3)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + spatial + (C,)) * rng.uniform(0.5, 2.0, size=C)
    return (x + (np.arange(n) % 4 * 3.0).reshape((n,) + (1,) * (len(spatial) + 1))).astype(
        np.float32)


def jax_variables(splits, seed=1):
    rng = np.random.default_rng(seed)
    return {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                       "bias": rng.normal(0, 0.3, C).astype(np.float32)},
            "batch_stats": {"split_mean": rng.normal(0, 0.3, (splits, C)).astype(np.float32),
                            "split_var": rng.uniform(0.5, 2, (splits, C)).astype(np.float32),
                            "mean": rng.normal(0, 0.3, C).astype(np.float32),
                            "var": rng.uniform(0.5, 2, C).astype(np.float32)}}


def twin(variables, splits):
    from kstar_torch.weights import state_dict_from_flax

    m = SubBatchNorm(C, splits)
    m.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]),
                      strict=True)
    return m


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_train_forward_and_split_stats_match_jax(splits):
    x = batch()
    v = jax_variables(splits)
    want, mut = JSubBatchNorm(num_splits=splits).apply(v, jnp.asarray(x), train=True,
                                                        mutable=["batch_stats"])
    m = twin(v, splits)
    got = m(torch.as_tensor(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    stats = as_np(mut["batch_stats"])
    np.testing.assert_allclose(m.split_mean.numpy(), stats["split_mean"], **TOL)
    np.testing.assert_allclose(m.split_var.numpy(), stats["split_var"], **TOL)
    # the aggregated statistics do not move in training
    np.testing.assert_array_equal(m.running_mean.numpy(), v["batch_stats"]["mean"])
    if splits > 1:
        # contiguous splits would give other statistics
        chunks = torch.as_tensor(x).reshape(splits, N // splits, -1, C).mean((1, 2))
        assert not np.allclose(m.split_mean.numpy(), 0.9 * v["batch_stats"]["split_mean"]
                               + 0.1 * chunks.numpy(), atol=1e-3)


@pytest.mark.parametrize("splits", [2, 4])
def test_aggregate_then_eval_matches_jax(splits):
    x = batch(2)
    v = jax_variables(splits, seed=3)
    m = twin(v, splits)
    m(torch.as_tensor(batch(4)), train=True)                 # move the split statistics
    jv = {"params": v["params"],
          "batch_stats": {k: b.numpy() for k, b in
                          [("split_mean", m.split_mean), ("split_var", m.split_var),
                           ("mean", m.running_mean), ("var", m.running_var)]}}
    want_stats = as_np(j_aggregate_batch_stats({"bn": jv["batch_stats"]})["bn"])
    aggregate_batch_stats(torch.nn.Sequential(m))
    np.testing.assert_allclose(m.running_mean.numpy(), want_stats["mean"], **TOL)
    np.testing.assert_allclose(m.running_var.numpy(), want_stats["var"], **TOL)
    want = JSubBatchNorm(num_splits=splits).apply(
        {"params": v["params"], "batch_stats": want_stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = m(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_aggregate_subbn_stats_on_a_state_dict():
    """The functional form: aggregated entries for every module with split
    statistics, the rest passed through, the input left as it was."""
    v = jax_variables(4, seed=5)
    net = torch.nn.ModuleDict({"a": twin(v, 4), "b": torch.nn.Linear(2, 2)})
    sd = net.state_dict()
    out = aggregate_subbn_stats(sd)
    want = as_np(j_aggregate_batch_stats({"a": v["batch_stats"]})["a"])
    np.testing.assert_allclose(out["a.running_mean"].numpy(), want["mean"], **TOL)
    np.testing.assert_allclose(out["a.running_var"].numpy(), want["var"], **TOL)
    assert out["b.weight"] is sd["b.weight"]
    np.testing.assert_array_equal(sd["a.running_mean"].numpy(), v["batch_stats"]["mean"])


def test_long_cycle_reset_then_train_matches_jax():
    """reset_bn_splits_long_cycle (2 -> 4): fresh (4, C) split statistics,
    the affine parameters and the aggregated statistics kept; the next
    train forward at 4 splits equals JAX's."""
    v = jax_variables(2, seed=6)
    jv = as_np(j_reset_bn_splits_long_cycle(v, 4))
    m = twin(v, 2)
    reset_bn_splits_long_cycle(torch.nn.Sequential(m), 4)
    assert m.num_splits == 4 and m.split_mean.shape == (4, C)
    np.testing.assert_array_equal(m.split_mean.numpy(), jv["batch_stats"]["split_mean"])
    np.testing.assert_array_equal(m.split_var.numpy(), jv["batch_stats"]["split_var"])
    np.testing.assert_array_equal(m.running_var.numpy(), v["batch_stats"]["var"])
    x = batch(7)
    want, mut = JSubBatchNorm(num_splits=4).apply(jv, jnp.asarray(x), train=True,
                                                   mutable=["batch_stats"])
    got = m(torch.as_tensor(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(m.split_var.numpy(), np.asarray(mut["batch_stats"]["split_var"]),
                               **TOL)


def test_batch_not_divisible_raises():
    m = SubBatchNorm(C, 4)
    with pytest.raises(ValueError, match="not divisible by num_splits 4"):
        m(torch.as_tensor(batch(n=6)), train=True)
    assert m(torch.as_tensor(batch(n=6))).shape == (6, 2, 3, 3, C)     # eval takes any batch


def test_bf16_input_gives_bf16_output():
    m = SubBatchNorm(C, 2)
    x = torch.as_tensor(batch()).to(torch.bfloat16)
    assert m(x, train=True).dtype == torch.bfloat16
    assert m.split_mean.dtype == torch.float32
