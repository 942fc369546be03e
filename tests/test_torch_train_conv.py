"""kstar_torch's training core on the conv video models, against
kstar_tpu's, on the CPU at f32.

* Three train steps (one checked on its own, then all three) of R(2+1)D and
  of SlowFast with SubBatchNorm (base_bn_splits 2) from the same weights
  (carried with ``state_dict_from_flax``) against JAX's ``make_train_step``:
  SGD with momentum, clipping and the staircase decay, Focal loss. Losses
  at rtol 1e-4, parameters at atol 1e-5, every statistic (flax BatchNorm
  buffers and the per-split SubBatchNorm statistics) at atol 1e-5 + rtol
  1e-5 (the stem's running variance of pixel-scale conv outputs is ~50,
  where one f32 ulp is 3.8e-6). SGD, not Adam: a conv right before a
  BatchNorm has an exactly-zero gradient in exact arithmetic, and Adam
  turns its rounding noise into +-lr steps. The rate is 0.002: every conv
  feeds a train-mode BatchNorm over a batch of 8 clips, whose backward
  sums pixel-scale products that cancel, so each package's f32 gradient
  carries rounding far above f32's epsilon; at a rate of 0.05 the two
  trajectories part beyond the loss tolerance within three steps, at 0.002
  they hold it.
* ``fit(eval_stats_fn=aggregate_batch_stats)`` leaves the aggregated
  statistics in ``{tag}_last.ckpt`` and ``{tag}_best.ckpt``.
* The NaN guard restores the split statistics with every other buffer, and
  ``TrainState.reset_bn_splits`` re-flattens them at the new split count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import LossConfig, OptimConfig, TrainConfig
from kstar_torch.models import aggregate_batch_stats, aggregate_subbn_stats
from kstar_torch.train import create_train_state, fit, make_train_step
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.config import OptimConfig as JOptimConfig
from kstar_tpu.train.loop import make_train_step as j_make_train_step
from kstar_tpu.train.state import TrainState as JTrainState
from kstar_tpu.train.state import make_optimizer as j_make_optimizer
from test_torch_models_conv import B, SMALL, clips, conv_pair

STEPS = 3
OPTIM = dict(optimizer="SGD", lr=0.002, use_scheduler=True, step_size=2, gamma=0.5,
             max_norm_grad=1.0)
KEYS = ["R2Plus1D", "SlowFast_subbn2"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batches():
    x = np.stack([clips(seed=10 + i) for i in range(STEPS)])
    y = np.random.default_rng(3).integers(0, 2, size=(STEPS, B)).astype(np.int64)
    y[:, :2] = [0, 1]
    return x, y


def _aux():
    return torch.ones(2), torch.tensor([0.3, 0.5])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """``run(key)``: the model's JAX steps (the starting variables, the
    losses, and the variables after step 1 and after step 3), computed once
    per model on first use (the test workers each take a few of the
    cases)."""
    x, y = _batches()
    out = {}

    def run(key):
        if key not in out:
            out[key] = _jax_steps(key, x, y)
        return out[key]

    return x, y, run


def _jax_steps(key, x, y):
    """The JAX train steps of one model (see ``runs``)."""
    jm, v, _ = conv_pair(key, x[0], seed=1, pixel_scale=1.0)
    tx = j_make_optimizer(JOptimConfig(**OPTIM), steps_per_epoch=1)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                        rng=jax.random.key(0), tx=tx)
    step = j_make_train_step(jm, JLossConfig())
    losses, after = [], {}
    for i in range(STEPS):
        state, loss, _ = step(state, jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.ones(2),
                              jnp.asarray([0.3, 0.5]), jnp.zeros(3))
        losses.append(float(loss))
        after[i + 1] = state_dict_from_flax(_np(state.params), _np(state.batch_stats))
    return v, losses, after


def _torch_state(key, v):
    from test_torch_models_conv import torch_twin

    tm = torch_twin(SMALL[key][0], SMALL[key][1], v)
    return create_train_state(tm, OptimConfig(**OPTIM), steps_per_epoch=1)


@pytest.mark.parametrize("n_steps", [1, STEPS])
@pytest.mark.parametrize("key", KEYS)
def test_train_steps_match_jax(key, n_steps, runs):
    x, y, run = runs
    v, jlosses, after = run(key)
    state = _torch_state(key, v)
    step = make_train_step(LossConfig())
    losses = [float(step(state, torch.as_tensor(x[i]), torch.as_tensor(y[i]), *_aux())[1])
              for i in range(n_steps)]
    np.testing.assert_allclose(losses, jlosses[:n_steps], rtol=1e-4)
    assert int(state.step) == n_steps
    got, want = state.model.state_dict(), after[n_steps]
    assert set(got) == set(want)
    for k, w in want.items():
        stat = "running_" in k or "split_" in k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5 if stat else 0,
                                   atol=1e-5, err_msg=k)
    # every statistic, the split ones included, lives in the flat buffer
    assert state.stats_flat.numel() == sum(b.numel() for b in state.model.buffers())
    if "subbn" in key:
        assert any(k.endswith("split_var") for k in got)


def test_nan_guard_restores_split_stats():
    x, y = _batches()
    _, v, _ = conv_pair("SlowFast_subbn2", x[0], seed=2)
    state = _torch_state("SlowFast_subbn2", v)
    step = make_train_step(LossConfig())
    step(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]), *_aux())
    before = ({k: t.clone() for k, t in state.model.state_dict().items()},
              {k: t.clone() for k, t in state.opt_state.items()}, state.step.clone())
    _, loss, _ = step(state, torch.as_tensor(x[1]), torch.as_tensor(y[1]),
                      torch.full((2,), float("nan")), _aux()[1])
    assert not torch.isfinite(loss)
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, before[0][k]), k
    assert all(torch.equal(state.opt_state[k], t) for k, t in before[1].items())
    assert torch.equal(state.step, before[2])
    step(state, torch.as_tensor(x[1]), torch.as_tensor(y[1]), *_aux())
    split = [k for k in before[0] if k.endswith("split_mean")]
    assert split and all(not torch.equal(state.model.state_dict()[k], before[0][k])
                         for k in split)


def test_reset_bn_splits_reflattens_the_statistics():
    """The long-cycle reset (2 -> 4) changes the split buffers' shapes: the
    state's flat statistics follow, the parameters and the optimizer state
    stay, and the guard still covers the new buffers."""
    x, y = _batches()
    _, v, _ = conv_pair("SlowFast_subbn2", x[0], seed=2)
    state = _torch_state("SlowFast_subbn2", v)
    step = make_train_step(LossConfig())
    step(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]), *_aux())
    flat, n_stats = state.flat.clone(), state.stats_flat.numel()
    state.reset_bn_splits(4)
    bn = state.model.encoder.slow.stage1.block_0.bn1
    assert bn.num_splits == 4 and bn.split_mean.shape == (4, bn.weight.numel())
    assert state.stats_flat.numel() == sum(b.numel() for b in state.model.buffers()) > n_stats
    assert bn.split_mean.data_ptr() in {state.stats_flat[i:].data_ptr()
                                        for i in range(state.stats_flat.numel())}
    assert torch.equal(state.flat, flat)
    before = state.stats_flat.clone()
    step(state, torch.as_tensor(x[1]), torch.as_tensor(y[1]),
         torch.full((2,), float("nan")), _aux()[1])
    assert torch.equal(state.stats_flat, before)
    step(state, torch.as_tensor(x[1]), torch.as_tensor(y[1]), *_aux())
    assert not torch.equal(state.stats_flat, before)
    assert not torch.equal(bn.split_mean, torch.zeros_like(bn.split_mean))


class Clips:
    """The dataset interface fit reads: f32 clips and labels."""

    def __init__(self, x, y):
        self.x, self.y = x.reshape((-1,) + x.shape[2:]), y.reshape(-1)

    def __len__(self):
        return len(self.y)

    def class_counts(self):
        return np.bincount(self.y, minlength=2)

    def batch(self, idx):
        return self.x[idx], self.y[idx]


def test_fit_aggregates_into_the_checkpoints(tmp_path):
    x, y = _batches()
    _, v, _ = conv_pair("SlowFast_subbn2", x[0], seed=4)
    state = _torch_state("SlowFast_subbn2", v)
    cfg = TrainConfig(batch_size=B, num_epoch=2, weight_dir=str(tmp_path), verbose=0)
    state, hist = fit(state, Clips(x, y), Clips(x[:1], y[:1]), cfg, LossConfig(), tag="sf",
                      eval_stats_fn=aggregate_batch_stats)
    start = state_dict_from_flax({}, v["batch_stats"])
    for name in ("sf_last.ckpt", "sf_best.ckpt"):
        sd = torch.load(tmp_path / name)["model"]
        agg = aggregate_subbn_stats(sd)
        keys = [k for k in sd if k.endswith(("running_mean", "running_var"))
                and k.rsplit(".", 1)[0] + ".split_mean" in sd]
        assert len(keys) == 2 * 3 * 4 * 2        # 2 pathways x 4 blocks x bn1-3
        for k in keys:
            assert torch.equal(sd[k], agg[k]), k
            assert not torch.equal(sd[k], start[k]), k
    # the live model holds the last epoch's aggregate as well
    last = torch.load(tmp_path / "sf_last.ckpt")["model"]
    bn = state.model.encoder.fast.stage2.block_0.bn3
    assert torch.equal(bn.running_mean, last["encoder.fast.stage2.block_0.bn3.running_mean"])
    assert len(hist.train_loss) == 2
