"""kstar_torch's training core on the 0D models, against kstar_tpu's, on the CPU.

* 6 train steps of each 0D model from the same weights (carried with
  ``state_dict_from_flax``) against JAX's ``make_train_step``: SGD with
  momentum, clipping and the staircase decay, Focal loss, f32, input noise
  and dropout 0 so both sides are deterministic. Losses at rtol 1e-4,
  parameters and ``batch_stats`` at atol 1e-5. SGD and not Adam: each model
  has parameters whose gradient is zero in exact arithmetic (a conv or Dense
  bias right before a BatchNorm, the attention's key bias), and Adam turns
  their rounding noise into steps of +-lr whose sign the summation order
  decides (the Adam rule itself is held against optax in
  ``test_torch_train.py``).
* The NaN guard leaves parameters, optimizer state, step and the BatchNorm
  buffers bit-identical; a checkpoint carries the buffers; the new noise
  stream leaves the two streams the ViViT step draws as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import CnnLSTMConfig as TCnnLSTMConfig
from kstar_torch.config import LossConfig, OptimConfig
from kstar_torch.config import MLSTMFCNConfig as TMLSTMFCNConfig
from kstar_torch.config import TransformerConfig as TTransformerConfig
from kstar_torch.models import build_0d_model
from kstar_torch.train import (create_train_state, load_checkpoint, make_train_step,
                               save_checkpoint)
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import CnnLSTMConfig, MLSTMFCNConfig, TransformerConfig
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.config import OptimConfig as JOptimConfig
from kstar_tpu.models import build_0d_model as j_build_0d_model
from kstar_tpu.train.loop import make_train_step as j_make_train_step
from kstar_tpu.train.state import create_train_state as j_create_train_state

B, T, F, STEPS = 8, 21, 18, 6
SMALL = {
    "Transformer": TransformerConfig(n_features=F, feature_dims=32, n_layers=1, n_heads=4,
                                     dim_feedforward=64, cls_dims=16, max_len=T,
                                     dropout=0.0, noise_std=0.0),
    "CnnLSTM": CnnLSTMConfig(seq_len=T, n_features=F, conv_dim=16, lstm_dim=16, n_layers=1,
                             noise_std=0.0),
    "MLSTM_FCN": MLSTMFCNConfig(n_features=F, fcn_dim=16, seq_len=T, lstm_dim=16,
                                noise_std=0.0),
}
TORCH_CFG = {"Transformer": TTransformerConfig, "CnnLSTM": TCnnLSTMConfig,
             "MLSTM_FCN": TMLSTMFCNConfig}
# the rate halves every 2 updates; clipping at 1.0 engages on some steps
OPTIM = dict(optimizer="SGD", lr=0.05, use_scheduler=True, step_size=2, gamma=0.5,
             max_norm_grad=1.0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(STEPS, B, T, F)).astype(np.float32)
    y = rng.integers(0, 2, size=(STEPS, B)).astype(np.int64)
    return x, y


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_model(name, seed=0):
    cfg = TORCH_CFG[name](**dataclasses.asdict(SMALL[name]))
    return build_0d_model(name, cfg, generator=torch.Generator().manual_seed(seed))


def _aux():
    return torch.ones(2), torch.tensor([0.3, 0.5])


@pytest.fixture(scope="module")
def jax_runs():
    """Each model's 6 JAX steps (one jitted step per model), with the
    starting weights."""
    x, y = _batches()
    out = {}
    for name, cfg in SMALL.items():
        jm = j_build_0d_model(name, cfg)
        state = j_create_train_state(jm, jnp.asarray(x[0]), jax.random.key(0),
                                     JOptimConfig(**OPTIM), steps_per_epoch=1)
        start = (_np(state.params), _np(state.batch_stats))
        step = j_make_train_step(jm, JLossConfig())
        losses = []
        for i in range(STEPS):
            state, loss, _ = step(state, jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.ones(2),
                                  jnp.asarray([0.3, 0.5]), jnp.zeros(3))
            losses.append(float(loss))
        out[name] = (start, losses, _np(state.params), _np(state.batch_stats),
                     int(state.step))
    return x, y, out


@pytest.mark.parametrize("name", list(SMALL))
def test_train_steps_match_jax(name, jax_runs):
    x, y, runs = jax_runs
    (params0, stats0), jlosses, jparams, jstats, jstep = runs[name]
    tm = _torch_model(name)
    tm.load_state_dict(state_dict_from_flax(params0, stats0), strict=True)
    state = create_train_state(tm, OptimConfig(**OPTIM), steps_per_epoch=1)
    step = make_train_step(LossConfig())
    losses = [float(step(state, torch.as_tensor(x[i]), torch.as_tensor(y[i]), *_aux())[1])
              for i in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state.step) == jstep == STEPS
    got = tm.state_dict()
    want = state_dict_from_flax(jparams, jstats)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    # the statistics really moved, and they are part of the state's flat buffer
    assert any(not np.allclose(got[k].numpy(), w.numpy())
               for k, w in state_dict_from_flax({}, stats0).items())
    assert state.stats_flat is not None
    assert state.stats_flat.numel() == sum(v.size for v in jax.tree_util.tree_leaves(jstats))


@pytest.mark.parametrize("name", list(SMALL))
def test_nan_guard_keeps_batch_stats(name):
    """A non-finite loss leaves parameters, optimizer state, step and the
    BatchNorm buffers bit-identical; a finite step moves the buffers."""
    x, y = _batches(1)
    tm = _torch_model(name)
    state = create_train_state(tm, OptimConfig(**OPTIM), steps_per_epoch=1)
    step = make_train_step(LossConfig())
    step(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]), *_aux())
    before = (state.flat.clone(), {k: v.clone() for k, v in state.opt_state.items()},
              state.step.clone(), state.stats_flat.clone(),
              {k: v.clone() for k, v in tm.state_dict().items()})
    _, loss, _ = step(state, torch.as_tensor(x[1]), torch.as_tensor(y[1]),
                      torch.full((2,), float("nan")), torch.tensor([0.3, 0.5]))
    assert not torch.isfinite(loss)
    assert torch.equal(state.flat, before[0])
    assert all(torch.equal(state.opt_state[k], v) for k, v in before[1].items())
    assert torch.equal(state.step, before[2])
    assert torch.equal(state.stats_flat, before[3])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[4][k]), k
    step(state, torch.as_tensor(x[1]), torch.as_tensor(y[1]), *_aux())
    assert not torch.equal(state.stats_flat, before[3])


def test_checkpoint_round_trip_keeps_batch_stats(tmp_path):
    """Save after two steps, load into a fresh state: the same buffers, and
    the next step equals the uninterrupted run's, input noise included."""
    cfg = TMLSTMFCNConfig(n_features=F, fcn_dim=16, seq_len=T, lstm_dim=16)  # noise on
    x, y = _batches(2)
    step = make_train_step(LossConfig())

    def fresh():
        m = build_0d_model("MLSTM_FCN", cfg, generator=torch.Generator().manual_seed(0))
        return create_train_state(m, OptimConfig(**OPTIM), steps_per_epoch=1, seed=5)

    a = fresh()
    for i in range(2):
        step(a, torch.as_tensor(x[i]), torch.as_tensor(y[i]), *_aux())
    path = str(tmp_path / "m_last.ckpt")
    save_checkpoint(a, path)
    b = load_checkpoint(fresh(), path)
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    assert torch.equal(b.stats_flat, a.stats_flat) and b.draws == a.draws == 2
    la = step(a, torch.as_tensor(x[2]), torch.as_tensor(y[2]), *_aux())[1]
    lb = step(b, torch.as_tensor(x[2]), torch.as_tensor(y[2]), *_aux())[1]
    assert torch.equal(la, lb)
    assert torch.equal(a.flat, b.flat) and torch.equal(a.stats_flat, b.stats_flat)


def test_noise_stream_is_drawn_and_seeded():
    """The input noise draws from stream 2: two steps with other seeds give
    other losses, the same seed the same; noise 0 gives the noiseless loss."""
    x, y = _batches(3)

    def loss_after(seed, noise_std):
        cfg = TMLSTMFCNConfig(n_features=F, fcn_dim=16, seq_len=T, lstm_dim=16,
                              noise_std=noise_std)
        m = build_0d_model("MLSTM_FCN", cfg, generator=torch.Generator().manual_seed(0))
        st = create_train_state(m, OptimConfig(**OPTIM), steps_per_epoch=1, seed=seed)
        return float(make_train_step(LossConfig())(st, torch.as_tensor(x[0] * 1e3),
                                                   torch.as_tensor(y[0]), *_aux())[1])

    assert loss_after(0, 0.5) == loss_after(0, 0.5)
    assert loss_after(0, 0.5) != loss_after(1, 0.5)
    assert loss_after(0, 0.0) == loss_after(1, 0.0)


def test_vivit_streams_unchanged_by_noise_stream():
    """Streams 0 (pre) and 1 (dropout) are still seeded from (seed, draws,
    stream) as before the third stream was added."""
    tm = _torch_model("MLSTM_FCN")
    state = create_train_state(tm, OptimConfig(), seed=9)
    for draws in range(2):
        gens = state.next_generators()
        assert len(gens) == 3
        for stream in (0, 1):
            s = np.random.SeedSequence([9, draws, stream]).generate_state(1, np.uint64)[0]
            want = torch.rand(6, generator=torch.Generator().manual_seed(int(s)))
            assert torch.equal(torch.rand(6, generator=gens[stream]), want)
