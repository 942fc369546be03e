"""kstar_torch's training core against kstar_tpu's, on the CPU at small size.

* The optimizers reproduce optax: each update rule against the optax chain
  on the same gradients, and 6 train steps of the port against JAX's
  ``make_train_step`` from the same weights (carried with
  ``kstar_torch.weights``), with clipping and the staircase decay on,
  dropout 0, no augmentation, f32. Losses are held at rtol 1e-4 and the
  parameters at atol 1e-5 (measured on the CPU: losses within 5.0e-7
  relative for all four optimizers; parameters within 1.5e-8 for SGD,
  1.3e-7 for RMSProp, 1.4e-6 for Adam and AdamW; summation order only).
* The NaN guard leaves the state bit-identical; K steps per call equal K
  single steps, in ``fit`` too; save/load then a step equals the step;
  ``fit`` writes both checkpoints and returns the JAX ``History``'s fields.
* Dropout draws from the generator it is given.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kstar_torch.config import AugmentConfig, LossConfig, OptimConfig, TrainConfig
from kstar_torch.data import VideoDataset, VideoStore, make_dataset, make_pre_fns, split_shots
from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.models.vivit import dropout
from kstar_torch.train import (History, create_train_state, fit, load_checkpoint,
                               load_params, make_optimizer, make_scan_steps,
                               make_train_step, save_checkpoint)
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.config import OptimConfig as JOptimConfig
from kstar_tpu.models.vivit import ViViT as JaxViViT
from kstar_tpu.train import History as JHistory
from kstar_tpu.train.loop import make_train_step as j_make_train_step
from kstar_tpu.train.state import create_train_state as j_create_train_state
from kstar_tpu.train.state import make_optimizer as j_make_optimizer

SMALL = dict(image_size=32, patch_size=16, n_frames=5, dim=32, depth=1, n_heads=2,
             d_head=16, scale_dim=2)
B, STEPS = 4, 6
OPTIMIZERS = ["SGD", "Adam", "AdamW", "RMSProp"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _optim(name, max_norm=3.0):
    # the gradient norms of these steps run 1.3-24: clipping engages on some
    # steps and not on others; the rate halves every 2 updates
    return dict(optimizer=name, lr=1e-3, use_scheduler=True, step_size=2, gamma=0.5,
                max_norm_grad=max_norm)


def _batches(seed=0, n=STEPS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, B, SMALL["n_frames"], 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 2, size=(n, B)).astype(np.int64)
    return x, y


def _torch_model(dropout_rate=0.0, seed=0, dtype=torch.float32):
    return TorchViViT(**SMALL, dropout=dropout_rate, embedd_dropout=dropout_rate,
                      dtype=dtype, generator=torch.Generator().manual_seed(seed))


def _aux():
    return torch.ones(2), torch.tensor([0.3, 0.5])


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_update_matches_optax(name):
    """One optax chain and its port on the same gradient sequence: both
    clipping branches, the staircase rate, every moment."""
    cfg = _optim(name, max_norm=1.0)
    jtx = j_make_optimizer(JOptimConfig(**cfg), steps_per_epoch=1)
    ttx = make_optimizer(OptimConfig(**cfg), steps_per_epoch=1)
    rng = np.random.default_rng(1)
    p = rng.normal(size=257).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.as_tensor(p)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(7):
        scale = 0.02 if i % 2 else 0.5          # |g| ~ 0.3 (kept) or ~ 8 (clipped)
        g = (scale * rng.normal(size=257)).astype(np.float32)
        ju, jstate = jtx.update(jnp.asarray(g), jstate, jp)
        tu, tstate = ttx.update(torch.as_tensor(g), tstate, tp)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-9)
        jp, tp = optax.apply_updates(jp, ju), tp + tu
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert int(tstate["count"]) == 7


def test_learning_rate_is_optax_exponential_decay():
    ttx = make_optimizer(OptimConfig(lr=2e-4, step_size=4, gamma=0.95), steps_per_epoch=3)
    sched = optax.exponential_decay(2e-4, transition_steps=12, decay_rate=0.95,
                                    staircase=True)
    for count in range(0, 40, 5):
        np.testing.assert_allclose(float(ttx.learning_rate(torch.tensor(count))),
                                   float(sched(count)), rtol=1e-6)
    flat = make_optimizer(OptimConfig(use_scheduler=False), steps_per_epoch=3)
    assert float(flat.learning_rate(torch.tensor(100))) == pytest.approx(2e-4)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_train_steps_match_jax(name):
    cfg = _optim(name)
    jm = JaxViViT(dtype=jnp.float32, **SMALL, dropout=0.0, embedd_dropout=0.0)
    x, y = _batches()
    jstate = j_create_train_state(jm, jnp.asarray(x[0]), jax.random.key(0),
                                  JOptimConfig(**cfg), steps_per_epoch=1)
    tm = TorchViViT(**SMALL, dropout=0.0, embedd_dropout=0.0)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params)), strict=True)
    tstate = create_train_state(tm, OptimConfig(**cfg), steps_per_epoch=1)

    jstep = j_make_train_step(jm, JLossConfig())
    tstep = make_train_step(LossConfig())
    m_list = np.array([0.3, 0.5], np.float32)
    jloss, tloss = [], []
    for i in range(STEPS):
        jstate, l, _ = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]),
                             jnp.ones(2), jnp.asarray(m_list), jnp.zeros(3))
        jloss.append(float(l))
        _, l, _ = tstep(tstate, torch.as_tensor(x[i]), torch.as_tensor(y[i]),
                        torch.ones(2), torch.as_tensor(m_list))
        tloss.append(float(l))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert int(tstate.step) == int(jstate.step) == STEPS
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = tm.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def _snapshot(state):
    return (state.flat.clone(), {k: v.clone() for k, v in state.opt_state.items()},
            state.step.clone())


def test_nan_guard_leaves_state_bit_identical():
    state = create_train_state(_torch_model(0.1), OptimConfig(), steps_per_epoch=1)
    step = make_train_step(LossConfig())
    x, y = _batches()
    step(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]), *_aux())   # real moments
    flat, opt, st = _snapshot(state)
    bad = x[1].copy()
    bad[0, 0, 0, 0, 0] = np.nan
    _, loss, _ = step(state, torch.as_tensor(bad), torch.as_tensor(y[1]), *_aux())
    assert not torch.isfinite(loss)
    assert torch.equal(state.flat, flat) and torch.equal(state.step, st)
    for k, v in opt.items():
        assert torch.equal(state.opt_state[k], v), k
    assert int(state.opt_state["count"]) == 1      # the schedule's count did not move
    _, loss, _ = step(state, torch.as_tensor(x[2]), torch.as_tensor(y[2]), *_aux())
    assert torch.isfinite(loss) and int(state.step) == 2


def _uint8_batches(n, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, B, SMALL["n_frames"], 40, 40, 3), dtype=np.uint8)
    y = rng.integers(0, 2, size=(n, B)).astype(np.int64)
    return torch.as_tensor(x), torch.as_tensor(y)


def test_k_steps_per_call_equal_single_steps():
    """With dropout and in-step augmentation on, 6 steps as 2 calls of K=3
    equal 6 single steps bit for bit (the same per-step generators)."""
    pre, _ = make_pre_fns(32, AugmentConfig(bright_p=0.5, blur_p=0.5, flip_p=0.5,
                                            vertical_p=0.5, horizontal_p=0.5),
                          out_dtype=torch.float32)
    x, y = _uint8_batches(6)
    one = create_train_state(_torch_model(0.1), OptimConfig(), steps_per_epoch=1, seed=5)
    step = make_train_step(LossConfig(), pre_fn=pre)
    losses1 = [step(one, x[i], y[i], *_aux())[1] for i in range(6)]
    k = create_train_state(_torch_model(0.1), OptimConfig(), steps_per_epoch=1, seed=5)
    multi = make_scan_steps(LossConfig(), pre_fn=pre)
    losses_k = torch.cat([multi(k, x[i:i + 3], y[i:i + 3], *_aux())[1] for i in (0, 3)])
    assert torch.equal(torch.stack(losses1), losses_k)
    assert torch.equal(one.flat, k.flat) and int(k.step) == 6 and k.draws == 6


def test_checkpoint_then_step_equals_step(tmp_path):
    x, y = _uint8_batches(3, seed=3)
    pre, _ = make_pre_fns(32, out_dtype=torch.float32)
    step = make_train_step(LossConfig(), pre_fn=pre)
    a = create_train_state(_torch_model(0.1), OptimConfig(), steps_per_epoch=1, seed=7)
    for i in range(2):
        step(a, x[i], y[i], *_aux())
    save_checkpoint(a, str(tmp_path / "m_last.ckpt"), extra={"epoch": 1})
    step(a, x[2], y[2], *_aux())

    b = create_train_state(_torch_model(0.1, seed=9), OptimConfig(), steps_per_epoch=1)
    load_checkpoint(b, str(tmp_path / "m_last.ckpt"))
    assert int(b.step) == 2 and b.draws == 2 and b.seed == 7
    step(b, x[2], y[2], *_aux())
    assert torch.equal(a.flat, b.flat) and torch.equal(a.step, b.step)
    for k, v in a.opt_state.items():
        assert torch.equal(b.opt_state[k], v), k
    # parameters only, into a fresh model
    m = load_params(_torch_model(seed=11), str(tmp_path / "m_last.ckpt"))
    assert (tmp_path / "m_last.ckpt.json").exists()
    assert not torch.equal(torch.cat([p.reshape(-1) for p in m.parameters()]), a.flat)


def test_bf16_compute_over_f32_parameters():
    state = create_train_state(_torch_model(0.1, dtype=torch.bfloat16), OptimConfig(),
                               steps_per_epoch=1)
    before = state.flat.clone()
    x, y = _batches(n=2)
    _, loss, preds = make_train_step(LossConfig())(state, torch.as_tensor(x[0]),
                                                   torch.as_tensor(y[0]), *_aux())
    assert torch.isfinite(loss) and loss.dtype == torch.float32 and preds.shape == (B,)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert not torch.equal(before, state.flat)


def _synthetic_datasets():
    shots, disrupt_df, _ = make_dataset(n_shots=6, n_frames=96, height=48, width=48, seed=0)
    store = VideoStore.from_arrays({s.shot: s.frames for s in shots})
    train_s, valid_s, _ = split_shots(sorted(store.arrays), None)
    mk = lambda ss: VideoDataset(store, disrupt_df, ss, seq_len=SMALL["n_frames"])
    return mk(train_s), mk(valid_s)


def test_fit_writes_checkpoints_and_history(tmp_path):
    train_ds, valid_ds = _synthetic_datasets()
    pre, pre_eval = make_pre_fns(32, out_dtype=torch.float32)
    state = create_train_state(_torch_model(0.1), OptimConfig(), steps_per_epoch=1)
    cfg = TrainConfig(batch_size=8, num_epoch=2, seed=0, verbose=0,
                      weight_dir=str(tmp_path))
    state, hist = fit(state, train_ds, valid_ds, cfg, LossConfig(), tag="t",
                      pre_fn=pre, pre_fn_eval=pre_eval)
    assert (tmp_path / "t_last.ckpt").exists() and (tmp_path / "t_best.ckpt").exists()
    assert isinstance(hist, History)
    assert [f.name for f in dataclasses.fields(History)] == \
        [f.name for f in dataclasses.fields(JHistory)]
    assert len(hist.train_loss) == len(hist.valid_f1) == len(hist.epoch_s) == 2
    assert int(state.step) == 2 * (len(train_ds) // 8)
    assert all(np.isfinite(hist.train_loss)) and all(np.isfinite(hist.valid_loss))


def test_fit_k_steps_per_call_equals_single_steps(tmp_path):
    """fit's grouped path (stacks of K batches gathered in one call, the
    K-step function, single steps for the remainder) ends where K = 1 does."""
    train_ds, valid_ds = _synthetic_datasets()
    pre, pre_eval = make_pre_fns(32, out_dtype=torch.float32)
    flats = []
    for k in (1, 3):
        state = create_train_state(_torch_model(0.1), OptimConfig(), steps_per_epoch=1)
        cfg = TrainConfig(batch_size=4, num_epoch=1, seed=0, verbose=0,
                          weight_dir=str(tmp_path / str(k)), steps_per_dispatch=k)
        state, hist = fit(state, train_ds, valid_ds, cfg, LossConfig(), tag="t",
                          pre_fn=pre, pre_fn_eval=pre_eval)
        flats.append((state.flat, int(state.step), hist.train_loss[0]))
    n_steps = len(train_ds) // 4
    assert n_steps % 3 != 0                     # a remainder runs single steps
    assert torch.equal(flats[0][0], flats[1][0]) and flats[0][1] == flats[1][1] == n_steps
    assert flats[0][2] == pytest.approx(flats[1][2], rel=1e-6)


def test_dropout_draws_from_the_given_generator():
    x = torch.randn(3, 17, 8, generator=torch.Generator().manual_seed(0))
    a = dropout(x, 0.25, True, torch.Generator().manual_seed(4))
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(4))
    c = dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.75)      # flax: x / keep where kept
    assert torch.equal(dropout(x, 0.25, False, None), x)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, True, None)


def test_model_dropout_is_reproducible_from_generator_state():
    m = _torch_model(0.3)
    x = torch.as_tensor(_batches(n=1)[0][0])
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    a = m(x, train=True, generator=g)
    g.set_state(state)
    b = m(x, train=True, generator=g)
    c = m(x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the global RNG plays no part, and eval ignores the generator
    torch.manual_seed(123)
    g.set_state(state)
    assert torch.equal(m(x, train=True, generator=g), a)
    assert torch.equal(m(x), m(x, generator=torch.Generator().manual_seed(3)))


def test_fused_attention_model_refuses_training():
    m = TorchViViT(**SMALL, use_pallas=True)
    x = torch.as_tensor(_batches(n=1)[0][0])
    with pytest.raises(RuntimeError, match="no backward"):
        m(x, train=True, generator=torch.Generator().manual_seed(0))
