"""kstar_torch's seed ensemble (train/ensemble.py) on the CPU.

* Member i of an ensemble takes exactly the steps of a solo run with seed i
  on the same batches (dropout and input noise on, SGD): bit for bit.
* K steps per call (``make_ensemble_scan_steps``) equal single steps, in
  ``fit_ensemble`` too: the members bit for bit, the epoch losses at rtol
  1e-6 (their f32 sum runs in another order).
* ``fit_ensemble`` writes JAX's ``{tag}_seed_{s}_{best,last}.ckpt`` names and
  JAX's histories.
* Against JAX: a JAX ensemble's stacked parameters (and batch statistics),
  carried into the port's members with ``members_from_flax``, take 3 shared
  SGD steps with dropout and input noise at 0: losses at rtol 1e-4 and
  parameters at atol 1e-5 (the bar of the port's other trajectory tests),
  for MLSTM-FCN and a 1-layer, 32 px ViViT; and 2 epochs of ``fit_ensemble``
  give JAX's histories at the same bar.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import LossConfig, OptimConfig, Schema, TrainConfig
from kstar_torch.config import MLSTMFCNConfig as TMLSTMFCNConfig
from kstar_torch.data import TSDataset, prepare_0d_dataset
from kstar_torch.models import build_0d_model
from kstar_torch.models.vivit import ViViT as TViViT
from kstar_torch.train import (create_ensemble_state, create_train_state, fit_ensemble,
                               load_checkpoint, make_ensemble_step, make_train_step,
                               unstack_ensemble)
from kstar_torch.train.ensemble import make_ensemble_scan_steps, members_from_flax
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.config import MLSTMFCNConfig
from kstar_tpu.config import OptimConfig as JOptimConfig
from kstar_tpu.config import TrainConfig as JTrainConfig
from kstar_tpu.data import TSDataset as JTSDataset
from kstar_tpu.models import build_0d_model as j_build_0d_model
from kstar_tpu.models.vivit import ViViT as JViViT
from kstar_tpu.train import History as JHistory
from kstar_tpu.train import create_ensemble_state as j_create_ensemble_state
from kstar_tpu.train import fit_ensemble as j_fit_ensemble
from kstar_tpu.train import make_ensemble_step as j_make_ensemble_step

COLS = Schema.INPUT_FEATURES
SEEDS = (40, 41, 42)
SGD = dict(optimizer="SGD", lr=0.05, use_scheduler=True, step_size=2, gamma=0.5,
           max_norm_grad=1.0)
MLSTM = MLSTMFCNConfig(n_features=len(COLS), fcn_dim=16, seq_len=21, lstm_dim=16,
                       lstm_dropout=0.0, noise_std=0.0)
VIVIT = dict(image_size=32, patch_size=16, n_frames=5, dim=32, depth=1, n_heads=2,
             d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data(tiny_dataset):
    _, disrupt_df, ts_df = tiny_dataset
    df_train, df_valid, _, scaler = prepare_0d_dataset(ts_df, COLS, test_shot=None)
    mk = lambda cls, df: cls(df, disrupt_df, COLS, seq_len=21, dist=3, scaler=scaler)
    return (mk(TSDataset, df_train), mk(TSDataset, df_valid),
            mk(JTSDataset, df_train), mk(JTSDataset, df_valid))


def _mlstm(noise=1e-3, dropout=0.1):
    cfg = TMLSTMFCNConfig(**dict(dataclasses.asdict(MLSTM), noise_std=noise,
                                 lstm_dropout=dropout))
    return lambda gen: build_0d_model("MLSTM_FCN", cfg, generator=gen)


def _aux():
    return torch.ones(2), torch.tensor([0.3, 0.1])


def _shared_batches(ds, n=3, b=8):
    rng = np.random.default_rng(0)
    return [tuple(torch.as_tensor(a) for a in ds.batch(rng.permutation(len(ds))[:b]))
            for _ in range(n)]


def test_members_equal_solo_runs(data):
    """Dropout and input noise on: each member draws from its own seed's
    generators, exactly as a solo run of that seed."""
    train_ds = data[0]
    make = _mlstm()
    batches = _shared_batches(train_ds)
    states = create_ensemble_state(make, SEEDS, OptimConfig(**SGD), device="cpu")
    estep = make_ensemble_step(LossConfig())
    ens_losses = [estep(states, x, y, *_aux())[1] for x, y in batches]

    step = make_train_step(LossConfig())
    for i, seed in enumerate(SEEDS):
        solo = create_train_state(make(torch.Generator().manual_seed(seed)),
                                  OptimConfig(**SGD), seed=seed)
        for t, (x, y) in enumerate(batches):
            _, loss, _ = step(solo, x, y, *_aux())
            assert torch.equal(loss, ens_losses[t][i])
        member = unstack_ensemble(states, i)
        assert torch.equal(member.flat, solo.flat)
        assert torch.equal(member.stats_flat, solo.stats_flat)
        assert int(member.step) == 3 and member.seed == seed
    assert not torch.equal(states[0].flat, states[1].flat)


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        create_ensemble_state(_mlstm(), SEEDS, OptimConfig(lr=1e-3))


def _fit(data, tmp_path, k, make=None, epochs=2):
    train_ds, valid_ds = data[:2]
    states = create_ensemble_state(make or _mlstm(), SEEDS, OptimConfig(lr=1e-3),
                                   device="cpu")
    cfg = TrainConfig(batch_size=8, num_epoch=epochs, weight_dir=os.fspath(tmp_path),
                      early_stopping=False, verbose=0, steps_per_dispatch=k)
    return fit_ensemble(states, SEEDS, train_ds, valid_ds, cfg, LossConfig(loss_type="CE"),
                        tag="ens")


def test_scan_form_equals_per_step_form(data, tmp_path):
    s1, h1 = _fit(data, tmp_path / "k1", 1)
    s2, h2 = _fit(data, tmp_path / "k2", 2)
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-6)
        assert (a.valid_loss, a.valid_f1, a.train_f1, a.best_epoch) == \
            (b.valid_loss, b.valid_f1, b.train_f1, b.best_epoch)
    for a, b in zip(s1, s2):
        assert torch.equal(a.flat, b.flat) and torch.equal(a.stats_flat, b.stats_flat)
    # the K-step call itself: (N, K) losses and (N, K, B) predictions
    x = torch.stack([x for x, _ in _shared_batches(data[0], n=2)])
    y = torch.stack([y for _, y in _shared_batches(data[0], n=2)])
    states = create_ensemble_state(_mlstm(), SEEDS, OptimConfig(lr=1e-3), device="cpu")
    _, losses, preds = make_ensemble_scan_steps(LossConfig())(states, x, y, *_aux())
    assert losses.shape == (3, 2) and preds.shape == (3, 2, 8)


def test_fit_ensemble_checkpoints_and_histories(data, tmp_path):
    states, hists = _fit(data, tmp_path, 1)
    assert set(dataclasses.asdict(hists[0])) >= {f.name for f in dataclasses.fields(JHistory)}
    for s, h in zip(SEEDS, hists):
        assert len(h.train_loss) == len(h.valid_f1) == 2
        assert h.best_f1 == max(h.valid_f1) and h.valid_f1[h.best_epoch] == h.best_f1
        for end in ("last", "best"):
            assert (tmp_path / f"ens_seed_{s}_{end}.ckpt").exists()
        extra = (tmp_path / f"ens_seed_{s}_best.ckpt.json").read_text()
        assert f'"seed": {s}' in extra
    # a member's checkpoint restores into a solo state
    solo = create_train_state(_mlstm()(torch.Generator().manual_seed(0)), OptimConfig(lr=1e-3))
    load_checkpoint(solo, os.fspath(tmp_path / "ens_seed_41_last.ckpt"))
    assert torch.equal(solo.flat, states[1].flat) and solo.seed == 41


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_members(states, jstates):
    params = _np_tree(jstates.params)
    stats = _np_tree(jstates.batch_stats) or None
    for i, st in enumerate(states):
        member = lambda tree: jax.tree_util.tree_map(lambda a: a[i], tree)
        want = state_dict_from_flax(member(params), member(stats) if stats else None)
        got = st.model.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"member {i}: {k}")


@pytest.mark.parametrize("name", ["MLSTM_FCN", "ViViT"])
def test_bridged_members_step_as_jax(name, data):
    if name == "MLSTM_FCN":
        batches = [tuple(a.numpy() for a in b) for b in _shared_batches(data[0])]
        jmodel = j_build_0d_model("MLSTM_FCN", MLSTM)
        make = _mlstm(noise=0.0, dropout=0.0)
    else:
        rng = np.random.default_rng(1)
        batches = [(rng.normal(size=(4, 5, 32, 32, 3)).astype(np.float32),
                    rng.integers(0, 2, size=4)) for _ in range(3)]
        jmodel = JViViT(dtype=jnp.float32, **VIVIT)
        make = lambda gen: TViViT(**VIVIT, generator=gen)
    jstates = j_create_ensemble_state(jmodel, jnp.asarray(batches[0][0]), SEEDS,
                                      JOptimConfig(**SGD))
    states = create_ensemble_state(make, SEEDS, OptimConfig(**SGD), device="cpu")
    members_from_flax(states, _np_tree(jstates.params), _np_tree(jstates.batch_stats))
    _check_members(states, jstates)

    jstep = j_make_ensemble_step(jmodel, JLossConfig())
    tstep = make_ensemble_step(LossConfig())
    m = np.array([0.3, 0.1], np.float32)
    for x, y in batches:
        jstates, jl, _ = jstep(jstates, jnp.asarray(x), jnp.asarray(y), jnp.ones(2),
                               jnp.asarray(m), jnp.zeros(3))
        _, tl, _ = tstep(states, torch.as_tensor(x), torch.as_tensor(y).long(),
                         torch.ones(2), torch.as_tensor(m))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    _check_members(states, jstates)


def test_fit_ensemble_histories_equal_jax(data, tmp_path):
    train_ds, valid_ds, j_train_ds, j_valid_ds = data
    jmodel = j_build_0d_model("MLSTM_FCN", MLSTM)
    x0, _ = j_train_ds.batch(np.arange(8))
    jstates = j_create_ensemble_state(jmodel, jnp.asarray(x0), SEEDS, JOptimConfig(**SGD))
    states = create_ensemble_state(_mlstm(noise=0.0, dropout=0.0), SEEDS, OptimConfig(**SGD),
                                   device="cpu")
    members_from_flax(states, _np_tree(jstates.params), _np_tree(jstates.batch_stats))
    kw = dict(batch_size=8, num_epoch=2, early_stopping=False, verbose=0)
    jstates, jh = j_fit_ensemble(jmodel, jstates, SEEDS, j_train_ds, j_valid_ds,
                                 JTrainConfig(weight_dir=os.fspath(tmp_path / "j"), **kw),
                                 JLossConfig(), tag="ens")
    states, th = fit_ensemble(states, SEEDS, train_ds, valid_ds,
                              TrainConfig(weight_dir=os.fspath(tmp_path / "t"), **kw),
                              LossConfig(), tag="ens")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for a, b in zip(th, jh):
        for f in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-4, err_msg=f)
        for f in ("train_f1", "valid_f1", "train_acc", "valid_acc"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-6, err_msg=f)
        assert (a.best_epoch, a.best_f1) == (b.best_epoch, pytest.approx(b.best_f1))
    _check_members(states, jstates)
