"""kstar_torch's multimodal training against kstar_tpu's, on the CPU.

The fusion models at small widths (as in test_torch_fusion.py), f32,
dropout and input noise 0, the same flax weights on both sides:

* ``multi`` (MultiModalConcat, TFN) and ``multi-GB`` (MultiModalGB, TFNGB)
  train steps under SGD with momentum, clipping and the staircase decay:
  losses rtol 1e-4, parameters and batch statistics atol 1e-5 (SGD and not
  Adam for the reason test_torch_train_0d.py gives);
* each Gradient-Blending stream step against ``make_stream_step``: the
  inactive stream's parameters stay exactly as they were, and the
  optimizer state (the momentum of every parameter, the count) moves as
  JAX's does;
* ``gb_estimate``'s weights against JAX's on one paired set, rtol 1e-3;
* two epochs of ``fit_gb`` write the last and best checkpoints, the best
  with its ``gb_weights``; the caller's state survives the probes;
* one CCA step: the loss at rtol 1e-4, the gradients within 5e-5 of their
  largest element (the two packages' f32 eigensolvers differ).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import LossConfig, OptimConfig, TrainConfig
from kstar_torch.models import TFN as TTFN
from kstar_torch.models import TFNGB as TTFNGB
from kstar_torch.models import MultiModalConcat as TMultiModalConcat
from kstar_torch.models import MultiModalGB as TMultiModalGB
from kstar_torch.train import create_train_state, make_train_step
from kstar_torch.train.cca import make_cca_step
from kstar_torch.train.gb import fit_gb, gb_estimate, make_stream_step
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.config import OptimConfig as JOptimConfig
from kstar_tpu.losses import cca_loss as j_cca_loss
from kstar_tpu.models import TFN, TFNGB, MultiModalConcat, MultiModalGB
from kstar_tpu.train.gb import gb_estimate as j_gb_estimate
from kstar_tpu.train.gb import make_stream_step as j_make_stream_step
from kstar_tpu.train.loop import make_train_step as j_make_train_step
from kstar_tpu.train.state import create_train_state as j_create_train_state

B, L, PX, F, STEPS = 8, 5, 32, 18, 3
VIVIT_KW = dict(image_size=PX, patch_size=8, n_frames=L, dim=32, depth=1, n_heads=2,
                d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0)
TS_KW = dict(n_features=F, feature_dims=32, max_len=L, n_layers=1, n_heads=4,
             dim_feedforward=64, dropout=0.0, cls_dims=16, noise_std=0.0)
MODELS = {"concat": (MultiModalConcat, TMultiModalConcat, "multi"),
          "TFN": (TFN, TTFN, "multi"),
          "concat_GB": (MultiModalGB, TMultiModalGB, "multi-GB"),
          "TFN_GB": (TFNGB, TTFNGB, "multi-GB")}
OPTIM = dict(optimizer="SGD", lr=0.05, use_scheduler=True, step_size=2, gamma=0.5,
             max_norm_grad=1.0)
GB_W = np.array([0.2, 0.3, 0.5], np.float32)
# CCA: more samples than the two latents' 64 widths, so both covariances
# have full rank and eigh's backward sees no repeated eigenvalue
CCA_BATCH, CCA_OUT = 128, 4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(seed=0, steps=STEPS, b=B):
    rng = np.random.default_rng(seed)
    video = rng.normal(scale=40.0, size=(steps, b, L, PX, PX, 3)).astype(np.float32)
    ts = rng.normal(size=(steps, b, L, F)).astype(np.float32)
    labels = rng.integers(0, 2, size=(steps, b)).astype(np.int64)
    return video, ts, labels


class PairedSet:
    """A paired video + 0D set with the dataset interface both packages'
    epoch drivers read (``batch``, ``class_counts``, ``len``)."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.video = rng.normal(scale=40.0, size=(n, L, PX, PX, 3)).astype(np.float32)
        self.ts = rng.normal(size=(n, L, F)).astype(np.float32)
        self.labels = rng.integers(0, 2, size=n).astype(np.int64)
        self.labels[:2] = [0, 1]

    def __len__(self):
        return len(self.labels)

    def class_counts(self):
        return np.bincount(self.labels, minlength=2)

    def batch(self, idx):
        idx = np.asarray(idx)
        return {"video": self.video[idx], "0D": self.ts[idx]}, self.labels[idx]


def _jax_state(name, optim=OPTIM, seed=0):
    jcls = MODELS[name][0]
    jm = jcls(vivit_kwargs=dict(VIVIT_KW), ts_kwargs=dict(TS_KW))
    video, ts, _ = _batches()
    state = j_create_train_state(jm, None, jax.random.key(seed), JOptimConfig(**optim),
                                 steps_per_epoch=1,
                                 apply_args=(jnp.asarray(video[0]), jnp.asarray(ts[0])))
    return jm, state


def _torch_state(name, params, stats, optim=OPTIM):
    tm = MODELS[name][1](dict(VIVIT_KW), dict(TS_KW))
    tm.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return create_train_state(tm, OptimConfig(**optim), steps_per_epoch=1)


def _aux():
    return torch.ones(2), torch.tensor([0.3, 0.5])


def _assert_params(tm, params, stats, atol, err=""):
    want = state_dict_from_flax(_np(params), _np(stats))
    got = tm.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, rtol=0,
                                   err_msg=f"{err}{key}")


def _jax_steps(name):
    """The model's JAX train steps from its starting weights."""
    video, ts, labels = _batches()
    jm, state = _jax_state(name)
    start = (_np(state.params), _np(state.batch_stats))
    step = j_make_train_step(jm, JLossConfig(), MODELS[name][2])
    losses = []
    for i in range(STEPS):
        batch = {"video": jnp.asarray(video[i]), "0D": jnp.asarray(ts[i])}
        state, loss, _ = step(state, batch, jnp.asarray(labels[i]), jnp.ones(2),
                              jnp.asarray([0.3, 0.5]), jnp.asarray(GB_W))
        losses.append(float(loss))
    return start, losses, _np(state.params), _np(state.batch_stats)


@pytest.mark.parametrize("name", list(MODELS))
def test_multimodal_train_steps_match_jax(name):
    video, ts, labels = _batches()
    (params0, stats0), jlosses, jparams, jstats = _jax_steps(name)
    state = _torch_state(name, params0, stats0)
    step = make_train_step(LossConfig(), model_type=MODELS[name][2])
    gb_w = torch.as_tensor(GB_W)
    losses = []
    for i in range(STEPS):
        batch = {"video": torch.as_tensor(video[i]), "0D": torch.as_tensor(ts[i])}
        _, loss, preds = step(state, batch, torch.as_tensor(labels[i]), *_aux(), gb_w)
        losses.append(float(loss))
        assert preds.shape == (B,)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert int(state.step) == STEPS
    _assert_params(state.model, jparams, jstats, 1e-5)


def test_model_type_is_checked():
    with pytest.raises(ValueError, match="model_type"):
        make_train_step(LossConfig(), model_type="fusion")


def _trace(opt_state):
    """The SGD momentum tree of an optax chain's state."""
    is_trace = lambda x: type(x).__name__ == "TraceState"
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_trace)
             if is_trace(s)]
    assert len(found) == 1
    return _np(found[0].trace)


@pytest.mark.parametrize("stream", ["video", "0D", "multi"])
def test_stream_steps_match_jax(stream):
    name = "TFN_GB"
    video, ts, labels = _batches(3)
    jm, jstate = _jax_state(name)
    params0, stats0 = _np(jstate.params), _np(jstate.batch_stats)
    batch = {"video": jnp.asarray(video[0]), "0D": jnp.asarray(ts[0])}
    jstep = j_make_stream_step(jm, JLossConfig(), stream)
    jstate, jloss = jstep(jstate, batch, jnp.asarray(labels[0]), jnp.ones(2),
                          jnp.asarray([0.3, 0.5]))
    jstate, jloss2 = jstep(jstate, {"video": jnp.asarray(video[1]), "0D": jnp.asarray(ts[1])},
                           jnp.asarray(labels[1]), jnp.ones(2), jnp.asarray([0.3, 0.5]))

    state = _torch_state(name, params0, stats0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_stream_step(LossConfig(), stream)
    losses = []
    for i in range(2):
        tb = {"video": torch.as_tensor(video[i]), "0D": torch.as_tensor(ts[i])}
        _, loss = step(state, tb, torch.as_tensor(labels[i]), *_aux())
        losses.append(float(loss))
    np.testing.assert_allclose(losses, [float(jloss), float(jloss2)], rtol=1e-4)
    _assert_params(state.model, jstate.params, jstate.batch_stats, 1e-5)
    # the inactive stream is exactly where it started, the active one moved
    frozen = {"video": "ts_model.", "0D": "vis_model."}.get(stream)
    active = {"video": "vis_model.", "0D": "ts_model."}.get(stream)
    after = state.model.state_dict()
    for key, value in before.items():
        if frozen and key.startswith(frozen) and "running_" not in key:
            assert torch.equal(after[key], value), key
        if frozen and key.startswith("cls_fc"):
            assert torch.equal(after[key], value), key
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith(active or ""))
    # the optimizer state moves for every parameter, as in JAX
    assert int(state.opt_state["count"]) == 2
    want = state_dict_from_flax(_trace(jstate.opt_state))
    offset = 0
    for pname, p in state.model.named_parameters():
        got = state.opt_state["trace"][offset:offset + p.numel()].view_as(p)
        offset += p.numel()
        np.testing.assert_allclose(got.numpy(), want[pname].numpy(), atol=1e-5, rtol=0,
                                   err_msg=pname)


def test_gb_estimate_matches_jax():
    name = "concat_GB"
    train_ds, valid_ds = PairedSet(24, 10), PairedSet(16, 11)
    jm, jstate = _jax_state(name, seed=2)
    params0, stats0 = _np(jstate.params), _np(jstate.batch_stats)
    want = j_gb_estimate(jm, jstate, train_ds, valid_ds, JLossConfig(), batch_size=8,
                         n_epochs=2, seed=7)
    state = _torch_state(name, params0, stats0)
    flat0 = state.flat.clone()
    got = gb_estimate(state, train_ds, valid_ds, LossConfig(), batch_size=8,
                      n_epochs=2, seed=7)
    assert list(got) == ["video", "0D", "multi"]
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in got], rtol=1e-3)
    assert abs(sum(got.values()) - 1.0) < 1e-9
    # the probes trained copies: the caller's state is as it was
    assert torch.equal(state.flat, flat0) and int(state.step) == 0


def test_fit_gb_writes_checkpoints_with_gb_weights(tmp_path):
    name = "TFN_GB"
    _, jstate = _jax_state(name, seed=3)
    state = _torch_state(name, _np(jstate.params), _np(jstate.batch_stats))
    cfg = TrainConfig(batch_size=8, num_epoch=2, seed=0, weight_dir=str(tmp_path),
                      save_dir=str(tmp_path), early_stopping=False, verbose=1)
    state, hist, gb_w = fit_gb(state, PairedSet(24, 20), PairedSet(16, 21), cfg,
                               LossConfig(), tag="gb", dynamic=True,
                               epoch_per_gb_estimate=1, n_epochs_gb_estimate=1)
    assert len(hist.train_loss) == 2 and np.isfinite(hist.train_loss).all()
    assert int(state.step) == 2 * 3
    assert os.path.exists(tmp_path / "gb_last.ckpt") and os.path.exists(tmp_path / "gb_best.ckpt")
    extra = json.loads((tmp_path / "gb_best.ckpt.json").read_text())
    assert set(extra["gb_weights"]) == {"video", "0D", "multi"}
    assert abs(sum(gb_w.values()) - 1.0) < 1e-9


def test_cca_step_matches_jax():
    name = "concat"
    video, ts, _ = _batches(4, steps=1, b=CCA_BATCH)
    jm, jstate = _jax_state(name, seed=4)
    params0, stats0 = _np(jstate.params), _np(jstate.batch_stats)
    batch = {"video": jnp.asarray(video[0]), "0D": jnp.asarray(ts[0])}

    @jax.jit
    def loss_and_grads(params):
        """kstar_tpu/train/cca.py make_cca_step's loss and gradients."""
        def loss_fn(p):
            _, h_vis, h_ts = jm.apply({"params": p, "batch_stats": jstate.batch_stats},
                                      batch["video"], batch["0D"], method="encode")
            return j_cca_loss(h_vis, h_ts, CCA_OUT)
        return jax.value_and_grad(loss_fn)(params)

    jloss, jgrads = loss_and_grads(jstate.params)
    state = _torch_state(name, params0, stats0)
    _, loss = make_cca_step(CCA_OUT)(state, {"video": torch.as_tensor(video[0]),
                                             "0D": torch.as_tensor(ts[0])})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    want = state_dict_from_flax(_np(jgrads))
    got = {n: p.grad for n, p in state.model.named_parameters()}
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    assert np.isfinite(scale) and scale > 0
    for key, value in want.items():
        g = got[key] if got[key] is not None else torch.zeros_like(value)
        np.testing.assert_allclose(g.numpy(), value.numpy(), atol=5e-5 * scale, rtol=0,
                                   err_msg=key)
    assert int(state.step) == 1
