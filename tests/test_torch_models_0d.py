"""kstar_torch's 0D models against kstar_tpu's on the CPU at f32, small widths.

The JAX model is initialised, its ``params``/``batch_stats`` are carried to
the port with ``kstar_torch.weights.state_dict_from_flax``, and the same
seeded inputs go through both: eval logits and ``encode`` within 1e-5; a
train-mode forward (noise 0, dropout 0) gives the same logits and the same
updated BatchNorm statistics within 1e-6. The pieces with traps of their
own are pinned apart: a 2-layer ``BiLSTM`` (cell order, one bias per gate),
a CnnLSTM whose LSTM input size (the conv output length) differs from its
channel count, the odd-width sinusoidal table, and flax's BatchNorm rules.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import CnnLSTMConfig as TCnnLSTMConfig
from kstar_torch.config import MLSTMFCNConfig as TMLSTMFCNConfig
from kstar_torch.config import TransformerConfig as TTransformerConfig
from kstar_torch.models import build_0d_model
from kstar_torch.models.common import BatchNorm, BiLSTM, sinusoidal_positions
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import CnnLSTMConfig, MLSTMFCNConfig, TransformerConfig
from kstar_tpu.models import build_0d_model as j_build_0d_model
from kstar_tpu.models.common import BiLSTM as JBiLSTM
from kstar_tpu.models.common import sinusoidal_positions as j_sinusoidal_positions

B, T, F = 8, 21, 18
# tests/test_models_0d.py's small configurations (noise and dropout off, so
# a train-mode forward is deterministic on both sides)
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


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_variables(model, x, seed=0):
    """Initialised variables with running statistics moved off their
    zeros/ones start, so evaluation exercises them."""
    v = model.init({"params": jax.random.key(seed), "noise": jax.random.key(1),
                    "dropout": jax.random.key(2)}, x, train=False)
    rng = np.random.default_rng(seed + 7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.3, a.shape)).astype(np.float32),
        to_np(v.get("batch_stats", {})))
    return {"params": to_np(v["params"]), "batch_stats": stats}


def torch_twin(name, cfg, variables):
    tcfg = TORCH_CFG[name](**dataclasses.asdict(cfg))
    tm = build_0d_model(name, tcfg)
    tm.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]),
                       strict=True)
    return tm


@pytest.fixture(scope="module")
def pairs():
    x = np.random.default_rng(0).normal(size=(B, T, F)).astype(np.float32)
    out = {}
    for name, cfg in SMALL.items():
        jm = j_build_0d_model(name, cfg)
        v = jax_variables(jm, jnp.asarray(x))
        out[name] = (jm, v, torch_twin(name, cfg, v))
    return x, out


def n_leaves(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", list(SMALL))
def test_eval_logits_and_encode_match_jax(name, pairs):
    x, models = pairs
    jm, v, tm = models[name]
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    want_h = np.asarray(jm.apply(v, jnp.asarray(x), method="encode"))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
        got_h = tm.encode(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_h, want_h, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(SMALL))
def test_train_forward_and_batch_stats_match_jax(name, pairs):
    """One train-mode forward: the batch statistics normalise the batch and
    the running buffers move by flax's rule."""
    x, models = pairs
    jm, v, _ = models[name]
    tm = torch_twin(name, SMALL[name], v)       # fresh buffers
    want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                         rngs={"noise": jax.random.key(3), "dropout": jax.random.key(4)})
    got = tm(torch.as_tensor(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = state_dict_from_flax({}, to_np(mut["batch_stats"]))
    assert stats, name
    sd = tm.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", list(SMALL))
def test_trainable_parameters_are_flax_params(name, pairs):
    """The same count of trainable numbers as flax's ``params`` (one LSTM
    bias per gate, not torch's two) and buffers exactly flax's batch_stats."""
    _, models = pairs
    _, v, tm = models[name]
    assert sum(p.numel() for p in tm.parameters()) == n_leaves(v["params"])
    assert sum(b.numel() for b in tm.state_dict().values()) == n_leaves(v)
    for mod_name, mod in tm.named_modules():
        if mod_name.split(".")[-1].startswith("OptimizedLSTMCell_"):
            assert sorted(n for n, _ in mod.named_parameters()) == ["bias", "w_hh", "w_ih"]


def test_bilstm_two_layers_matches_flax():
    """Pins the cell order (layer l direction d is cell l*2+d), the reverse
    direction kept in order, and the gate packing."""
    H, fin = 8, 5
    x = np.random.default_rng(1).normal(size=(3, 7, fin)).astype(np.float32)
    jm = JBiLSTM(H, n_layers=2, bidirectional=True)
    params = to_np(jm.init(jax.random.key(5), jnp.asarray(x))["params"])
    assert sorted(params) == [f"OptimizedLSTMCell_{i}" for i in range(4)]
    tm = BiLSTM(fin, H, n_layers=2, bidirectional=True)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == (3, 7, 2 * H)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # one bias per gate: 4H per cell, not 8H
    assert tm.OptimizedLSTMCell_3.bias.shape == (4 * H,)


def test_cnn_lstm_runs_its_lstm_over_channels():
    """seq_len 13 with VALID convs gives T' = 9 tokens' features; the LSTM's
    input size is 9 (the conv output length), not conv_dim 8."""
    cfg = CnnLSTMConfig(seq_len=13, n_features=F, conv_dim=8, conv_kernel=3,
                        conv_padding=0, lstm_dim=6, n_layers=1, noise_std=0.0)
    x = np.random.default_rng(2).normal(size=(4, 13, F)).astype(np.float32)
    jm = j_build_0d_model("CnnLSTM", cfg)
    v = jax_variables(jm, jnp.asarray(x), seed=3)
    tm = torch_twin("CnnLSTM", cfg, v)
    assert tm.lstm.OptimizedLSTMCell_0.w_ih.shape == (4 * 6, 9)
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d_model", [7, 33, 32])
def test_sinusoidal_positions_match_jax(d_model):
    np.testing.assert_array_equal(sinusoidal_positions(21, d_model).numpy(),
                                  np.asarray(j_sinusoidal_positions(21, d_model)))


def test_batch_norm_is_flax_batch_norm():
    """Momentum 0.99 on the running buffers and the BIASED batch variance
    (torch.nn.BatchNorm1d would take 0.1 and the unbiased one)."""
    x = np.random.default_rng(4).normal(1.0, 2.0, size=(6, 5, 3)).astype(np.float32)
    bn = BatchNorm(3)
    y = bn(torch.as_tensor(x), train=True).detach().numpy()
    flat = x.reshape(-1, 3).astype(np.float64)
    mean, var = flat.mean(0), flat.var(0)            # ddof 0
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.01 * mean, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 + 0.01 * var, rtol=1e-5)
    np.testing.assert_allclose(y, (x - mean) / np.sqrt(var + 1e-5), atol=1e-5)
    # evaluation normalises with the running buffers
    y_eval = bn(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(
        y_eval, (x - bn.running_mean.numpy()) / np.sqrt(bn.running_var.numpy() + 1e-5),
        atol=1e-5)


def test_port_initialisation_follows_flax_distributions():
    """lecun-normal input kernels, an orthogonal block per recurrent gate,
    zero biases; the same generator seed gives the same weights."""
    m1 = BiLSTM(64, 32, generator=torch.Generator().manual_seed(0))
    m2 = BiLSTM(64, 32, generator=torch.Generator().manual_seed(0))
    for (n1, p1), (_, p2) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(p1, p2), n1
    cell = m1.OptimizedLSTMCell_0
    assert abs(float(cell.w_ih.detach().std()) - (1 / 64) ** 0.5) < 0.02
    for gate in cell.w_hh.detach().chunk(4):
        np.testing.assert_allclose((gate @ gate.T).numpy(), np.eye(32), atol=1e-5)
    assert float(cell.bias.detach().abs().max()) == 0.0
