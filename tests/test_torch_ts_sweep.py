"""kstar_torch's 0D inference against kstar_tpu's on the CPU at f32, small
widths, weights carried with ``state_dict_from_flax``:

* ``TSSweeper`` for each 0D model over a ragged table (a chunk count that
  is no bucket, windows clipped at the table's end), and ``predict_0d_shot``
  (shot-refit scaler, zero padding, re-interpolation, moving average):
  probabilities within 1e-5, the time axis exact;
* the 0D ``StreamingPredictor`` driving a real MLSTM-FCN, in blocks and in
  single pushes: probabilities within 1e-5, equal alarms and ``alarm_time``;
* permutation feature importance against
  ``compute_permute_feature_importance`` within rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import CnnLSTMConfig as TCnnLSTMConfig
from kstar_torch.config import LossConfig
from kstar_torch.config import MLSTMFCNConfig as TMLSTMFCNConfig
from kstar_torch.config import TransformerConfig as TTransformerConfig
from kstar_torch.data import Scaler, TSDataset
from kstar_torch.eval import compute_permute_feature_importance
from kstar_torch.infer import StreamingPredictor, TSSweeper, predict_0d_shot
from kstar_torch.models import build_0d_model
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import CnnLSTMConfig, MLSTMFCNConfig, OptimConfig, Schema, TransformerConfig
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.data import Scaler as JScaler
from kstar_tpu.data import TSDataset as JTSDataset
from kstar_tpu.data import synthetic
from kstar_tpu.eval import compute_permute_feature_importance as j_fi
from kstar_tpu.infer import continuous as jc
from kstar_tpu.infer import streaming as js
from kstar_tpu.models import build_0d_model as j_build_0d_model
from kstar_tpu.train.state import create_train_state as j_create_train_state

T, F = 21, 18
SMALL = {
    "Transformer": TransformerConfig(n_features=F, feature_dims=32, n_layers=1, n_heads=4,
                                     dim_feedforward=64, cls_dims=16, max_len=T),
    "CnnLSTM": CnnLSTMConfig(seq_len=T, n_features=F, conv_dim=16, lstm_dim=16, n_layers=1),
    "MLSTM_FCN": MLSTMFCNConfig(n_features=F, fcn_dim=16, seq_len=T, lstm_dim=16, alpha=0.01),
}
TORCH_CFG = {"Transformer": TTransformerConfig, "CnnLSTM": TCnnLSTMConfig,
             "MLSTM_FCN": TMLSTMFCNConfig}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, variables, port model) per 0D model, the running
    statistics moved off their start values."""
    out = {}
    rng = np.random.default_rng(3)
    for name, cfg in SMALL.items():
        jm = j_build_0d_model(name, cfg)
        v = _np(jm.init({"params": jax.random.key(1), "noise": jax.random.key(2),
                         "dropout": jax.random.key(3)}, jnp.zeros((2, T, F)), train=False))
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                          else rng.normal(0, 0.3, a.shape)).astype(np.float32),
            v["batch_stats"])
        v = {"params": v["params"], "batch_stats": stats}
        tm = build_0d_model(name, TORCH_CFG[name](**dataclasses.asdict(cfg)))
        tm.load_state_dict(state_dict_from_flax(v["params"], stats), strict=True)
        out[name] = (jm, v, tm)
    return out


def _table(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=(n, F)), axis=0) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", list(SMALL))
def test_ts_sweeper_matches_jax(name, pairs):
    """100 rows, 79 windows in chunks of 16: 5 chunks padded to the bucket,
    the last windows' indices clipped at the table's end."""
    jm, v, tm = pairs[name]
    data = _table()
    starts = np.arange(len(data) - T + 2, dtype=np.int64)      # the last 2 clip
    want = jc.TSSweeper(jm, v["params"], v["batch_stats"], T, batch_size=16).sweep(data, starts)
    got = TSSweeper(tm, T, batch_size=16, device="cpu").sweep(data, starts)
    assert got.shape == want.shape == (len(starts),)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_predict_0d_shot_matches_jax(pairs):
    jm, v, tm = pairs["MLSTM_FCN"]
    data = _table(160, seed=1)
    times = 1.3 + np.arange(len(data)) * (4.0 / 210.0)
    jt, jp = jc.predict_0d_shot(jm, v["params"], v["batch_stats"], data, times,
                                JScaler("Robust"), seq_len=T, dist=3, batch_size=32)
    tt, tp = predict_0d_shot(tm, data, times, Scaler("Robust"), seq_len=T, dist=3,
                             batch_size=32, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=1e-5)
    assert tp.max() > 0.0          # the curve is not all suppression


def test_streaming_0d_with_mlstm_fcn_matches_jax(pairs):
    jm, v, tm = pairs["MLSTM_FCN"]
    samples = _table(40, seed=2)
    kw = dict(seq_len=T, fps=10.0, suppress_s=0.5, modality="0D", n_features=F)

    def run(threshold, k):
        jp = js.StreamingPredictor(jm, v["params"], v["batch_stats"], threshold=threshold,
                                   compute_dtype=jnp.float32, **kw)
        tp = StreamingPredictor(tm, threshold=threshold, compute_dtype=torch.float32,
                                device="cpu", **kw)
        out = []
        for p in (jp, tp):
            if k == 1:
                res = [p.push(s) for s in samples]
                out.append((np.array([r[0] for r in res]), np.array([r[1] for r in res])))
            else:
                res = [p.push_block(samples[i:i + k]) for i in range(0, len(samples), k)]
                out.append(tuple(np.concatenate([r[i] for r in res]) for i in (0, 1)))
        return out, jp.alarm_time, tp.alarm_time

    (j0, _), _, _ = run(0.5, 4)
    thr = float(np.median(j0[0][T:]))          # alarms on about half the armed samples
    for k in (4, 1):
        ((jprob, jal), (tprob, tal)), jt, tt = run(thr, k)
        np.testing.assert_allclose(tprob, jprob, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tal, jal)
        assert jal.any() and tt == jt


def test_feature_importance_matches_jax(pairs):
    jm, v, tm = pairs["MLSTM_FCN"]
    cols = Schema.INPUT_FEATURES
    _, disrupt_df, ts_df = synthetic.make_dataset(n_shots=3, n_frames=128, height=8,
                                                  width=8, seed=4)
    jsc = JScaler("Robust").fit(ts_df[cols].to_numpy(np.float32))
    tsc = Scaler("Robust").fit(ts_df[cols].to_numpy(np.float32))
    jds = JTSDataset(ts_df, disrupt_df, cols, seq_len=T, dist=3, scaler=jsc)
    tds = TSDataset(ts_df, disrupt_df, cols, seq_len=T, dist=3, scaler=tsc)
    assert len(jds) == len(tds) > 8 and len(tds) % 8      # a padded last batch
    state = j_create_train_state(jm, jnp.zeros((2, T, F)), jax.random.key(0), OptimConfig())
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    want = j_fi(jm, state, jds, JLossConfig(), batch_size=8)
    got = compute_permute_feature_importance(tm, tds, LossConfig(), batch_size=8)
    assert list(got) == list(want) == cols
    np.testing.assert_allclose([got[c] for c in cols], [want[c] for c in cols],
                               rtol=1e-4, atol=1e-7)
    assert max(got.values()) > 0
