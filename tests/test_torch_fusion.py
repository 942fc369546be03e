"""kstar_torch's four fusion models against kstar_tpu's, on the CPU.

The same flax weights (carried with ``state_dict_from_flax``) and the same
seeded inputs go through both packages in f32 at small widths (ViViT dim
32, depth 1, 2 heads x 16, scale 2, 32 px, patch 8, 5 frames; the 0D
Transformer 32 wide, 1 layer, 4 heads, FF 64):

* logits (the (multi, vis, ts) triple for the Gradient-Blending models),
  ``encode``, ``forward_video``/``forward_ts`` and ``forward_spatial_cls``
  to 1e-5;
* ``TFNGB``'s BatchNorm statistics after a train forward to 1e-6;
* ``forward_spatial_cls`` on a window's spatial-cls rows equals the full
  forward (the sweep's fast path);
* ``extract_spatial_weights`` finds each model's video encoder, in the
  flax tree and in the port module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.models import TFN as TTFN
from kstar_torch.models import TFNGB as TTFNGB
from kstar_torch.models import MultiModalConcat as TMultiModalConcat
from kstar_torch.models import MultiModalGB as TMultiModalGB
from kstar_torch.models.common import BatchNorm
from kstar_torch.ops.spatial_table import extract_spatial_weights
from kstar_torch.weights import spatial_weights_from_flax, state_dict_from_flax
from kstar_tpu.models import TFN, TFNGB, MultiModalConcat, MultiModalGB
from kstar_tpu.ops.spatial_table import extract_spatial_weights as j_extract_spatial_weights

B, L, PX, F = 4, 5, 32, 18
VIVIT_KW = dict(image_size=PX, patch_size=8, n_frames=L, dim=32, depth=1, n_heads=2,
                d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0)
TS_KW = dict(n_features=F, feature_dims=32, max_len=L, n_layers=1, n_heads=4,
             dim_feedforward=64, dropout=0.0, cls_dims=16, noise_std=0.0)
MODELS = {"concat": (MultiModalConcat, TMultiModalConcat),
          "concat_GB": (MultiModalGB, TMultiModalGB),
          "TFN": (TFN, TTFN), "TFN_GB": (TFNGB, TTFNGB)}
GB = ("concat_GB", "TFN_GB")
VIDEO_SUBTREE = {"concat": ("encoder_video",), "TFN": ("encoder_video",),
                 "concat_GB": ("vis_model", "encoder"), "TFN_GB": ("vis_model", "encoder")}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    x_v = rng.normal(scale=40.0, size=(b, L, PX, PX, 3)).astype(np.float32)
    x_t = rng.normal(size=(b, L, F)).astype(np.float32)
    return x_v, x_t


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pairs():
    """Each model's JAX module and variables (BatchNorm running statistics
    drawn off zeros/ones, so evaluation exercises them) and its port twin."""
    x_v, x_t = inputs()
    out = {}
    for i, (name, (jcls, tcls)) in enumerate(MODELS.items()):
        jm = jcls(vivit_kwargs=dict(VIVIT_KW), ts_kwargs=dict(TS_KW))
        variables = _np(jm.init({"params": jax.random.key(i), "noise": jax.random.key(9),
                                 "dropout": jax.random.key(9)},
                                jnp.asarray(x_v), jnp.asarray(x_t), train=False))
        rng = np.random.default_rng(100 + i)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, v: (rng.uniform(0.5, 2.0, v.shape) if path[-1].key == "var"
                             else rng.normal(0.0, 0.3, v.shape)).astype(np.float32),
            variables.get("batch_stats", {}))
        variables = {"params": variables["params"], "batch_stats": stats}
        tm = tcls(dict(VIVIT_KW), dict(TS_KW), generator=torch.Generator().manual_seed(i))
        tm.load_state_dict(state_dict_from_flax(variables["params"], stats), strict=True)
        out[name] = (jm, variables, tm.eval())
    return out


def _close(got, want, atol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    got = got.detach().numpy()
    assert got.shape == np.shape(want) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_and_encode_match_jax(name, pairs):
    jm, variables, tm = pairs[name]
    x_v, x_t = inputs(1)
    want = jm.apply(variables, jnp.asarray(x_v), jnp.asarray(x_t), train=False)
    with torch.no_grad():
        got = tm(torch.as_tensor(x_v), torch.as_tensor(x_t))
        enc = tm.encode(torch.as_tensor(x_v), torch.as_tensor(x_t))
    assert isinstance(got, tuple) == (name in GB)
    _close(got, want, 1e-5)
    _close(enc, jm.apply(variables, jnp.asarray(x_v), jnp.asarray(x_t), method="encode"),
           1e-5)


@pytest.mark.parametrize("name", GB)
def test_single_streams_match_jax(name, pairs):
    jm, variables, tm = pairs[name]
    x_v, x_t = inputs(2)
    with torch.no_grad():
        got_v = tm.forward_video(torch.as_tensor(x_v))
        got_t = tm.forward_ts(torch.as_tensor(x_t))
    _close(got_v, jm.apply(variables, jnp.asarray(x_v), method="forward_video"), 1e-5)
    _close(got_t, jm.apply(variables, jnp.asarray(x_t), method="forward_ts"), 1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_spatial_cls_matches_jax(name, pairs):
    jm, variables, tm = pairs[name]
    rng = np.random.default_rng(3)
    win_cls = rng.normal(size=(B, L, VIVIT_KW["dim"])).astype(np.float32)
    _, x_t = inputs(3)
    with torch.no_grad():
        got = tm.forward_spatial_cls(torch.as_tensor(win_cls), torch.as_tensor(x_t))
    _close(got, jm.apply(variables, jnp.asarray(win_cls), jnp.asarray(x_t),
                         method="forward_spatial_cls"), 1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_spatial_cls_equals_the_full_forward(name, pairs):
    """Each window's spatial-cls rows from ``embed_frames``/``spatial_cls``
    through ``forward_spatial_cls`` give the full forward's fusion logits."""
    _, _, tm = pairs[name]
    x_v, x_t = inputs(4)
    xv, xt = torch.as_tensor(x_v), torch.as_tensor(x_t)
    with torch.no_grad():
        full = tm(xv, xt)
        full = full[0] if isinstance(full, tuple) else full
        rows = [torch.stack([tm.spatial_cls(tm.embed_frames(xv[b]), off)[off]
                             for off in range(L)]) for b in range(B)]
        fast = tm.forward_spatial_cls(torch.stack(rows), xt)
    torch.testing.assert_close(fast, full, atol=1e-5, rtol=0)


def test_tfngb_batch_statistics_after_a_train_forward_match_jax(pairs):
    jm, variables, tm = pairs["TFN_GB"]
    x_v, x_t = inputs(5)
    out, mut = jm.apply(variables, jnp.asarray(x_v), jnp.asarray(x_t), train=True,
                        rngs={"noise": jax.random.key(0), "dropout": jax.random.key(1)},
                        mutable=["batch_stats"])
    tm = type(tm)(dict(VIVIT_KW), dict(TS_KW))
    tm.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]))
    got = tm(torch.as_tensor(x_v), torch.as_tensor(x_t), train=True)
    _close(tuple(t.detach() for t in got), out, 1e-5)
    want = state_dict_from_flax({}, _np(mut["batch_stats"]))
    bns = {n for n, m in tm.named_modules() if isinstance(m, BatchNorm)}
    assert bns == {"cls_bn", "ts_model.encoder.filter_bn"}
    for key, value in want.items():
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), value.numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
def test_extract_spatial_weights_finds_the_video_encoder(name, pairs):
    jm, variables, tm = pairs[name]
    depth = VIVIT_KW["depth"]
    from_module = extract_spatial_weights(tm, L, depth, torch.float32)
    node = variables["params"]
    for key in VIDEO_SUBTREE[name]:
        node = node[key]
    want = extract_spatial_weights({"x": node}, L, depth, torch.float32)
    from_tree = extract_spatial_weights(variables["params"], L, depth, torch.float32)
    from_jax = spatial_weights_from_flax(
        j_extract_spatial_weights(jax.tree_util.tree_map(jnp.asarray, variables["params"]), L, depth=depth, dtype=jnp.float32),
        torch.float32)
    for got in (from_module, from_tree, from_jax):
        for a, b in zip(jax.tree_util.tree_leaves(tuple(got)),
                        jax.tree_util.tree_leaves(tuple(want))):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
