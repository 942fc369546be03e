"""kstar_torch reads and writes the JAX package's flax checkpoints, on the
CPU at small widths (f32):

* ``read_flax_checkpoint`` equals ``flax.serialization.msgpack_restore``
  leaf for leaf, bit for bit, on files ``kstar_tpu.train.state
  .save_checkpoint`` writes (ViViT, MLSTM-FCN, SlowFast with SubBatchNorm,
  the concat fusion model), on a bf16-stored file, on a tree of every
  msgpack type flax emits (bf16, uint32 key data, numpy scalars, ints of
  each width) and on flax's chunked form (``MAX_CHUNK_SIZE`` patched small
  in this process); ``write_flax_checkpoint`` writes the same bytes as
  ``flax.serialization.to_bytes``;
* ``load_params`` on a JAX file gives JAX's ``model.apply`` logits to 1e-5;
* ``flax_from_state_dict(state_dict_from_flax(t)) == t`` for the trees of
  JAX's ``model.init`` (their shapes from ``jax.eval_shape``, seeded
  values) of all eleven model families;
* ``load_checkpoint`` on a JAX file (SGD and Adam, clipping and the
  staircase on, dropout 0): the port's next step equals JAX's next step
  (losses 5e-7 relative, parameters 1.4e-6), and the port's state written
  back (``flax_checkpoint_tree``) equals the file and resumes in JAX;
* a mismatched tree raises before anything is loaded; a ``torch.save``
  file still loads;
* ``evaluate_model --synthetic`` reports the same from a JAX ``weight_dir``
  as from the same weights converted in memory; ``train_0d --resume``
  continues from a JAX ``{tag}_last.ckpt``.
"""

import re

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kstar_torch.config as TC
import kstar_torch.models as TM
import kstar_tpu.config as JC
from kstar_torch.cli import evaluate_model, train_0d
from kstar_torch.config import LossConfig
from kstar_torch.models import build_0d_model, build_video_model
from kstar_torch.train import (create_train_state, load_checkpoint, load_params,
                               make_train_step, save_checkpoint)
from kstar_torch.train import flax_ckpt
from kstar_torch.train.flax_ckpt import (is_flax_checkpoint, read_flax_checkpoint,
                                         write_flax_checkpoint)
from kstar_torch.train.state import flax_checkpoint_tree
from kstar_torch.weights import flax_from_state_dict, state_dict_from_flax
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.models import TFN, TFNGB, MultiModalConcat, MultiModalGB
from kstar_tpu.models import build_0d_model as j_build_0d_model
from kstar_tpu.models import build_video_model as j_build_video_model
from kstar_tpu.train.loop import make_train_step as j_make_train_step
from kstar_tpu.train.state import TrainState as JTrainState
from kstar_tpu.train.state import create_train_state as j_create_train_state
from kstar_tpu.train.state import load_checkpoint as j_load_checkpoint
from kstar_tpu.train.state import make_optimizer as j_make_optimizer
from kstar_tpu.train.state import save_checkpoint as j_save_checkpoint

F, T0D = 18, 21
VIVIT = dict(image_size=32, patch_size=16, n_frames=5, dim=32, depth=1, n_heads=2,
             d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0)
FUSION_VIVIT = dict(VIVIT, patch_size=8)
FUSION_TS = dict(n_features=F, feature_dims=32, max_len=5, n_layers=1, n_heads=4,
                 dim_feedforward=64, dropout=0.0, cls_dims=16, noise_std=0.0)
MLSTM = dict(n_features=F, fcn_dim=16, seq_len=T0D, lstm_dim=16, noise_std=0.0)
SLOWFAST = dict(image_size=32, n_frames=8, layers=(1, 1, 1, 1), base_bn_splits=2)
ADAM = dict(optimizer="Adam", lr=1e-3, use_scheduler=True, step_size=2, gamma=0.5,
            max_norm_grad=3.0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(key, seed=0):
    """The model's inputs as numpy arrays (a tuple)."""
    rng = np.random.default_rng(seed)
    if key == "MLSTM_FCN":
        return (rng.normal(size=(4, T0D, F)).astype(np.float32),)
    if key == "SlowFast_subbn2":
        return (rng.normal(size=(4, 8, 32, 32, 3)).astype(np.float32),)
    x_v = rng.normal(scale=40.0, size=(4, 5, 32, 32, 3)).astype(np.float32)
    if key == "concat":
        return x_v, rng.normal(size=(4, 5, F)).astype(np.float32)
    return (x_v,)


def _jax_model(key):
    if key == "ViViT":
        return j_build_video_model("ViViT", JC.ViViTConfig(**VIVIT))
    if key == "MLSTM_FCN":
        return j_build_0d_model("MLSTM_FCN", JC.MLSTMFCNConfig(**MLSTM))
    if key == "SlowFast_subbn2":
        return j_build_video_model("SlowFast", JC.SlowFastConfig(**SLOWFAST))
    return MultiModalConcat(vivit_kwargs=dict(FUSION_VIVIT), ts_kwargs=dict(FUSION_TS))


def _port_model(key, seed=1):
    gen = torch.Generator().manual_seed(seed)
    if key == "ViViT":
        return build_video_model("ViViT", TC.ViViTConfig(**VIVIT), generator=gen)
    if key == "MLSTM_FCN":
        return build_0d_model("MLSTM_FCN", TC.MLSTMFCNConfig(**MLSTM), generator=gen)
    if key == "SlowFast_subbn2":
        return build_video_model("SlowFast", TC.SlowFastConfig(**SLOWFAST), generator=gen)
    return TM.MultiModalConcat(dict(FUSION_VIVIT), dict(FUSION_TS), generator=gen)


CKPT_MODELS = ("ViViT", "MLSTM_FCN", "SlowFast_subbn2", "concat")


def _jax_state(jm, args, optim: dict, seed: int):
    """A ``kstar_tpu`` TrainState with seeded variables in the shapes of
    ``jm.init`` (``jax.eval_shape``: the eager init of the LSTM and conv
    models takes a minute on the CPU): kernels N(0, 1/fan_in), scales in
    [0.5, 1.5], biases N(0, 0.3), running means N(0, 0.3) and variances in
    [0.5, 2] (SubBatchNorm's split statistics too), so that evaluation
    exercises the statistics; the optimizer state from ``tx.init``."""
    key = jax.random.key(seed)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "noise": key, "dropout": key},
                                            *args, train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif "var" in leaf:
            v = rng.uniform(0.5, 2.0, s.shape)
        else:
            v = rng.normal(0.0, 0.3, s.shape)
        return jnp.asarray(v, s.dtype)

    v = jax.tree_util.tree_map_with_path(fill, {k: dict(v) for k, v in shapes.items()})
    tx = j_make_optimizer(JC.OptimConfig(**optim))
    return JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v.get("batch_stats", {}), opt_state=tx.init(v["params"]),
                       rng=key, tx=tx)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """key -> (JAX model, its state, the checkpoint path JAX wrote)."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    out = {}
    for i, key in enumerate(CKPT_MODELS):
        jm = _jax_model(key)
        state = _jax_state(jm, [jnp.asarray(a) for a in _inputs(key)], ADAM, i)
        path = str(root / f"{key}_best.ckpt")
        j_save_checkpoint(state, path)
        out[key] = (jm, state, path)
    return out


def _same_leaves(got, want, where=""):
    """``got`` (read_flax_checkpoint) against ``want`` (msgpack_restore):
    the same keys, and each array bit for bit in shape and dtype name."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _same_leaves(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), where
        assert tuple(got.shape) == want.shape, where
        assert flax_ckpt.DTYPE_NAMES[got.dtype] == want.dtype.name, where
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == want.tobytes(), where
        return
    assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("key", CKPT_MODELS)
def test_read_equals_msgpack_restore(key, jax_files, tmp_path):
    path = jax_files[key][2]
    raw = open(path, "rb").read()
    tree = read_flax_checkpoint(path)
    _same_leaves(tree, fs.msgpack_restore(raw))
    assert tree["rng"].dtype == torch.uint32 and is_flax_checkpoint(path)
    # writing the tree back gives the file's bytes
    write_flax_checkpoint(str(tmp_path / "again.ckpt"), tree)
    assert (tmp_path / "again.ckpt").read_bytes() == raw


@pytest.mark.parametrize("key", CKPT_MODELS)
def test_load_params_gives_jax_logits(key, jax_files):
    jm, state, path = jax_files[key]
    x = _inputs(key, seed=5)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *[jnp.asarray(a) for a in x])
    tm = load_params(_port_model(key), path).eval()
    with torch.no_grad():
        got = tm(*[torch.as_tensor(a) for a in x])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _mixed_tree():
    rng = np.random.default_rng(3)
    return {
        "step": np.array(7, np.int32),
        "params": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                   "half": np.asarray(jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)),
                   "f16": rng.normal(size=(2, 2)).astype(np.float16),
                   "empty": np.zeros((0, 3), np.float32)},
        "rng": np.asarray(jax.random.key_data(jax.random.key(11))),
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-3), "b": np.bool_(True),
                    "bf16": np.asarray(jnp.asarray(0.75, jnp.bfloat16))[()]},
        "masks": np.array([True, False, True]),
        "ints": {"a": 5, "b": -7, "c": 200, "d": -200, "e": 70000, "f": -70000,
                 "g": 2 ** 40, "h": -2 ** 40, "i": 2 ** 63},
        "misc": {"f": 1.5, "s": "x" * 40, "none": None, "t": True, "bytes": b"\x00\x01",
                 "state": {}},
        "long": np.arange(70000, dtype=np.int64),
    }


def test_codec_matches_flax_on_every_type(tmp_path):
    tree = _mixed_tree()
    raw = fs.to_bytes(tree)
    write_flax_checkpoint(str(tmp_path / "m.ckpt"), tree)
    assert (tmp_path / "m.ckpt").read_bytes() == raw
    _same_leaves(read_flax_checkpoint(str(tmp_path / "m.ckpt")), fs.msgpack_restore(raw))
    # torch leaves encode as the numpy arrays with the same values
    as_torch = {"w": torch.from_numpy(tree["params"]["kernel"]),
                "h": torch.tensor([0.5, -2.0], dtype=torch.bfloat16)}
    write_flax_checkpoint(str(tmp_path / "t.ckpt"), as_torch)
    back = fs.msgpack_restore((tmp_path / "t.ckpt").read_bytes())
    assert np.array_equal(back["w"], tree["params"]["kernel"])
    assert back["h"].dtype.name == "bfloat16" and back["h"].astype(np.float32).tolist() == [
        0.5, -2.0]


@pytest.mark.parametrize("side", ["read", "write"])
def test_chunked_leaves(side, jax_files, tmp_path, monkeypatch):
    """flax splits leaves over MAX_CHUNK_SIZE bytes into chunks (a 1 GiB
    limit: patched to 256 bytes here, so the model's kernels are chunked)."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_ckpt, "MAX_CHUNK_SIZE", 256)
    jm, state, _ = jax_files["ViViT"]
    path = str(tmp_path / "chunked.ckpt")
    j_save_checkpoint(state, path)
    raw = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    if side == "read":
        tree = read_flax_checkpoint(path)
        _same_leaves(tree, fs.msgpack_restore(raw))
        x = _inputs("ViViT")
        want = jm.apply({"params": state.params}, jnp.asarray(x[0]), train=False)
        with torch.no_grad():
            got = load_params(_port_model("ViViT"), path).eval()(torch.as_tensor(x[0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    else:
        tree = _np({"step": state.step, "params": state.params, "rng": jax.random.key_data(
            state.rng), "long": jnp.arange(1000, dtype=jnp.int32)})
        write_flax_checkpoint(str(tmp_path / "w.ckpt"), tree)
        assert (tmp_path / "w.ckpt").read_bytes() == fs.to_bytes(tree)


def test_bf16_stored_checkpoint(jax_files, tmp_path):
    """A checkpoint whose parameters are bf16 (numpy names them only through
    ml_dtypes) decodes straight into torch.bfloat16 and loads as their f32
    values."""
    _, state, _ = jax_files["ViViT"]
    half = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), state.params)
    path = str(tmp_path / "bf16.ckpt")
    j_save_checkpoint(state.replace(params=half), path)
    tree = read_flax_checkpoint(path)
    _same_leaves(tree, fs.msgpack_restore(open(path, "rb").read()))
    assert {v.dtype for v in jax.tree_util.tree_leaves(tree["params"])} == {torch.bfloat16}
    tm = load_params(_port_model("ViViT"), path)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), _np(half)))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k]), k


def _init_tree(key):
    """(params, batch_stats) in the shapes of JAX's ``model.init``, seeded."""
    x_v, x_t = jnp.zeros((2, 5, 32, 32, 3)), jnp.zeros((2, 5, F))
    vk, tk = dict(FUSION_VIVIT), dict(FUSION_TS)
    fusion = {"concat": MultiModalConcat, "concat_GB": MultiModalGB, "TFN": TFN,
              "TFN_GB": TFNGB}
    if key in fusion:
        jm, args = fusion[key](vivit_kwargs=vk, ts_kwargs=tk), (x_v, x_t)
    elif key in ("Transformer", "CnnLSTM", "MLSTM_FCN"):
        cfg = {"Transformer": JC.TransformerConfig(n_features=F, feature_dims=32, n_layers=1,
                                                   n_heads=4, dim_feedforward=64,
                                                   cls_dims=16, max_len=T0D),
               "CnnLSTM": JC.CnnLSTMConfig(seq_len=T0D, n_features=F, conv_dim=16,
                                           lstm_dim=16, n_layers=2),
               "MLSTM_FCN": JC.MLSTMFCNConfig(**MLSTM)}[key]
        jm, args = j_build_0d_model(key, cfg), (jnp.zeros((2, T0D, F)),)
    elif key == "ViViT":
        jm, args = j_build_video_model("ViViT", JC.ViViTConfig(**VIVIT)), (x_v,)
    else:
        cfg = {"R2Plus1D": JC.R2Plus1DConfig(image_size=32, n_frames=8,
                                             layer_sizes=(1, 1, 1, 1)),
               "SlowFast": JC.SlowFastConfig(image_size=32, n_frames=8, layers=(1, 1, 1, 1)),
               "SlowFast_subbn2": JC.SlowFastConfig(**SLOWFAST)}[key]
        jm = j_build_video_model(key.split("_")[0], cfg)
        args = (jnp.zeros((2, 8, 32, 32, 3)),)
    key0 = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key0, "noise": key0, "dropout": key0},
                                            *args, train=False))
    rng = np.random.default_rng(len(key))
    fill = lambda s: rng.normal(size=s.shape).astype(np.float32)
    return (jax.tree_util.tree_map(fill, dict(shapes["params"])),
            jax.tree_util.tree_map(fill, dict(shapes.get("batch_stats", {}))))


@pytest.mark.parametrize("key", ["ViViT", "Transformer", "CnnLSTM", "MLSTM_FCN", "R2Plus1D",
                                 "SlowFast", "SlowFast_subbn2", "concat", "concat_GB", "TFN",
                                 "TFN_GB"])
def test_flax_from_state_dict_inverts_state_dict_from_flax(key):
    params, stats = _init_tree(key)
    got_params, got_stats = flax_from_state_dict(state_dict_from_flax(params, stats))
    for got, want in ((got_params, params), (got_stats, stats)):
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]     # sorted keys, as
        for (path, g), (_, w) in zip(flat_got, flat_want):              # device_get leaves them
            assert g.shape == w.shape and np.array_equal(g.numpy(), w), path


def _vivit_batches(seed=0, n=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4, 5, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 2, size=(n, 4)).astype(np.int64)
    return x, y


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_resume_from_jax_matches_jax_next_step(optimizer, tmp_path):
    """2 JAX steps, save, then the third step in JAX and, from the file, in
    the port. The rate halves every 2 updates, so the third step runs at the
    decayed rate only if ``count`` came across."""
    cfg = dict(ADAM, optimizer=optimizer)
    jm = j_build_video_model("ViViT", JC.ViViTConfig(**VIVIT))
    x, y = _vivit_batches()
    aux = (jnp.ones(2), jnp.asarray([0.3, 0.5]), jnp.zeros(3))
    jstate = j_create_train_state(jm, jnp.asarray(x[0]), jax.random.key(0),
                                  JC.OptimConfig(**cfg), steps_per_epoch=1)
    jstep = j_make_train_step(jm, JLossConfig())
    for i in range(2):
        jstate, _, _ = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]), *aux)
    path = str(tmp_path / "ViViT_last.ckpt")
    j_save_checkpoint(jstate, path)
    jnext, jloss, _ = jstep(jstate, jnp.asarray(x[2]), jnp.asarray(y[2]), *aux)

    state = create_train_state(_port_model("ViViT"), TC.OptimConfig(**cfg),
                               steps_per_epoch=1, seed=9)
    load_checkpoint(state, path)
    assert int(state.step) == 2 and int(state.opt_state["count"]) == 2 and state.draws == 2
    assert state.seed == 9
    # the state written back is the file (the key aside), and JAX resumes from it
    tree, written = read_flax_checkpoint(path), flax_checkpoint_tree(state)
    for name in ("step", "params", "batch_stats", "opt_state"):
        _same_leaves(written[name], _np(tree[name]) if name == "step" else
                     jax.tree_util.tree_map(lambda t: t.numpy(), tree[name]), name)
    _, tloss, _ = make_train_step(LossConfig())(
        state, torch.as_tensor(x[2]), torch.as_tensor(y[2]), torch.ones(2),
        torch.tensor([0.3, 0.5]))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-7)
    want = state_dict_from_flax(_np(jnext.params))
    got = state.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1.4e-6, err_msg=k)
    back = str(tmp_path / "port_last.ckpt")
    write_flax_checkpoint(back, flax_checkpoint_tree(state))
    jback = j_load_checkpoint(jnext, back)
    assert int(jback.step) == 3
    for k, v in state_dict_from_flax(_np(jback.params)).items():
        assert torch.equal(v, got[k]), k


def test_mismatched_tree_raises_before_loading(jax_files, tmp_path):
    path = jax_files["ViViT"][2]
    deeper = build_video_model("ViViT", TC.ViViTConfig(**dict(VIVIT, depth=2)))
    before = {k: v.clone() for k, v in deeper.state_dict().items()}
    with pytest.raises(ValueError, match="first missing key"):
        load_params(deeper, path)
    with pytest.raises(ValueError, match="first missing key"):
        load_params(_port_model("MLSTM_FCN"), path)
    wider = build_video_model("ViViT", TC.ViViTConfig(**dict(VIVIT, dim=48)))
    with pytest.raises(ValueError, match="has shape"):
        load_params(wider, path)
    tree = read_flax_checkpoint(path)
    tree["params"]["Dense_extra"] = {"kernel": torch.zeros(2, 2)}
    write_flax_checkpoint(str(tmp_path / "extra.ckpt"), tree)
    model = _port_model("ViViT")
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="first extra key 'Dense_extra.weight'"):
        load_params(model, str(tmp_path / "extra.ckpt"))
    state = create_train_state(deeper, TC.OptimConfig(**ADAM))
    with pytest.raises(ValueError, match="does not match the model"):
        load_checkpoint(state, path)
    for m, was in ((deeper, before), (model, kept)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, was[k]), k
    assert int(state.step) == 0 and int(state.opt_state["count"]) == 0


def test_torch_save_checkpoint_still_loads(tmp_path):
    state = create_train_state(_port_model("MLSTM_FCN"), TC.OptimConfig(**ADAM), seed=3)
    path = str(tmp_path / "m_last.ckpt")
    save_checkpoint(state, path)
    assert not is_flax_checkpoint(path)
    twin = load_checkpoint(create_train_state(_port_model("MLSTM_FCN", seed=2),
                                              TC.OptimConfig(**ADAM)), path)
    assert twin.seed == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(twin.model.state_dict()[k], v), k
    model = load_params(_port_model("MLSTM_FCN", seed=4), path)
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


SYN = ["--synthetic", "--synthetic_shots", "6", "--synthetic_normal", "2", "--verbose", "0",
       "--device", "cpu"]
VISION_ARGS = SYN + ["--kind", "vision", "--model", "ViViT", "--synthetic_frames", "96",
                     "--batch_size", "8", "--dim", "32", "--depth", "1", "--n_heads", "2",
                     "--d_head", "16", "--scale_dim", "2", "--image_size", "32",
                     "--seq_len", "5", "--alarms"]
VISION_TAG = "ViViT_clip_5_dist_3_Focal_Normal_seed_42"     # the JAX CLI's tag


def test_evaluate_model_reads_a_jax_weight_dir(tmp_path, capsys):
    """The report and alarm files from a JAX-written ``{tag}_best.ckpt``
    equal those from the same weights converted in memory and saved by the
    port."""
    jm = j_build_video_model("ViViT", JC.ViViTConfig(**VIVIT))
    jstate = j_create_train_state(jm, jnp.zeros((1, 5, 32, 32, 3)), jax.random.key(4),
                                  JC.OptimConfig())
    j_save_checkpoint(jstate, str(tmp_path / "jax" / f"{VISION_TAG}_best.ckpt"))
    tm = build_video_model("ViViT", TC.ViViTConfig(**VIVIT))
    tm.load_state_dict(state_dict_from_flax(_np(jstate.params)), strict=True)
    save_checkpoint(create_train_state(tm, TC.OptimConfig()),
                    str(tmp_path / "port" / f"{VISION_TAG}_best.ckpt"))
    outs = {}
    for side in ("jax", "port"):
        evaluate_model.main(VISION_ARGS + ["--weight_dir", str(tmp_path / side),
                                           "--save_dir", str(tmp_path / f"{side}_r")])
        outs[side] = capsys.readouterr().out
    line = lambda out: re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC [0-9.]+", out).group(0)
    assert line(outs["jax"]) == line(outs["port"])
    for name in ("_eval_report.txt", "_alarms.json", "_alarms.csv",
                 "_threshold_tradeoff.csv"):
        assert ((tmp_path / "jax_r" / f"{VISION_TAG}{name}").read_bytes()
                == (tmp_path / "port_r" / f"{VISION_TAG}{name}").read_bytes()), name


def test_train_0d_resumes_from_a_jax_last_checkpoint(tmp_path, capsys):
    argv = SYN + ["--model", "MLSTM_FCN", "--batch_size", "16", "--fcn_dim", "8",
                  "--lstm_dim", "8", "--num_epoch", "1", "--skip_extras", "--resume",
                  "--weight_dir", str(tmp_path / "w"), "--save_dir", str(tmp_path / "r")]
    cfg = JC.MLSTMFCNConfig(n_features=F, fcn_dim=8, seq_len=T0D, lstm_dim=8)
    jstate = _jax_state(j_build_0d_model("MLSTM_FCN", cfg), [jnp.zeros((1, T0D, F))], {}, 0)
    jstate = jstate.replace(step=jnp.asarray(5, jnp.int32))
    last = tmp_path / "w" / "MLSTM_FCN_clip_21_dist_3_Focal_Normal_seed_42_last.ckpt"
    j_save_checkpoint(jstate, str(last))
    train_0d.main(argv)
    out = capsys.readouterr().out
    assert f"resumed from {last} at step 5" in out
    assert re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC [0-9.]+", out)
