"""kstar_torch's conv video models against kstar_tpu's on the CPU at f32.

R(2+1)D (32 px, 8 frames, layer_sizes (1, 1, 1, 1)), SlowFast (32 px, 8
frames, layers (1, 1, 1, 1), alpha 4) and SlowFast with SubBatchNorm in its
block BatchNorms (base_bn_splits 2). The JAX variables are seeded numpy
values in the shapes of the JAX model's own ``init`` (every statistic off
its zeros/ones start, so evaluation exercises it), carried to the port with
``kstar_torch.weights.state_dict_from_flax``; the same seeded clips (pixel
values minus the channel mean, as the sweeps feed them) go through both.

Tolerances: eval logits and ``encode`` at atol 1e-5 + rtol 1e-5. A
train-mode forward normalises with the statistics of a batch of 8 clips,
and the deepest stages see 8 x 1 x 2 x 2 values per channel: the two
packages' conv sums, in another order, differ by f32 rounding, and the
batch normalisation over so few values lifts that above 1e-5 in the
logits, so those are held at atol 1e-4; the updated running statistics at
rtol 1e-5 + atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kstar_torch.config import R2Plus1DConfig as TR2Plus1DConfig
from kstar_torch.config import SlowFastConfig as TSlowFastConfig
from kstar_torch.models import build_video_model
from kstar_torch.models.r2plus1d import _middle_channels
from kstar_torch.models.resnet3d import _round_width
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import R2Plus1DConfig, SlowFastConfig
from kstar_tpu.models import build_video_model as j_build_video_model
from kstar_tpu.models.r2plus1d import _middle_channels as j_middle_channels
from kstar_tpu.models.resnet3d import _round_width as j_round_width

B, T, CROP = 8, 8, 32
SMALL = {
    "R2Plus1D": ("R2Plus1D", R2Plus1DConfig(image_size=CROP, n_frames=T,
                                            layer_sizes=(1, 1, 1, 1))),
    "SlowFast": ("SlowFast", SlowFastConfig(image_size=CROP, n_frames=T, layers=(1, 1, 1, 1))),
    "SlowFast_subbn2": ("SlowFast", SlowFastConfig(image_size=CROP, n_frames=T,
                                                   layers=(1, 1, 1, 1), base_bn_splits=2)),
}
TORCH_CFG = {"R2Plus1D": TR2Plus1DConfig, "SlowFast": TSlowFastConfig}
EVAL_TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_TOL = dict(atol=1e-4, rtol=1e-5)
STATS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def clips(n=B, t=T, size=CROP, seed=0):
    """Pixel-like clips: uint8 values minus 128, f32, channels-last."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, t, size, size, 3)) - 128.0).astype(np.float32)


def jax_variables(model, x, seed=0, pixel_scale=64.0):
    """Seeded numpy variables in the shapes of ``model.init``: lecun-scaled
    kernels, scales in [0.5, 1.5], biases and means N(0, 0.3), variances in
    [0.5, 2] (a SubBatchNorm's split statistics too). The kernels that read
    the 3 pixel channels are scaled by a further 1/``pixel_scale``, as a
    trained stem takes pixel values of +-128 to O(1), so that the
    activations of every stage stay O(1) under running statistics near 1.
    Training normalises with batch statistics, which makes the loss
    invariant to the stem's scale and its gradient proportional to
    1/scale: the train tests keep the initialisation's scale
    (``pixel_scale=1``)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.asarray(x),
                                               train=False))
    rng = np.random.default_rng(seed + 7)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            v /= pixel_scale if s.shape[-2] == 3 else 1.0
        elif leaf in ("scale", "var", "split_var"):
            v = rng.uniform(0.5, 2.0 if "var" in leaf else 1.5, s.shape)
        else:
            v = rng.normal(0.0, 0.3, s.shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, {k: dict(v) for k, v in shapes.items()})
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def torch_twin(name, cfg, variables, dtype=torch.float32):
    tm = build_video_model(name, TORCH_CFG[name](**dataclasses.asdict(cfg)), dtype=dtype)
    tm.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]),
                       strict=True)
    return tm


def conv_pair(key, x, seed=0, pixel_scale=64.0):
    """(JAX model, its variables, the port's f32 twin) of ``SMALL[key]``."""
    name, cfg = SMALL[key]
    jm = j_build_video_model(name, cfg)
    v = jax_variables(jm, x, seed, pixel_scale)
    return jm, v, torch_twin(name, cfg, v)


@pytest.fixture(scope="module")
def pairs():
    x = clips()
    return x, {key: conv_pair(key, x) for key in SMALL}


@pytest.mark.parametrize("key", list(SMALL))
def test_eval_logits_and_encode_match_jax(key, pairs):
    x, models = pairs
    jm, v, tm = models[key]
    fwd = jax.jit(lambda v, x: (jm.apply(v, x, train=False), jm.apply(v, x, method="encode")))
    want, want_h = map(np.asarray, fwd(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
        got_h = tm.encode(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, 2)
    assert got_h.shape == want_h.shape == (B, 128 if key == "R2Plus1D" else 640)
    np.testing.assert_allclose(got, want, **EVAL_TOL)
    np.testing.assert_allclose(got_h, want_h, **EVAL_TOL)


@pytest.mark.parametrize("key", list(SMALL))
def test_train_forward_and_batch_stats_match_jax(key, pairs):
    """One train-mode forward: the batch statistics normalise the batch and
    every running buffer moves by its rule (flax's BatchNorm at momentum
    0.99; SubBatchNorm's per-split statistics at torch's 0.1 with the
    unbiased variance); the aggregated SubBatchNorm statistics stay put."""
    x, models = pairs
    jm, v, _ = models[key]
    tm = torch_twin(SMALL[key][0], SMALL[key][1], v)        # fresh buffers
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    want, mut = fwd(v, jnp.asarray(x))
    got = tm(torch.as_tensor(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TRAIN_TOL)
    new = state_dict_from_flax({}, jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
    old = state_dict_from_flax({}, v["batch_stats"])
    sd = tm.state_dict()
    assert set(new) <= set(sd)
    for k, w in new.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), err_msg=k, **STATS_TOL)
    moved = {k for k in new if not torch.equal(new[k], old[k])}
    aggregated = {k for k in new if k.endswith(("running_mean", "running_var"))
                  and k.rsplit(".", 1)[0] + ".split_mean" in new}
    assert ("subbn" in key) == bool(aggregated)
    assert moved == set(new) - aggregated


@pytest.mark.parametrize("key", list(SMALL))
def test_bf16_forward_is_finite_and_tracks_jax_bf16(key, pairs):
    """The bf16 twin (f32 parameters, bf16 convs) gives finite f32 logits,
    and its encoder output parts from the f32 one by no more than twice
    what JAX's own bf16 model parts from JAX's f32 on the same weights
    (both ~5e-3 of the largest feature here): bf16 rounds in the same
    places in both packages."""
    x, models = pairs
    jm, v, tm = models[key]
    name, cfg = SMALL[key]
    jbf = j_build_video_model(name, cfg, dtype=jnp.bfloat16)
    enc = lambda m: jax.jit(lambda v, x: m.apply(v, x, method="encode"))
    h32 = np.asarray(enc(jm)(v, jnp.asarray(x)))
    jax_gap = np.abs(np.asarray(enc(jbf)(v, jnp.asarray(x)), np.float32) - h32).max()
    bf = torch_twin(name, cfg, v, dtype=torch.bfloat16)
    with torch.no_grad():
        logits = bf(torch.as_tensor(x))
        gap = np.abs(bf.encode(torch.as_tensor(x)).float().numpy() - h32).max()
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert 0 < gap <= 2 * jax_gap, (gap, jax_gap)


def test_full_width_parameter_counts_match_jax():
    """The configs' full widths: the same parameter and statistic count as
    the JAX models (1,587,523 and 2,451,846 parameters)."""
    x = jnp.zeros((2, 21, 128, 128, 3))
    for name, cfg, n_params in (("R2Plus1D", R2Plus1DConfig(), 1_587_523),
                                ("SlowFast", SlowFastConfig(), 2_451_846),
                                ("SlowFast", SlowFastConfig(base_bn_splits=2), 2_451_846)):
        jm = j_build_video_model(name, cfg)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x[:, :cfg.n_frames],
                                                train=False))
        count = lambda tree: sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(tree))
        tm = build_video_model(name, TORCH_CFG[name](**dataclasses.asdict(cfg)))
        assert sum(p.numel() for p in tm.parameters()) == count(shapes["params"]) == n_params
        assert (sum(b.numel() for b in tm.buffers()) == count(shapes["batch_stats"]))


@pytest.mark.parametrize("kt,ks,cin,cout", [(3, 7, 3, 32), (3, 3, 32, 32), (3, 3, 32, 64),
                                            (1, 1, 64, 128), (3, 3, 64, 128)])
def test_middle_channels_and_round_width_match_jax(kt, ks, cin, cout):
    assert _middle_channels(kt, ks, cin, cout) == j_middle_channels(kt, ks, cin, cout)
    assert _round_width(cout) == j_round_width(cout)
    assert _round_width(cin, 0.0) == j_round_width(cin, 0.0)


def test_seeded_initialisation_is_flax_default():
    """Same generator seed, same weights; conv kernels lecun-normal over
    kt*kh*kw*in, zero biases, unit BatchNorm scales."""
    cfg = TR2Plus1DConfig(image_size=CROP, n_frames=T, layer_sizes=(1, 1, 1, 1))
    a = build_video_model("R2Plus1D", cfg, generator=torch.Generator().manual_seed(3))
    b = build_video_model("R2Plus1D", cfg, generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.backbone.conv2.block_0.conv1.spatial.Conv_0.weight.detach()   # (72, 32, 1, 3, 3)
    fan_in = 32 * 9
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.all(a.backbone.conv1.spatial.BatchNorm_0.weight == 1)
    sf = build_video_model("SlowFast", TSlowFastConfig(layers=(1, 1, 1, 1)),
                           generator=torch.Generator().manual_seed(0))
    assert torch.count_nonzero(sf.encoder.slow.stem.conv.bias) == 0
    assert sf.encoder.slow.stem.conv.bias is not None
    assert sf.encoder.slow.stage1.block_0.conv1.bias is None
