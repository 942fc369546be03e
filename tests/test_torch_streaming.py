"""kstar_torch streaming predictor against kstar_tpu's on the same frame
sequences (f32, CPU): toy models, a small ViViT with bridged weights, the
0D modality, dwell, crop, reset, and the block-size chooser."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kstar_torch.infer import streaming as ts
from kstar_torch.models.vivit import ViViT as TorchViViT
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.infer import streaming as js
from kstar_tpu.models.vivit import ViViT as JaxViViT


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class JaxToy(nn.Module):
    """Mean-brightness model of tests/test_streaming.py."""

    @nn.compact
    def __call__(self, x, train=False):
        m = x.astype(jnp.float32).mean(axis=(1, 2, 3, 4)) / 100.0
        return jnp.stack([m, -m], axis=-1)


class TorchToy(torch.nn.Module):
    def forward(self, x):
        m = x.float().mean(dim=(1, 2, 3, 4)) / 100.0
        return torch.stack([m, -m], dim=-1)


class JaxToy0D(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        m = x.mean(axis=(1, 2))
        return jnp.stack([m, -m], axis=-1)


class TorchToy0D(torch.nn.Module):
    def forward(self, x):
        m = x.mean(dim=(1, 2))
        return torch.stack([m, -m], dim=-1)


TOY_KW = dict(seq_len=4, crop_size=8, threshold=0.5, fps=10.0, suppress_s=0.5)
VIVIT_KW = dict(image_size=32, patch_size=8, n_frames=4, dim=32, depth=1, n_heads=2,
                d_head=16, scale_dim=2)


def _toy_frames(n=24, size=8, seed=0):
    frames = np.random.default_rng(seed).integers(0, 255, size=(n, size, size, 3),
                                                  dtype=np.uint8)
    frames[n // 2:] = 255      # bright tail: crosses the threshold after suppression
    return frames


def _pair(jax_model, torch_model, params=None, **kw):
    """The two packages' predictors over the same model, f32 on the CPU."""
    jp = js.StreamingPredictor(jax_model, params or {}, {}, compute_dtype=jnp.float32, **kw)
    tp = ts.StreamingPredictor(torch_model, compute_dtype=torch.float32, device="cpu", **kw)
    return jp, tp


@pytest.fixture(scope="module")
def vivit_pair():
    jm = JaxViViT(dtype=jnp.float32, **VIVIT_KW)
    key = jax.random.key(0)
    variables = jm.init({"params": key, "dropout": key},
                        jnp.zeros((1, 4, 32, 32, 3)), train=False)
    tm = TorchViViT(**VIVIT_KW)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jm, variables["params"], tm


def _run(pred, frames, block):
    """Push all frames, ``block`` at a time (1 = single ``push`` calls)."""
    probs, alarms = [], []
    for i in range(0, len(frames), block):
        if block == 1:
            p, a = pred.push(frames[i])
            probs.append([p])
            alarms.append([a])
        else:
            p, a = pred.push_block(frames[i:i + block])
            probs.append(p)
            alarms.append(a)
    return np.concatenate(probs), np.concatenate(alarms)


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("dwell", [0.0, 0.25])
def test_toy_video_matches_jax(block, dwell):
    frames = _toy_frames()
    jp, tp = _pair(JaxToy(), TorchToy(), block_size=block, min_dwell_s=dwell, **TOY_KW)
    assert tp.dwell_n == jp.dwell_n and tp.suppress_n == jp.suppress_n
    want_p, want_a = _run(jp, frames, block)
    got_p, got_a = _run(tp, frames, block)
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_a, want_a)
    assert want_a.any() and tp.alarm_time == jp.alarm_time is not None
    assert tp.n_frames_seen == jp.n_frames_seen == len(frames)


@pytest.mark.parametrize("block", [1, 6])
def test_vivit_matches_jax(vivit_pair, block):
    jm, params, tm = vivit_pair
    frames = np.random.default_rng(1).integers(0, 255, size=(12, 40, 40, 3), dtype=np.uint8)
    kw = dict(seq_len=4, crop_size=32, fps=10.0, suppress_s=0.2, block_size=block)
    # the random model sits near p = 0.5: put the threshold at the JAX curve's
    # median so that alarms do fire and the comparison means something
    probe, _ = _pair(jm, tm, params, **kw)
    thr = float(np.median(_run(probe, frames, block)[0]))
    jp, tp = _pair(jm, tm, params, threshold=thr, **kw)
    want_p, want_a = _run(jp, frames, block)
    got_p, got_a = _run(tp, frames, block)
    np.testing.assert_allclose(got_p, want_p, atol=1e-5, rtol=0)
    assert np.abs(want_p - thr).min() > 1e-4      # no alarm decided inside the tolerance
    np.testing.assert_array_equal(got_a, want_a)
    assert want_a.any() and tp.alarm_time == jp.alarm_time


@pytest.mark.parametrize("modality", ["video", "0D"])
def test_block_equals_single_pushes(vivit_pair, modality):
    if modality == "video":
        model, kw = vivit_pair[2], dict(seq_len=4, crop_size=32, fps=10.0, suppress_s=0.2)
        frames = np.random.default_rng(2).integers(0, 255, size=(12, 32, 32, 3),
                                                   dtype=np.uint8)
    else:
        model = TorchToy0D()
        kw = dict(seq_len=4, modality="0D", n_features=3, fps=10.0, suppress_s=0.0)
        frames = np.random.default_rng(1).random((12, 3)).astype(np.float32)
    mk = lambda: ts.StreamingPredictor(model, compute_dtype=torch.float32,
                                       device="cpu", **kw)
    seq, blk, mixed = mk(), mk(), mk()
    want_p, want_a = _run(seq, frames, 1)
    got_p, got_a = _run(blk, frames, 4)
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_a, want_a)
    assert blk.alarm_time == seq.alarm_time
    # block sizes may change between steps: the ring buffer carries over
    mix_p = np.concatenate([_run(mixed, frames[:3], 1)[0], mixed.push_block(frames[3:8])[0],
                            mixed.push_block(frames[8:])[0]])
    np.testing.assert_allclose(mix_p, want_p, atol=1e-6, rtol=0)


def test_0d_matches_jax():
    samples = np.random.default_rng(1).random((12, 3)).astype(np.float32)
    jp, tp = _pair(JaxToy0D(), TorchToy0D(), seq_len=4, modality="0D", n_features=3,
                   fps=10.0, suppress_s=0.0, threshold=0.6)
    want_p, want_a = _run(jp, samples, 4)
    got_p, got_a = _run(tp, samples, 4)
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_a, want_a)
    assert tp.alarm_time == jp.alarm_time


@pytest.mark.parametrize("shape", [(16, 16), (8, 20), (12, 8)], ids=str)
def test_crop_on_push_matches_jax(shape):
    """Both axes are cropped, also when only one exceeds the crop size."""
    frames = np.random.default_rng(3).integers(0, 255, size=(8, *shape, 3), dtype=np.uint8)
    jp, tp = _pair(JaxToy(), TorchToy(), **TOY_KW)
    np.testing.assert_allclose(_run(tp, frames, 4)[0], _run(jp, frames, 4)[0],
                               atol=1e-6, rtol=0)
    p, _ = tp.push(frames[0])
    assert np.isfinite(p)


@pytest.mark.parametrize("shape", [(4, 8), (8, 4), (4, 4)], ids=str)
def test_too_small_frames_raise(shape):
    _, tp = _pair(JaxToy(), TorchToy(), **TOY_KW)
    with pytest.raises(ValueError, match="smaller than crop_size"):
        tp.push_block(np.zeros((2, *shape, 3), np.uint8))


def test_reset_restores_the_initial_state():
    frames = _toy_frames()
    _, tp = _pair(JaxToy(), TorchToy(), **TOY_KW)
    first = _run(tp, frames, 8)
    assert tp.alarm_time is not None
    tp.reset()
    assert tp.n_frames_seen == 0 and tp.alarm_time is None and tp._run == 0
    assert not tp._buffer.any()
    again = _run(tp, frames, 8)
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(again[1], first[1])


def test_plain_gather_option_is_bit_identical(vivit_pair):
    frames = np.random.default_rng(4).integers(0, 255, size=(8, 32, 32, 3), dtype=np.uint8)
    kw = dict(seq_len=4, crop_size=32, compute_dtype=torch.float32, device="cpu")
    a = ts.StreamingPredictor(vivit_pair[2], **kw)
    b = ts.StreamingPredictor(vivit_pair[2], use_fused_gather=False, **kw)
    np.testing.assert_array_equal(_run(a, frames, 4)[0], _run(b, frames, 4)[0])


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ts.StreamingPredictor(TorchToy(), **TOY_KW)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ts.probe_stream_blocks(TorchToy(), 4, 8)(2)


PROBES = {
    # fixed 20 ms step whatever k: k/fps crosses it between k=4 and k=8
    "fixed-20ms": (lambda k: [0.020] * 10, {}),
    "none-sustains": (lambda k: [10.0], dict(candidates=(1, 4, 16))),
    # median fast, p99 slow: k=1 fails on the tail
    "tail-gates": (lambda k: [0.001] * 29 + [0.030], dict(candidates=(1, 8))),
    "median-gates": (lambda k: [0.001] * 29 + [0.030], dict(candidates=(1, 8), q=0.5)),
    "half-budget": (lambda k: [0.004 * k ** 0.5] * 5, dict(budget_frac=0.5, fps=100.0)),
}


@pytest.mark.parametrize("probe,kw", PROBES.values(), ids=PROBES.keys())
def test_choose_block_size_matches_jax(probe, kw):
    probed = []

    def recording(k):
        probed.append(k)
        return probe(k)

    want = js.choose_block_size(recording, **kw)
    want_probed, probed[:] = list(probed), []
    got = ts.choose_block_size(recording, **kw)
    assert got == want and probed == want_probed


def test_probe_stream_blocks_times_a_real_predictor():
    probe = ts.probe_stream_blocks(TorchToy0D(), seq_len=4, crop_size=8, n_probe=3,
                                   device="cpu", modality="0D", n_features=3)
    times = probe(2)
    assert len(times) == 3 and all(t > 0 for t in times)
    k, report = ts.choose_block_size(
        ts.probe_stream_blocks(TorchToy(), seq_len=4, crop_size=8,
                               compute_dtype=torch.float32, n_probe=3, device="cpu"),
        fps=1.0, candidates=(1, 2))
    assert k == 1 and report[1]["sustains"]
