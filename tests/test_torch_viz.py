"""kstar_torch.viz's figures and latents against kstar_tpu.viz on the CPU:
the real-time GIF's frame schedule and camera rate, every plot function
writing its file (matplotlib here), the 2x2 evaluation figure, the
feature-importance bars, ``collect_latents`` for a 0D and a fusion model on
shared weights and ``project`` on the same latents (atol 1e-5: the same f32
arithmetic in another summation order), and the CLIs' figure helper when
matplotlib cannot be imported."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from kstar_torch import viz
from kstar_torch.viz import prob_curve
from kstar_tpu import viz as jviz
from kstar_tpu.viz import prob_curve as jprob_curve

TOL = dict(atol=1e-5, rtol=0)


def jit_variables(jm, *args, seed=0):
    """``jm.init`` under ``jax.jit`` (eager flax init costs ~10 s here), with
    the BatchNorm running statistics moved off their zeros/ones start as
    ``tests/test_torch_models_0d.py`` moves them."""
    rngs = {"params": jax.random.key(seed), "noise": jax.random.key(1),
            "dropout": jax.random.key(2)}
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: jm.init(rngs, *a, train=False))(*map(jnp.asarray, args)))
    rng = np.random.default_rng(seed + 7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.3, a.shape)).astype(np.float32),
        v.get("batch_stats", {}))
    return {"params": v["params"], "batch_stats": stats}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("n_probs,frame_srt,frame_end", [
    (0, 0, 10), (50, 0, 30), (400, 0, 300), (400, 20, 300), (1000, 0, 400),
    (3000, 100, 2500), (700, 0, 1200)])
def test_realtime_frame_indices_match_jax(n_probs, frame_srt, frame_end):
    for fps in (210, 200):
        assert (prob_curve.realtime_frame_indices(n_probs, frame_srt, frame_end, fps)
                == jprob_curve.realtime_frame_indices(n_probs, frame_srt, frame_end, fps))


def test_adaptive_camera_fps_matches_jax():
    for t in np.arange(0.0, 20.0, 0.25):
        assert prob_curve.adaptive_camera_fps(t) == jprob_curve.adaptive_camera_fps(t)


def _curve(n=600):
    time_x = np.arange(n) / 210.0
    probs = np.clip(np.linspace(0.0, 1.2, n) + 0.05 * np.sin(np.arange(n)), 0, 1)
    return time_x, probs.astype(np.float32)


def test_every_plot_function_writes_its_file(tmp_path):
    time_x, probs = _curve()
    ts = pd.DataFrame({"time": time_x, "\\q95": np.cos(time_x), "\\li": np.sin(time_x)})
    frames = np.random.default_rng(0).integers(0, 255, (len(time_x), 16, 16, 3), np.uint8)
    hist = types.SimpleNamespace(train_loss=[1.0, 0.5], valid_loss=[1.1, 0.6],
                                 train_f1=[0.4, 0.7], valid_f1=[0.3, 0.6])
    viz.plot_shot_probability(ts, time_x, probs, 30001, 0.5, 2.5, 2.6,
                              save_path=str(tmp_path / "prob.png"))
    viz.plot_shot_probability_zoom(time_x, probs, 30001, 0.5, 2.5, 2.6, 3 / 210.0,
                                   save_path=str(tmp_path / "prob.png"))
    viz.plot_learning_curve(hist, str(tmp_path / "lc.png"))
    viz.show_all_frames(frames, max_frames=8, save_path=str(tmp_path / "frames.png"))
    gif = viz.render_realtime_gif(frames, time_x, probs, 30001, 2.6,
                                  save_path=str(tmp_path / "rt.gif"), max_frames=12)
    assert gif == str(tmp_path / "rt.gif")
    for name in ("prob.png", "prob-zoom.png", "lc.png", "frames.png", "rt.gif"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_evaluation_figure_and_feature_importance(tmp_path):
    from kstar_torch.eval import evaluate_probs, evaluation_figure, plot_feature_importance

    rng = np.random.default_rng(0)
    p = rng.uniform(size=40)
    res = evaluate_probs(np.stack([p, 1 - p], 1), (p < 0.6).astype(int))
    fig = evaluation_figure(res)
    assert len(fig.axes) == 4
    assert {ax.get_subplotspec().get_geometry()[:2] for ax in fig.axes} == {(2, 2)}
    fig.savefig(tmp_path / "eval.png")
    plot_feature_importance({"\\q95": 0.3, "\\li": 0.1, "\\betap": 0.2},
                            str(tmp_path / "fi.png"))
    assert (tmp_path / "eval.png").stat().st_size > 0
    assert (tmp_path / "fi.png").stat().st_size > 0


@pytest.fixture(scope="module")
def ts_data(tiny_dataset):
    """The same 0D test split in both packages' TSDataset."""
    from kstar_torch.config import Schema
    from kstar_torch.data import TSDataset, prepare_0d_dataset
    from kstar_tpu.data import TSDataset as JTSDataset
    from kstar_tpu.data import prepare_0d_dataset as j_prepare

    _, disrupt_df, ts_df = tiny_dataset
    cols = Schema.INPUT_FEATURES
    *_, df_test, scaler = prepare_0d_dataset(ts_df, cols, test_shot=None)
    *_, j_df_test, j_scaler = j_prepare(ts_df, cols, test_shot=None)
    return (TSDataset(df_test, disrupt_df, cols, scaler=scaler),
            JTSDataset(j_df_test, disrupt_df, cols, scaler=j_scaler))


def test_collect_latents_0d_and_pca_match_jax(ts_data, tmp_path):
    from test_torch_models_0d import SMALL, torch_twin
    from kstar_tpu.models import build_0d_model as j_build

    ds, jds = ts_data
    jm = j_build("Transformer", SMALL["Transformer"])
    v = jit_variables(jm, jds.batch(np.arange(4))[0])
    tm = torch_twin("Transformer", SMALL["Transformer"], v).eval()
    state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    want, want_y, _ = jviz.collect_latents(jm, state, jds, batch_size=32)
    got, got_y, extras = viz.collect_latents(tm, ds, batch_size=32)
    assert extras is None and got.shape == want.shape and len(got) == len(ds)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(viz.project(got), jviz.project(got), **TOL)
    viz.visualize_latent_space(tm, ds, save_path=str(tmp_path / "latent.png"))
    assert (tmp_path / "latent.png").stat().st_size > 0


def test_collect_latents_multimodal_matches_jax(tiny_dataset):
    from test_torch_fusion import TS_KW, VIVIT_KW
    from kstar_torch.config import AugmentConfig, Schema
    from kstar_torch.data import DevicePreprocessor, MultiModalDataset, Scaler, VideoStore
    from kstar_torch.models import MultiModalConcat as TConcat
    from kstar_torch.weights import state_dict_from_flax
    from kstar_tpu.config import AugmentConfig as JAugmentConfig
    from kstar_tpu.data import MultiModalDataset as JMultiModalDataset
    from kstar_tpu.data import Scaler as JScaler
    from kstar_tpu.data import VideoStore as JVideoStore
    from kstar_tpu.data.device_pipe import DevicePreprocessor as JDevicePreprocessor
    from kstar_tpu.models import MultiModalConcat

    shots, disrupt_df, ts_df = tiny_dataset
    cols = Schema.INPUT_FEATURES
    arrays = {s.shot: s.frames for s in shots[:2]}
    keep = list(arrays)
    L, crop = VIVIT_KW["n_frames"], VIVIT_KW["image_size"]
    values = ts_df[ts_df.shot.isin(keep)][cols].values
    kw = dict(seq_len=L, dist=3, dt=4.0 / 210.0)
    ds = MultiModalDataset(VideoStore.from_arrays(arrays), ts_df, disrupt_df, cols, keep,
                           scaler=Scaler("Robust").fit(values), **kw)
    jds = JMultiModalDataset(JVideoStore.from_arrays(arrays), ts_df, disrupt_df, cols, keep,
                             scaler=JScaler("Robust").fit(values), **kw)

    jm = MultiModalConcat(vivit_kwargs=dict(VIVIT_KW), ts_kwargs=dict(TS_KW))
    b0, _ = jds.batch(np.arange(2))
    v = jit_variables(jm, np.zeros((2, L, crop, crop, 3), np.float32), b0["0D"])
    tm = TConcat(dict(VIVIT_KW), dict(TS_KW)).eval()
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]), strict=True)
    state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    want = jviz.collect_latents(jm, state, jds, 16, multimodal=True,
                                put=JDevicePreprocessor(crop, JAugmentConfig(), train=False,
                                                        out_dtype=jnp.float32))
    got = viz.collect_latents(tm, ds, 16, multimodal=True,
                              put=DevicePreprocessor(crop, AugmentConfig(), train=False,
                                                     out_dtype=torch.float32, device="cpu"))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    for k in ("video", "0D"):
        np.testing.assert_allclose(got[2][k], want[2][k], **TOL)


def test_cli_figure_helper_skips_without_matplotlib(monkeypatch, capsys, tmp_path):
    """With ``import matplotlib`` failing the helper prints one line naming
    the file and returns; the caller goes on (the figure function itself
    raises: it imports matplotlib inside)."""
    import sys

    from kstar_torch.cli.common import draw_figure

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = str(tmp_path / "lc.png")
    hist = types.SimpleNamespace(train_loss=[1.0], valid_loss=[1.0], train_f1=[0.5],
                                 valid_f1=[0.5])
    assert draw_figure(path, lambda: viz.plot_learning_curve(hist, path)) is None
    assert capsys.readouterr().out == (
        f"figure skipped: matplotlib is not installed ({path})\n")
    assert not (tmp_path / "lc.png").exists()
    with pytest.raises(ImportError):
        viz.plot_learning_curve(hist, path)
