"""The port's reload, predict and report CLIs on the CPU at tiny widths
(``--device cpu``):

* ``evaluate_model`` reproduces the trainer's "test macro-F1 | ROC-AUC"
  line from the reloaded checkpoint (as ``tests/test_readme_quickstart.py``
  holds kstar_tpu's) for ``--kind 0D``, ``--kind vision --model ViViT``,
  ``--kind vision --model SlowFast --bn_splits 2`` and ``--kind
  multimodal``, with ``--synthetic_normal 2`` so the reload must strip the
  normal shots before splitting as the trainer does; with ``--alarms`` it
  writes the trainer's alarm files (same weights, same shots); the 0D detail
  CSV holds one row per train, valid and test sample;
* ``evaluate_detail`` rows equal kstar_tpu's on shared weights;
* ``make_continuous_prediction`` writes its probability PNGs and GIFs;
* ``compute_time`` writes kstar_tpu's keys; ``model_summary`` prints its
  tree.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from kstar_torch.cli import (compute_time, evaluate_model, make_continuous_prediction,
                             model_summary, train_0d, train_multimodal, train_vision)

SYN = ["--synthetic", "--synthetic_shots", "6", "--synthetic_normal", "2", "--verbose", "0"]
VISION = SYN + ["--synthetic_frames", "96", "--batch_size", "8", "--dim", "32", "--depth",
                "1", "--n_heads", "2", "--d_head", "16", "--scale_dim", "2",
                "--image_size", "32", "--seq_len", "5"]
ZERO_D = SYN + ["--batch_size", "16", "--fcn_dim", "8", "--lstm_dim", "8",
                "--lstm_layers", "1", "--model", "MLSTM_FCN"]
MULTI = SYN + ["--batch_size", "16", "--seq_len", "5", "--image_size", "32",
               "--patch_size", "8", "--dim", "32", "--depth", "1", "--n_heads", "2",
               "--d_head", "16", "--scale_dim", "2", "--feature_dims", "32",
               "--ts_layers", "1", "--ts_heads", "4", "--dim_feedforward", "64",
               "--model_type", "concat"]
ALARM_FILES = ("_alarms.json", "_alarms.csv", "_threshold_tradeoff.csv",
               "_dwell_tradeoff.csv", "_operating_grid.csv")
CASES = {
    # kind: (trainer, its flags, evaluate_model's flags, checkpoint tag, alarms)
    "0D": (train_0d, ZERO_D, ["--kind", "0D"] + ZERO_D,
           "MLSTM_FCN_clip_21_dist_3_Focal_Normal_seed_42", False),
    "ViViT": (train_vision, VISION + ["--model", "ViViT"],
              ["--kind", "vision", "--model", "ViViT"] + VISION,
              "ViViT_clip_5_dist_3_Focal_Normal_seed_42", True),
    "SlowFast_bn_splits_2": (train_vision, VISION + ["--model", "SlowFast", "--bn_splits", "2"],
                             ["--kind", "vision", "--model", "SlowFast", "--bn_splits", "2"]
                             + VISION, "SlowFast_clip_5_dist_3_Focal_Normal_seed_42", False),
    "multimodal": (train_multimodal, MULTI, ["--kind", "multimodal"] + MULTI,
                   "concat_clip_5_dist_3_Focal_Normal_seed_42", True),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _test_line(out):
    return re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC [0-9.]+", out).group(0)


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_model_reproduces_the_trainer(case, tmp_path, capsys):
    trainer, train_args, eval_args, tag, alarms = CASES[case]
    dirs = ["--weight_dir", str(tmp_path / "w"), "--device", "cpu"]
    trainer.main(train_args + dirs + ["--save_dir", str(tmp_path / "r"), "--num_epoch", "1"]
                 + ([] if alarms else ["--skip_extras"]))
    trained = capsys.readouterr().out
    want = _test_line(trained)
    evaluate_model.main(eval_args + dirs + ["--save_dir", str(tmp_path / "e")]
                        + (["--alarms"] if alarms else []))
    out = capsys.readouterr().out
    assert _test_line(out) == want
    assert "macro F1" in (tmp_path / "e" / f"{tag}_eval_report.txt").read_text()
    for name in ALARM_FILES if alarms else ():
        assert (tmp_path / "e" / f"{tag}{name}").read_bytes() == \
            (tmp_path / "r" / f"{tag}{name}").read_bytes(), name
    if case == "0D":
        sizes = re.search(r"datasets: train (\d+) valid (\d+) test (\d+)", trained)
        detail = pd.read_csv(tmp_path / "e" / f"{tag}_detail.csv")
        assert detail.task.value_counts().to_dict() == {
            "train": int(sizes.group(1)), "valid": int(sizes.group(2)),
            "test": int(sizes.group(3))}
        assert (tmp_path / "e" / f"{tag}_eval.png").stat().st_size > 0


def test_evaluate_model_needs_the_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        evaluate_model.main(["--kind", "0D", "--device", "cpu", "--weight_dir",
                             str(tmp_path)] + ZERO_D)


def test_evaluate_detail_matches_jax(tiny_dataset, tmp_path):
    from test_torch_models_0d import SMALL, torch_twin
    from test_torch_viz import jit_variables
    from kstar_torch.config import LossConfig, Schema
    from kstar_torch.data import TSDataset, prepare_0d_dataset
    from kstar_torch.eval import evaluate, evaluate_detail
    from kstar_tpu.config import LossConfig as JLossConfig
    from kstar_tpu.data import TSDataset as JTSDataset
    from kstar_tpu.data import prepare_0d_dataset as j_prepare
    from kstar_tpu.eval import evaluate_detail as j_evaluate_detail
    from kstar_tpu.models import build_0d_model as j_build
    from kstar_tpu.train import TrainState

    _, disrupt_df, ts_df = tiny_dataset
    cols = Schema.INPUT_FEATURES
    dfs, jdfs = (prepare_0d_dataset(ts_df, cols, test_shot=None),
                 j_prepare(ts_df, cols, test_shot=None))
    names = ("train", "valid", "test")
    ds = {n: TSDataset(df, disrupt_df, cols, scaler=dfs[3]) for n, df in zip(names, dfs[:3])}
    jds = {n: JTSDataset(df, disrupt_df, cols, scaler=jdfs[3])
           for n, df in zip(names, jdfs[:3])}
    jm = j_build("Transformer", SMALL["Transformer"])
    v = jit_variables(jm, jds["test"].batch(np.arange(4))[0])
    tm = torch_twin("Transformer", SMALL["Transformer"], v).eval()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=None,
                       rng=jax.random.key(0), tx=None)
    # a threshold halfway between two middle probabilities, so both classes
    # are predicted and no sample sits on it
    p = np.unique(np.concatenate([evaluate(tm, d, LossConfig())["p_disrupt"]
                                  for d in ds.values()]))
    thr = float(p[len(p) // 2 - 1] + p[len(p) // 2]) / 2
    want = j_evaluate_detail(jm, state, jds, JLossConfig(), batch_size=64, threshold=thr)
    got = evaluate_detail(tm, ds, LossConfig(), batch_size=64, threshold=thr,
                          save_csv=str(tmp_path / "detail.csv"))
    assert len(got) == sum(len(d) for d in ds.values())
    assert set(got.tag) >= {"correct"} and len(set(got.pred)) == 2
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "detail.csv"), want)


def test_make_continuous_prediction_writes_its_figures_and_gifs(tmp_path, capsys):
    res = make_continuous_prediction.main(
        ["--synthetic", "--device", "cpu", "--synthetic_shots", "2", "--synthetic_frames",
         "96", "--batch_size", "8", "--dim", "32", "--depth", "1", "--n_heads", "2",
         "--d_head", "16", "--scale_dim", "2", "--image_size", "32", "--patch_size", "8",
         "--seq_len", "5", "--feature_dims", "16", "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    shot = res["shot"]
    assert re.search(rf"shot {shot} \| video alarm at .* \| warning margin", out)
    assert f"wrote {tmp_path}/real_time_disruption_prediction_{shot}.gif" in out
    t_vid, p_vid = res["video"]
    assert len(t_vid) == len(p_vid) and np.isfinite(p_vid).all() and res["0D"] is not None
    for name in (f"prob_video_{shot}.png", f"prob_0D_{shot}.png",
                 f"real_time_disruption_prediction_{shot}.gif",
                 f"real_time_disruption_prediction_0D_{shot}.gif"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_compute_time_writes_jax_keys(tmp_path, capsys):
    from kstar_tpu.infer.latency import measure_forward as j_measure_forward

    res = compute_time.main(["--models", "ViViT", "Transformer", "--batch_sizes", "1",
                             "--n_samples", "2", "--image_size", "32", "--device", "cpu",
                             "--out", str(tmp_path / "t.json")])
    # kstar_tpu's keys: f"{model}_b{B}" over measure_forward's stats + clips_per_s
    j_stats = j_measure_forward(jax.jit(lambda x: x + 1), (jnp.zeros(2),), n_samples=2)
    saved = json.loads((tmp_path / "t.json").read_text())
    assert set(saved) == set(res) == {"ViViT_b1", "Transformer_b1"}
    for stats in saved.values():
        assert set(stats) == set(j_stats) | {"clips_per_s"}
        assert stats["p50_s"] > 0 and np.isfinite(stats["clips_per_s"])
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_model_summary_prints_its_tree(capsys, tmp_path):
    text = model_summary.main(["--model", "MLSTM_FCN", "--device", "cpu", "--out",
                               str(tmp_path / "s.txt")])
    out = capsys.readouterr().out
    assert out.startswith("MLSTMFCN Summary") and "Total Parameters: " in out
    assert (tmp_path / "s.txt").read_text() == text
