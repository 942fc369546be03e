"""The port's train_0d CLI on the CPU at tiny widths: the same dataset sizes
and class counts as kstar_tpu's CLI builds from the same seed, the report,
checkpoints, feature importance and probability curve, an exact resume,
several --seeds training a seed ensemble that goes on with its best seed, and
--dp refused with the ROADMAP item that ports it."""

import os
import re

import numpy as np
import pytest
import torch

from _torch_parallel_worker import check_cli_run

from kstar_torch.cli import train_0d

TINY = ["--synthetic", "--synthetic_shots", "6", "--batch_size", "16", "--verbose", "1",
        "--fcn_dim", "8", "--lstm_dim", "8", "--lstm_layers", "1", "--conv_dim", "8",
        "--feature_dims", "16", "--n_layers", "1", "--n_heads", "2",
        "--dim_feedforward", "32", "--cls_dims", "8"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_dataset_line(argv):
    """The line kstar_tpu.cli.train_0d prints after building its datasets,
    built by its own functions from the same arguments."""
    from kstar_tpu.cli import train_0d as jt
    from kstar_tpu.cli.common import load_data
    from kstar_tpu.config import DT_0D, Schema
    from kstar_tpu.data import TSDataset, prepare_0d_dataset

    args = jt.build_parser().parse_args(argv)
    cols = Schema.INPUT_FEATURES
    disrupt_df, ts_df, _ = load_data(args, need_video=False, dt=DT_0D)
    dfs = prepare_0d_dataset(ts_df, cols, scaler=args.scaler, test_shot=None)
    tr, va, te = (TSDataset(df, disrupt_df, cols, seq_len=args.seq_len, dist=args.dist,
                            dt=DT_0D, scaler=dfs[3], include_normal=args.train_with_normal)
                  for df in dfs[:3])
    return (f"datasets: train {len(tr)} valid {len(va)} test {len(te)} "
            f"| class counts {tr.class_counts().tolist()}")


@pytest.mark.parametrize("model", ["MLSTM_FCN", "CnnLSTM", "Transformer"])
def test_cli_trains_reports_and_resumes(tmp_path, capsys, model):
    argv = TINY + ["--model", model, "--weight_dir", str(tmp_path / "w"),
                   "--save_dir", str(tmp_path / "r")]
    results = train_0d.main(argv + ["--device", "cpu", "--num_epoch", "1"])
    out = capsys.readouterr().out
    assert re.search(r"datasets: .*", out).group(0) == _jax_dataset_line(argv)
    assert re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC", out)
    assert 0.0 <= results["macro_f1"] <= 1.0
    assert re.search(r"feature importance \(top 5\): ", out)
    assert re.search(r"probability curve of shot \d+: \d+ samples", out)
    assert "figure skipped" not in out and "latent viz skipped" not in out
    tag = f"{model}_clip_21_dist_3_Focal_Normal_seed_42"
    for name in ("_learning_curve.png", "_eval.png", "_feature_importance.png",
                 "_latent_2d.png", "_prob_curve.png"):
        assert (tmp_path / "r" / f"{tag}{name}").stat().st_size > 0, name
    for name in ("_last.ckpt", "_best.ckpt"):
        assert (tmp_path / "w" / f"{tag}{name}").exists()
    assert "macro F1" in (tmp_path / "r" / f"{tag}_report.txt").read_text()
    saved = torch.load(tmp_path / "w" / f"{tag}_last.ckpt")
    assert int(saved["step"]) > 0
    # the checkpoint carries the BatchNorm statistics, moved by training
    stats = {k: v for k, v in saved["model"].items() if k.endswith("running_mean")}
    assert stats and any(float(v.abs().max()) > 0 for v in stats.values())

    train_0d.main(argv + ["--device", "cpu", "--num_epoch", "1", "--resume",
                          "--skip_extras"])
    out = capsys.readouterr().out
    assert f"at step {int(saved['step'])}" in re.search(r"resumed from .*", out).group(0)
    assert int(torch.load(tmp_path / "w" / f"{tag}_last.ckpt")["step"]) > int(saved["step"])


def test_seeds_train_an_ensemble_and_go_on_with_the_best(tmp_path, capsys, monkeypatch):
    """Several --seeds: one checkpoint pair per seed under JAX's
    ``{tag}_seed_{s}`` names, each seed's best valid F1 printed, and the
    evaluation and extras go on with the argmax seed's best checkpoint."""
    from kstar_torch import eval as eval_package

    scored = []
    real_evaluate = eval_package.evaluate

    def recording_evaluate(model, *a, **k):
        scored.append({n: v.clone() for n, v in model.state_dict().items()})
        return real_evaluate(model, *a, **k)

    monkeypatch.setattr(eval_package, "evaluate", recording_evaluate)
    train_0d.main(TINY + ["--model", "MLSTM_FCN", "--seeds", "40", "41", "--device", "cpu",
                          "--num_epoch", "2", "--weight_dir", str(tmp_path / "w"),
                          "--save_dir", str(tmp_path / "r")])
    out = capsys.readouterr().out
    f1s = [float(f) for f in re.findall(r"seed \d+: best valid f1 ([0-9.]+)", out)]
    assert re.findall(r"seed (\d+): best valid f1", out) == ["40", "41"]
    best = int(re.search(r"continuing with best seed (\d+)", out).group(1))
    assert best == (40, 41)[int(np.argmax(f1s))]
    stem = "MLSTM_FCN_clip_21_dist_3_Focal_Normal"
    for s in (40, 41):
        for end in ("last", "best"):
            assert (tmp_path / "w" / f"{stem}_seed_{s}_{end}.ckpt").exists()
    assert (tmp_path / "r" / f"{stem}_seed_42_report.txt").exists()
    assert re.search(r"probability curve of shot \d+: \d+ samples", out)
    want = torch.load(tmp_path / "w" / f"{stem}_seed_{best}_best.ckpt")["model"]
    assert len(scored) == 1 and all(torch.equal(scored[0][k], want[k]) for k in want)


@pytest.mark.parametrize("extra,item", [
    (["--dp", "2"], "item 14"),
])
def test_unported_options_exit_with_roadmap_item(extra, item, tmp_path):
    """Once the refusal of ROADMAP item 14, now ported: ``--dp 2 --device
    cpu`` trains on two gloo ranks and only rank 0 writes."""
    result = train_0d.main(TINY + ["--model", "MLSTM_FCN", "--device", "cpu",
                                   "--num_epoch", "2", "--weight_dir", str(tmp_path / "w"),
                                   "--save_dir", str(tmp_path / "r")] + extra)
    check_cli_run(tmp_path, result, "MLSTM_FCN_clip_21_dist_3_Focal_Normal_seed_42", 2)


def test_runs_on_the_gpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_0d.main(TINY + ["--weight_dir", os.fspath(tmp_path)])


def test_dp_without_the_cards_raises():
    """``--dp 2`` on the GPU with fewer than two cards stops before any work."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are present: the run would start")
    with pytest.raises(SystemExit, match="--dp 2 needs 2 CUDA devices"):
        train_0d.main(TINY + ["--device", "cuda", "--dp", "2"])
