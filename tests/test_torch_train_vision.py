"""The port's train_vision CLI on the CPU at tiny widths: the same dataset
sizes and class counts as kstar_tpu's CLI builds from the same seed, the
report, checkpoints and alarm artifacts written, an exact resume, the conv
models (R(2+1)D, SlowFast, SlowFast with --bn_splits) trained and swept,
several --seeds training a seed ensemble that goes on with its best seed
(refused with --bn_splits, as in JAX), and --dp refused with the ROADMAP item
that ports it."""

import os
import re

import numpy as np
import pytest
import torch

from _torch_parallel_worker import check_cli_run

from kstar_torch.cli import train_vision

TINY = ["--synthetic", "--synthetic_shots", "6", "--synthetic_frames", "96",
        "--synthetic_normal", "2", "--batch_size", "8", "--dim", "32", "--depth", "1",
        "--n_heads", "2", "--d_head", "16", "--scale_dim", "2", "--image_size", "32",
        "--seq_len", "5", "--verbose", "1"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_dataset_line(argv):
    """The line kstar_tpu.cli.train_vision prints after building its
    datasets, built by its own functions from the same arguments."""
    from kstar_tpu.cli import train_vision as jtv
    from kstar_tpu.cli.common import load_data, partition_shots, resolve_normal_splits
    from kstar_tpu.data import VideoDataset, split_shots

    args = jtv.build_parser().parse_args(argv)
    disrupt_df, _, store = load_data(args, need_video=True)
    shots, normal_s, _, _ = partition_shots(disrupt_df, sorted(store.arrays.keys()))
    train_s, valid_s, test_s = split_shots(shots, None)
    train_n, valid_n, test_n, _, inc = resolve_normal_splits(
        args, normal_s, lambda ss: split_shots(ss, None))
    _, seq_len = jtv.model_config(args)
    mk = lambda ss: VideoDataset(store, disrupt_df, ss, seq_len=seq_len,
                                 dist=args.dist, include_normal=inc)
    tr, va, te = mk(list(train_s) + train_n), mk(list(valid_s) + valid_n), mk(list(test_s) + test_n)
    return (f"datasets: train {len(tr)} valid {len(va)} test {len(te)} "
            f"| class counts {tr.class_counts().tolist()}")


@pytest.mark.parametrize("extra", [[], ["--train_with_normal", "--use_DRW"]],
                         ids=["default", "train_with_normal"])
def test_cli_trains_reports_and_resumes(tmp_path, capsys, extra):
    argv = TINY + extra + ["--weight_dir", str(tmp_path / "w"), "--save_dir",
                           str(tmp_path / "r")]
    results = train_vision.main(argv + ["--device", "cpu", "--num_epoch", "2"])
    out = capsys.readouterr().out
    line = re.search(r"datasets: .*", out).group(0)
    assert line == _jax_dataset_line(argv)
    assert re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC", out)
    assert 0.0 <= results["macro_f1"] <= 1.0
    tag = "ViViT_clip_5_dist_3_Focal_" + ("DRW" if extra else "Normal") + "_seed_42"
    for name in ("_last.ckpt", "_best.ckpt"):
        assert (tmp_path / "w" / f"{tag}{name}").exists()
    for name in ("_report.txt", "_alarms.json", "_alarms.csv", "_threshold_tradeoff.csv",
                 "_dwell_tradeoff.csv", "_operating_grid.csv"):
        assert (tmp_path / "r" / f"{tag}{name}").exists(), name
    assert "macro F1" in (tmp_path / "r" / f"{tag}_report.txt").read_text()
    assert "alarm summary" in out and "figure skipped" not in out
    for name in ("_learning_curve.png", "_prob_curve-zoom.png"):
        assert (tmp_path / "r" / f"{tag}{name}").stat().st_size > 0, name
    assert any((tmp_path / "r" / "tensorboard" / tag).glob("eval_valid_*.png"))
    saved = int(torch.load(tmp_path / "w" / f"{tag}_last.ckpt")["step"])
    assert saved > 0

    train_vision.main(argv + ["--device", "cpu", "--num_epoch", "1", "--resume"])
    out = capsys.readouterr().out
    assert f"at step {saved}" in re.search(r"resumed from .*", out).group(0)
    assert int(torch.load(tmp_path / "w" / f"{tag}_last.ckpt")["step"]) > saved


@pytest.mark.parametrize("extra,seq_len", [
    (["--model", "R2Plus1D", "--layer_sizes", "1", "1", "1", "1"], 5),
    (["--model", "SlowFast"], 4),
    (["--model", "SlowFast", "--bn_splits", "2"], 4),
], ids=["R2Plus1D", "SlowFast", "SlowFast_bn_splits_2"])
def test_conv_models_train_and_sweep(tmp_path, capsys, extra, seq_len):
    """The conv models through the whole CLI for one epoch: the datasets of
    kstar_tpu's CLI (SlowFast's --seq_len 5 rounded down to 4, a multiple
    of --tau_alpha 4), the JAX CLI's tag (which keeps --seq_len), the
    checkpoints, the report and the alarm artifacts of the raw-frame sweep;
    with --bn_splits the checkpoint's SubBatchNorm statistics are the
    aggregate of its split statistics."""
    from kstar_torch.models import aggregate_subbn_stats

    argv = TINY + extra + ["--weight_dir", str(tmp_path / "w"), "--save_dir",
                           str(tmp_path / "r")]
    model = extra[1]
    train_vision.main(argv + ["--device", "cpu", "--num_epoch", "1"])
    out = capsys.readouterr().out
    assert re.search(r"datasets: .*", out).group(0) == _jax_dataset_line(argv)
    assert train_vision.model_config(train_vision.build_parser().parse_args(argv))[1] == seq_len
    tag = f"{model}_clip_5_dist_3_Focal_Normal_seed_42"
    for name in ("_last.ckpt", "_best.ckpt"):
        assert (tmp_path / "w" / f"{tag}{name}").exists()
    for name in ("_report.txt", "_alarms.json", "_alarms.csv", "_operating_grid.csv"):
        assert (tmp_path / "r" / f"{tag}{name}").exists(), name
    assert "alarm summary" in out and "alarm evaluation skipped" not in out
    sd = torch.load(tmp_path / "w" / f"{tag}_last.ckpt")["model"]
    split = [k for k in sd if k.endswith("split_mean")]
    assert bool(split) == ("--bn_splits" in extra)
    agg = aggregate_subbn_stats(sd)
    for k in split:
        for stat in ("running_mean", "running_var"):
            key = k.replace("split_mean", stat)
            assert torch.equal(sd[key], agg[key]), key


def test_bn_splits_needs_a_divisible_batch():
    with pytest.raises(SystemExit, match="--batch_size 8 must be divisible by --bn_splits 3"):
        train_vision.main(TINY + ["--device", "cpu", "--model", "SlowFast",
                                  "--bn_splits", "3"])


def test_seeds_train_an_ensemble_and_go_on_with_the_best(tmp_path, capsys, monkeypatch):
    """Several --seeds: one checkpoint pair per seed under JAX's
    ``{tag}_seed_{s}`` names, each seed's best valid F1 printed, and the
    evaluation and alarm sweep go on with the argmax seed's best checkpoint."""
    import importlib

    evaluate_module = importlib.import_module("kstar_torch.eval.evaluate")
    scored = []
    real_evaluate = evaluate_module.evaluate

    def recording_evaluate(model, *a, **k):
        scored.append({n: v.clone() for n, v in model.state_dict().items()})
        return real_evaluate(model, *a, **k)

    monkeypatch.setattr(evaluate_module, "evaluate", recording_evaluate)
    train_vision.main(TINY + ["--seeds", "1", "2", "--weight_dir", str(tmp_path / "w"),
                              "--save_dir", str(tmp_path / "r"), "--device", "cpu",
                              "--num_epoch", "2"])
    out = capsys.readouterr().out
    f1s = [float(f) for f in re.findall(r"seed \d+: best valid f1 ([0-9.]+)", out)]
    assert re.findall(r"seed (\d+): best valid f1", out) == ["1", "2"]
    best = int(re.search(r"continuing with best seed (\d+)", out).group(1))
    assert best == (1, 2)[int(np.argmax(f1s))]
    stem = "ViViT_clip_5_dist_3_Focal_Normal"
    for s in (1, 2):
        for end in ("last", "best"):
            assert (tmp_path / "w" / f"{stem}_seed_{s}_{end}.ckpt").exists()
    assert not (tmp_path / "w" / f"{stem}_seed_42_last.ckpt").exists()
    for name in ("_report.txt", "_alarms.json", "_operating_grid.csv"):
        assert (tmp_path / "r" / f"{stem}_seed_42{name}").exists(), name
    assert "alarm summary" in out and "alarm evaluation skipped" not in out
    # the test evaluation scored the best seed's best checkpoint
    want = torch.load(tmp_path / "w" / f"{stem}_seed_{best}_best.ckpt")["model"]
    assert len(scored) == 1 and scored[0].keys() == want.keys()
    assert all(torch.equal(scored[0][k], want[k]) for k in want)


def test_seeds_with_bn_splits_refused_as_jax():
    """JAX's refusal (kstar_tpu/cli/train_vision.py:182-185), in its words."""
    with pytest.raises(SystemExit, match=r"^--bn_splits is not supported with the --seeds "
                       r"ensemble \(stat aggregation is wired into the single-model fit"):
        train_vision.main(TINY + ["--device", "cpu", "--model", "SlowFast", "--seeds", "1",
                                  "2", "--bn_splits", "2"])


@pytest.mark.parametrize("extra,item", [
    (["--dp", "2"], "item 14"),
])
def test_unported_options_exit_with_roadmap_item(extra, item, tmp_path):
    """Once the refusal of ROADMAP item 14, now ported: ``--dp 2 --device
    cpu`` trains on two gloo ranks and only rank 0 writes."""
    result = train_vision.main(TINY + ["--device", "cpu", "--num_epoch", "2",
                                       "--weight_dir", str(tmp_path / "w"),
                                       "--save_dir", str(tmp_path / "r")] + extra)
    check_cli_run(tmp_path, result, "ViViT_clip_5_dist_3_Focal_Normal_seed_42", 2)
    assert (tmp_path / "r" / "ViViT_clip_5_dist_3_Focal_Normal_seed_42_alarms.json").exists()


def test_runs_on_the_gpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vision.main(TINY + ["--weight_dir", os.fspath(tmp_path)])


def test_dp_without_the_cards_raises():
    """``--dp 2`` on the GPU with fewer than two cards stops before any work
    (no fallback to fewer ranks or to the CPU)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are present: the run would start")
    with pytest.raises(SystemExit, match="--dp 2 needs 2 CUDA devices"):
        train_vision.main(TINY + ["--device", "cuda", "--dp", "2"])
