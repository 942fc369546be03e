"""The port's train_vision CLI on the CPU at tiny widths: the same dataset
sizes and class counts as kstar_tpu's CLI builds from the same seed, the
report, checkpoints and alarm artifacts written, an exact resume, the conv
models (R(2+1)D, SlowFast, SlowFast with --bn_splits) trained and swept, and
the options not ported yet refused with the ROADMAP item that ports them."""

import os
import re

import pytest
import torch

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


@pytest.mark.parametrize("extra,item", [
    (["--seeds", "1", "2"], "item 13"),
    (["--seeds", "1", "2", "--bn_splits", "2"], "item 13"),
    (["--dp", "2"], "item 14"),
])
def test_unported_options_exit_with_roadmap_item(extra, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {item}"):
        train_vision.main(TINY + ["--device", "cpu"] + extra)


def test_runs_on_the_gpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vision.main(TINY + ["--weight_dir", os.fspath(tmp_path)])
