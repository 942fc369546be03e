"""The port's train_multimodal CLI on the CPU at tiny widths: the same
dataset sizes and class counts as kstar_tpu's CLI builds from the same
seed, the report, checkpoints and alarm artifacts for concat fusion and for
TFN with dynamic Gradient Blending, an exact resume, several --seeds refused
(the JAX package has no multimodal ensemble), and --dp refused with the
ROADMAP item that ports it."""

import json
import re

import pytest
import torch

from _torch_parallel_worker import check_cli_run

from kstar_torch.cli import train_multimodal

TINY = ["--synthetic", "--synthetic_shots", "6", "--batch_size", "16", "--verbose", "1",
        "--seq_len", "5", "--image_size", "32", "--patch_size", "8", "--dim", "32",
        "--depth", "1", "--n_heads", "2", "--d_head", "16", "--scale_dim", "2",
        "--feature_dims", "32", "--ts_layers", "1", "--ts_heads", "4",
        "--dim_feedforward", "64"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_dataset_line(argv):
    """The line kstar_tpu.cli.train_multimodal prints after building its
    datasets, built by its own functions from the same arguments."""
    from kstar_tpu.cli import train_multimodal as jt
    from kstar_tpu.cli.common import (load_data, partition_shots,
                                      resolve_normal_splits)
    from kstar_tpu.config import Schema
    from kstar_tpu.data import MultiModalDataset, Scaler, random_split_shots

    args = jt.build_parser().parse_args(argv)
    cols = Schema.INPUT_FEATURES
    dt = args.synthetic_dt
    disrupt_df, ts_df, store = load_data(args, need_video=True, dt=dt)
    shots, normal_s, _, _ = partition_shots(disrupt_df, sorted(store.arrays.keys()))
    train_s, valid_s, test_s = random_split_shots(shots, None, seed=42)
    train_n, valid_n, test_n, _, inc = resolve_normal_splits(
        args, normal_s, lambda ss: random_split_shots(ss, None, seed=42))
    scaler = Scaler(args.scaler).fit(
        ts_df[ts_df.shot.isin(list(train_s) + train_n)][cols].values)
    tr, va, te = (MultiModalDataset(store, ts_df, disrupt_df, cols, ss,
                                    seq_len=args.seq_len, dist=args.dist, dt=dt,
                                    tau=args.tau, scaler=scaler, pair_mode=args.pair_mode,
                                    include_normal=inc)
                  for ss in (list(train_s) + train_n, list(valid_s) + valid_n,
                             list(test_s) + test_n))
    return (f"datasets: train {len(tr)} valid {len(va)} test {len(te)} "
            f"| class counts {tr.class_counts().tolist()}")


@pytest.mark.parametrize("extra,tag", [
    (["--model_type", "concat"], "concat"),
    (["--model_type", "TFN", "--use_GB", "--gb_dynamic", "--epoch_per_GB_estimate", "1",
      "--n_epochs_GB_estimate", "1"], "TFN_GB"),
])
def test_cli_trains_reports_sweeps_and_resumes(tmp_path, capsys, extra, tag):
    argv = TINY + extra + ["--weight_dir", str(tmp_path / "w"),
                           "--save_dir", str(tmp_path / "r")]
    results = train_multimodal.main(argv + ["--device", "cpu", "--num_epoch", "2"])
    out = capsys.readouterr().out
    assert re.search(r"datasets: .*", out).group(0) == _jax_dataset_line(argv)
    assert re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC", out)
    assert 0.0 <= results["macro_f1"] <= 1.0
    assert "alarm evaluation skipped" not in out
    assert "figure skipped" not in out and "latent viz skipped" not in out
    full = f"{tag}_clip_5_dist_3_Focal_Normal_seed_42"
    for name in ("_learning_curve.png", "_prob_curve.png", "_latent_multi.png"):
        assert (tmp_path / "r" / f"{full}{name}").stat().st_size > 0, name
    for name in ("_last.ckpt", "_best.ckpt"):
        assert (tmp_path / "w" / f"{full}{name}").exists()
    if "--use_GB" in extra:
        assert "final GB weights" in out
        best = json.loads((tmp_path / "w" / f"{full}_best.ckpt.json").read_text())
        assert set(best["gb_weights"]) == {"video", "0D", "multi"}
    assert "macro F1" in (tmp_path / "r" / f"{full}_report.txt").read_text()
    for name in ("_alarms.json", "_alarms.csv", "_threshold_tradeoff.csv",
                 "_dwell_tradeoff.csv", "_operating_grid.csv"):
        assert (tmp_path / "r" / f"{full}{name}").exists(), name
    summary = json.loads((tmp_path / "r" / f"{full}_alarms.json").read_text())
    assert summary["n_shots"] >= 1
    saved = int(torch.load(tmp_path / "w" / f"{full}_last.ckpt")["step"])
    assert saved > 0

    train_multimodal.main(argv + ["--device", "cpu", "--num_epoch", "1", "--resume",
                                  "--skip_extras"])
    out = capsys.readouterr().out
    assert f"at step {saved}" in re.search(r"resumed from .*", out).group(0)
    assert int(torch.load(tmp_path / "w" / f"{full}_last.ckpt")["step"]) > saved


@pytest.mark.parametrize("extra,item", [
    (["--seeds", "1", "2"], "the JAX package has no multimodal ensemble"),
    (["--dp", "2"], "item 14"),
])
def test_unported_options_exit_with_roadmap_item(extra, item, tmp_path):
    """``--seeds`` with several seeds stays refused. ``--dp`` was the refusal
    of ROADMAP item 14, now ported: ``--dp 2 --device cpu --use_GB`` trains
    ``fit_gb`` on two gloo ranks and only rank 0 writes."""
    if item != "item 14":
        with pytest.raises(SystemExit, match=item):
            train_multimodal.main(TINY + extra + ["--device", "cpu"])
        return
    result = train_multimodal.main(TINY + extra + [
        "--device", "cpu", "--use_GB", "--num_epoch", "1", "--skip_extras",
        "--weight_dir", str(tmp_path / "w"), "--save_dir", str(tmp_path / "r")])
    check_cli_run(tmp_path, result, "concat_GB_clip_5_dist_3_Focal_Normal_seed_42", 1)


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_multimodal.main(TINY)


def test_defaults_follow_the_jax_cli():
    from kstar_tpu.cli import train_multimodal as jt

    ours = vars(train_multimodal.build_parser().parse_args([]))
    theirs = vars(jt.build_parser().parse_args([]))
    ours.pop("device"), ours.pop("seeds")
    assert ours == theirs


def test_dp_without_the_cards_raises():
    """``--dp 2`` on the GPU with fewer than two cards stops before any work."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are present: the run would start")
    with pytest.raises(SystemExit, match="--dp 2 needs 2 CUDA devices"):
        train_multimodal.main(TINY + ["--device", "cuda", "--dp", "2"])
