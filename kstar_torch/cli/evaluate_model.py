"""Evaluation-only CLI (port of ``kstar_tpu/cli/evaluate_model.py``, a
rebuild of reference evaluate_vision_network.py / evaluate_0D_network.py):
reload a checkpoint that the port's train CLIs wrote, by tag, and rerun the
test evaluation without training — with the same shot partition and the
same evaluation path as the trainer, so the "test macro-F1" line equals the
trainer's — plus the per-sample detail CSV (0D) and, with ``--alarms``, the
alarm artifacts from whole-shot sweeps of the test and normal shots (ViViT
and multimodal through the spatial-table kernel, R(2+1)D and SlowFast
through the window-gather kernel).

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.evaluate_model --kind 0D --model MLSTM_FCN --synthetic
    python -m kstar_torch.cli.evaluate_model --kind vision --model ViViT --synthetic --alarms
    python -m kstar_torch.cli.evaluate_model --kind vision --model SlowFast --bn_splits 2 --synthetic
    python -m kstar_torch.cli.evaluate_model --kind multimodal --model_type concat --synthetic

Pass the model flags the checkpoint was trained with; unset ones take the
matching train CLI's defaults.
"""

from __future__ import annotations

import argparse
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    from .common import add_common_args

    p = argparse.ArgumentParser(description="evaluate a trained disruption predictor")
    p.add_argument("--kind", type=str, default="0D", choices=["0D", "vision", "multimodal"])
    p.add_argument("--model", type=str, default="Transformer",
                   help="0D: Transformer | CnnLSTM | MLSTM_FCN; vision: ViViT | "
                        "R2Plus1D | SlowFast. The conv configs are rebuilt with "
                        "--tau_alpha 4, --tau_fast 1 and --layer_sizes 1 2 2 1 "
                        "(the train CLI's defaults): a checkpoint trained with "
                        "other values will not load")
    # multimodal reload args (mirror cli/train_multimodal.py)
    p.add_argument("--model_type", type=str, default="concat", choices=["concat", "TFN"])
    p.add_argument("--use_GB", action="store_true")
    p.add_argument("--tau", type=int, default=1)
    p.add_argument("--pair_mode", choices=("reference", "aligned"),
                   default="reference",
                   help="multimodal video<->0D pairing; pass the value used "
                        "at training time (see cli/train_multimodal.py)")
    p.add_argument("--ts_layers", type=int, default=4)
    p.add_argument("--ts_heads", type=int, default=8)
    p.add_argument("--tag", type=str, required=False, default=None)
    p.add_argument("--which", type=str, default="best", choices=["best", "last"])
    add_common_args(p, batch_size=128)
    # mirror the model-hparam args of the train CLIs so configs reconstruct
    p.add_argument("--feature_dims", type=int, default=128)
    p.add_argument("--n_layers", type=int, default=4)
    # None = per-kind default resolved in main(): the train CLIs disagree
    # (train_0d: n_heads 8 / ff 1024; train_vision: n_heads 4 / scale 8;
    # train_multimodal: n_heads 4 / scale 4 / ff 512) and a reload built
    # with the wrong one fails on checkpoint parameter shapes
    p.add_argument("--n_heads", type=int, default=None)
    p.add_argument("--dim_feedforward", type=int, default=None)
    p.add_argument("--cls_dims", type=int, default=128)
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--conv_kernel", type=int, default=3)
    p.add_argument("--lstm_dim", type=int, default=128)
    p.add_argument("--lstm_layers", type=int, default=4)
    p.add_argument("--fcn_dim", type=int, default=128)
    p.add_argument("--reduction", type=int, default=16)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--d_head", type=int, default=64)
    p.add_argument("--scale_dim", type=int, default=None)
    p.add_argument("--norm_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="match the training run's ViViT LN/softmax dtype")
    p.add_argument("--alpha", type=float, default=0.01)
    p.add_argument("--bn_splits", type=int, default=None,
                   help="mirror of train_vision --bn_splits (SlowFast "
                        "SubBatchNorm); must match the trained checkpoint")
    p.add_argument("--synthetic_dt", type=float, default=4.0 / 210.0,
                   help="mirror of train_multimodal --synthetic_dt; must "
                        "match training or the window ladders shift")
    p.add_argument("--alarms", action="store_true",
                   help="(--kind vision/multimodal) also sweep the test + "
                        "normal shots and regenerate the alarm artifacts "
                        "({tag}_alarms.json/csv, {tag}_threshold_tradeoff"
                        ".csv ...) from the reloaded checkpoint, no retraining")
    return p


def _report(results, save_dir: str, tag: str) -> None:
    from ..eval.evaluate import format_report

    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"{tag}_eval_report.txt"), "w") as f:
        f.write(format_report(results))
    print(f"test macro-F1 {results['macro_f1']:.4f} | ROC-AUC {results['roc_auc']:.4f}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    # per-kind model-hparam defaults, mirroring the matching train CLI so a
    # default-trained checkpoint reloads with default eval flags
    mm = args.kind == "multimodal"
    if args.n_heads is None:
        args.n_heads = 8 if args.kind == "0D" else 4
    if args.scale_dim is None:
        args.scale_dim = 4 if mm else 8
    if args.dim_feedforward is None:
        args.dim_feedforward = 512 if mm else 1024

    from .. import resolve_device
    from ..config import Schema
    from ..train import load_params
    from .common import configs_from_args, load_data, make_tag

    device = resolve_device(args.device)
    train_cfg, loss_cfg, _ = configs_from_args(args)
    name = args.model
    if mm:
        # train_multimodal tags checkpoints by fusion type, not backbone name
        name = f"{args.model_type}{'_GB' if args.use_GB else ''}"
    tag = args.tag or make_tag(name, args, loss_cfg, train_cfg)
    ckpt = os.path.join(args.weight_dir, f"{tag}_{args.which}.ckpt")
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"checkpoint not found: {ckpt}")
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    test_shot = None if args.synthetic else args.test_shot_num
    cols = Schema.INPUT_FEATURES
    init = torch.Generator().manual_seed(args.random_seed)

    if args.kind == "0D":
        from ..config import DT_0D
        from ..data import TSDataset, prepare_0d_dataset
        from ..eval import evaluate, evaluate_detail, evaluation_figure
        from ..models import build_0d_model
        from .common import draw_figure, save_figure
        from .train_0d import model_config

        disrupt_df, ts_df, _ = load_data(args, need_video=False, dt=DT_0D)
        df_train, df_valid, df_test, scaler = prepare_0d_dataset(
            ts_df, cols, scaler=args.scaler, test_shot=test_shot)
        # include_normal as the trainer builds its datasets (train_0d), so the
        # reload scores the trainer's test population
        mk = lambda df: TSDataset(df, disrupt_df, cols, seq_len=args.seq_len,
                                  dist=args.dist, dt=DT_0D, scaler=scaler,
                                  include_normal=args.train_with_normal)
        train_ds, valid_ds, test_ds = mk(df_train), mk(df_valid), mk(df_test)

        model = build_0d_model(args.model, model_config(args, len(cols)), dtype=dtype,
                               generator=init).to(device)
        load_params(model, ckpt)
        results = evaluate(model, test_ds, loss_cfg, args.batch_size, args.threshold,
                           save_txt=os.path.join(args.save_dir, f"{tag}_eval_report.txt"))
        print(f"test macro-F1 {results['macro_f1']:.4f} | ROC-AUC {results['roc_auc']:.4f}")
        eval_path = os.path.join(args.save_dir, f"{tag}_eval.png")
        draw_figure(eval_path, lambda: save_figure(evaluation_figure(results), eval_path))

        evaluate_detail(model, {"train": train_ds, "valid": valid_ds, "test": test_ds},
                        loss_cfg, batch_size=args.batch_size, threshold=args.threshold,
                        save_csv=os.path.join(args.save_dir, f"{tag}_detail.csv"))
        return results

    from ..config import AugmentConfig
    from ..data import DevicePreprocessor, to_device
    from ..eval.evaluate import evaluate_probs
    from ..losses import ldam_margins
    from ..train.loop import make_eval_step, run_eval_epoch
    from .common import partition_shots, resolve_normal_splits

    # --- multimodal ---------------------------------------------------------
    if mm:
        # Reload path for cli/train_multimodal.py checkpoints: the trainer's
        # split, scaler, datasets, model and evaluation step
        from ..config import DT_MULTI
        from ..data import MultiModalDataset, Scaler, random_split_shots
        from ..models import TFN, TFNGB, MultiModalConcat, MultiModalGB

        dt = DT_MULTI if not args.synthetic else args.synthetic_dt
        disrupt_df, ts_df, store = load_data(args, need_video=True, dt=dt)
        # strip non-disruptive shots BEFORE splitting, exactly as the trainer
        # does — otherwise --synthetic_normal > 0 shifts the split and this
        # reload evaluates a different test population than training saw
        shots, normal_s, eval_disrupt_s, eval_normal_s = partition_shots(
            disrupt_df, sorted(store.arrays.keys()))
        train_s, valid_s, test_s = random_split_shots(shots, test_shot, seed=42)
        train_n, _, test_n, sweep_normals, inc_normal = resolve_normal_splits(
            args, normal_s, lambda ss: random_split_shots(ss, None, seed=42))

        scaler = Scaler(args.scaler)
        scaler.fit(ts_df[ts_df.shot.isin(list(train_s) + train_n)][cols].values)
        test_ds = MultiModalDataset(store, ts_df, disrupt_df, cols,
                                    list(test_s) + test_n,
                                    seq_len=args.seq_len, dist=args.dist,
                                    dt=dt, tau=args.tau, scaler=scaler,
                                    pair_mode=args.pair_mode,
                                    include_normal=inc_normal)

        crop = min(args.image_size, store.arrays[shots[0]].shape[1])
        vivit_kw = dict(image_size=crop, patch_size=args.patch_size,
                        n_frames=args.seq_len, dim=args.dim, depth=args.depth,
                        n_heads=args.n_heads, d_head=args.d_head,
                        scale_dim=args.scale_dim, dropout=args.dropout,
                        embedd_dropout=args.dropout)
        ts_kw = dict(n_features=len(cols), feature_dims=args.feature_dims,
                     max_len=args.seq_len, n_layers=args.ts_layers,
                     n_heads=args.ts_heads, dim_feedforward=args.dim_feedforward,
                     dropout=args.dropout, cls_dims=128)
        if args.model_type == "concat":
            cls = MultiModalGB if args.use_GB else MultiModalConcat
        else:
            cls = TFNGB if args.use_GB else TFN
        model = cls(vivit_kw, ts_kw, dtype=dtype, generator=init).to(device)
        load_params(model, ckpt)

        put_eval = DevicePreprocessor(crop, AugmentConfig(), train=False,
                                      out_dtype=dtype, device=device)
        eval_step = make_eval_step(loss_cfg, model_type="multi-GB" if args.use_GB
                                   else "multi")
        w = torch.ones(2, device=device)
        m = torch.as_tensor(ldam_margins(test_ds.class_counts(),
                                         loss_cfg.ldam_max_m)).to(device)
        gb = torch.tensor([0.0, 0.0, 1.0], device=device)
        _, _, _, (probs, labels) = run_eval_epoch(
            eval_step, model, test_ds, args.batch_size, w, m, put=put_eval,
            collect_probs=True, gb_w=gb)
        results = evaluate_probs(probs, labels, args.threshold)
        _report(results, args.save_dir, tag)

        if args.alarms:
            from ..eval import sweep_multimodal_prob_curves
            from .common import write_alarm_artifacts

            curves = sweep_multimodal_prob_curves(
                model, store, ts_df, disrupt_df,
                list(test_s) + list(eval_disrupt_s) + list(sweep_normals)
                + list(eval_normal_s),
                cols, scaler, seq_len=args.seq_len, dist=args.dist, dt=dt,
                tau=args.tau, crop_size=crop, batch_size=args.batch_size,
                compute_dtype=dtype, device=device)
            write_alarm_artifacts(curves, args.threshold, args.save_dir, tag,
                                  min_dwell_s=args.alarm_dwell_s)
        return results

    # --- vision -------------------------------------------------------------
    from ..data import VideoDataset, split_shots
    from ..data.augment import make_pre_fns
    from ..eval import evaluate
    from ..models import build_video_model
    from .common import emit_alarm_artifacts
    from .train_vision import model_config as vision_model_config

    disrupt_df, _, store = load_data(args, need_video=True)
    # match train_vision's split exactly (eval-only carved off first)
    shots, normal_s, eval_disrupt_s, eval_normal_s = partition_shots(
        disrupt_df, sorted(store.arrays.keys()))
    _, _, test_s = split_shots(shots, test_shot)
    _, _, test_n, sweep_normals, inc_normal = resolve_normal_splits(
        args, normal_s, lambda ss: split_shots(ss, None))

    # reconstruct the vision config from the mirrored args
    ns = argparse.Namespace(**{**vars(args), "tau_alpha": 4, "tau_fast": 1,
                               "layer_sizes": [1, 2, 2, 1],
                               "embedd_dropout": args.dropout})
    cfg, seq_len = vision_model_config(ns)
    model = build_video_model(args.model, cfg, dtype=dtype, generator=init).to(device)
    load_params(model, ckpt)

    crop = min(args.image_size, store.arrays[shots[0]].shape[1])
    _, pre_eval = make_pre_fns(crop, AugmentConfig(), out_dtype=dtype)
    test_ds = VideoDataset(store, disrupt_df, list(test_s) + test_n,
                           seq_len=seq_len, dist=args.dist, include_normal=inc_normal)
    results = evaluate(model, test_ds, loss_cfg, args.batch_size, args.threshold,
                       put=lambda bl: to_device(bl, device), pre_fn=pre_eval)
    _report(results, args.save_dir, tag)

    if args.alarms:
        emit_alarm_artifacts(
            model, store, disrupt_df,
            list(test_s) + list(eval_disrupt_s) + list(sweep_normals)
            + list(eval_normal_s),
            seq_len=seq_len, dist=args.dist, crop=crop,
            batch_size=args.batch_size, dtype=dtype,
            threshold=args.threshold, save_dir=args.save_dir, tag=tag,
            min_dwell_s=args.alarm_dwell_s, device=device)
    return results


if __name__ == "__main__":
    main()
