"""HPO sweep CLI (port of ``kstar_tpu/cli/hpo_run.py``, a rebuild of
reference hyperparameter_tuning.py): ASHA successive-halving random or TPE
search over a model's hyperparameters, then best-trial test evaluation.
Writes ``hpo_{model}.json`` (every trial's config, epochs and scores) into
``--save_dir``.

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.hpo_run --model MLSTM_FCN --synthetic --n_trials 4

``--hpo_workers N`` runs N trials of a rung at once on a thread pool, round
robin over the visible devices (each card of the machine, or the CPU);
``--hpo_vmap`` (0D only) is JAX's option: there it trains each rung's
same-architecture trials as one program; the port trains them one after
another as without it (train/hpo_vmap.py says why).
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ASHA hyperparameter search")
    p.add_argument("--model", type=str, default="MLSTM_FCN",
                   choices=["Transformer", "CnnLSTM", "MLSTM_FCN",
                            "ViViT", "R2Plus1D", "SlowFast"])
    p.add_argument("--kind", type=str, default=None, choices=["0D", "vision"],
                   help="inferred from --model when omitted")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--data_root", type=str, default="./dataset")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_difficulty", type=float, default=0.0,
                   help="0 = easy smoke fixture; 1 = hard fixture (gradual "
                        "precursors, distractors, heavy noise) — use > 0 "
                        "when comparing search algorithms, or every trial "
                        "saturates the objective")
    p.add_argument("--synthetic_shots", type=int, default=10)
    p.add_argument("--synthetic_frames", type=int, default=256)
    p.add_argument("--n_trials", type=int, default=16)
    p.add_argument("--max_epochs", type=int, default=16)
    p.add_argument("--grace_period", type=int, default=2)
    p.add_argument("--reduction_factor", type=int, default=2)
    p.add_argument("--seq_len", type=int, default=21)
    p.add_argument("--dist", type=int, default=3)
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--save_dir", type=str, default="./results")
    p.add_argument("--test_shot_num", type=int, default=21310)
    p.add_argument("--hpo_workers", type=int, default=1,
                   help="concurrent trials per rung; trials round-robin over "
                        "the visible devices (the reference's Ray Tune "
                        "concurrency)")
    p.add_argument("--hpo_vmap", action="store_true",
                   help="0D only: JAX's grouped rungs; the port trains the "
                        "trials one after another as without it "
                        "(train/hpo_vmap.py)")
    p.add_argument("--search", type=str, default="random",
                   choices=["random", "tpe"],
                   help="config generation: prior sampling or model-based "
                        "TPE (the reference's HyperOptSearch, "
                        "hyperparameter_tuning.py:18)")
    p.add_argument("--tpe_startup", type=int, default=None,
                   help="random trials before TPE proposals start "
                        "(default n_trials//2, min 4)")
    p.add_argument("--tpe_batch", type=int, default=4,
                   help="TPE proposals per batch (keeps grouped rungs dense)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the GPU; the tests "
                        "pass cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .. import resolve_device
    from ..config import (CnnLSTMConfig, DT_0D, AugmentConfig, LossConfig, MLSTMFCNConfig,
                          OptimConfig, R2Plus1DConfig, Schema, SlowFastConfig,
                          TransformerConfig, ViViTConfig)
    from ..data import (DevicePreprocessor, TSDataset, VideoDataset, prepare_0d_dataset,
                        split_shots, to_device)
    from ..eval import evaluate
    from ..models import build_0d_model, build_video_model
    from ..train import create_train_state, make_eval_step, make_train_step
    from ..train.hpo import run_asha, search_space_0d, search_space_video
    from ..train.loop import _loss_aux, run_eval_epoch, run_train_epoch
    from .common import load_data

    device = resolve_device(args.device)
    kind = args.kind or ("vision" if args.model in ("ViViT", "R2Plus1D", "SlowFast")
                         else "0D")
    cols = Schema.INPUT_FEATURES
    test_shot = None if args.synthetic else args.test_shot_num
    ns = argparse.Namespace(synthetic=args.synthetic, data_root=args.data_root,
                            random_seed=args.random_seed,
                            synthetic_difficulty=args.synthetic_difficulty,
                            synthetic_shots=args.synthetic_shots,
                            synthetic_frames=args.synthetic_frames)
    if kind == "vision":
        disrupt_df, ts_df, store = load_data(ns, need_video=True, dt=DT_0D)
        shots = sorted(store.arrays.keys())
        train_s, valid_s, test_s = split_shots(shots, test_shot)
        crop = min(args.image_size, store.arrays[shots[0]].shape[1])
        mkv = lambda ss: VideoDataset(store, disrupt_df, ss,
                                      seq_len=args.seq_len, dist=args.dist)
        train_ds, valid_ds, test_ds = mkv(train_s), mkv(valid_s), mkv(test_s)
    else:
        disrupt_df, ts_df, _ = load_data(ns, need_video=False, dt=DT_0D)
        df_train, df_valid, df_test, scaler = prepare_0d_dataset(ts_df, cols,
                                                                 test_shot=test_shot)
        mk = lambda df: TSDataset(df, disrupt_df, cols, seq_len=args.seq_len,
                                  dist=args.dist, dt=DT_0D, scaler=scaler)
        train_ds, valid_ds, test_ds = mk(df_train), mk(df_valid), mk(df_test)

    for name, ds in (("train", train_ds), ("valid", valid_ds),
                     ("test", test_ds)):
        if len(ds) == 0:
            raise SystemExit(
                f"{name} split has 0 windows: shots are too short for "
                f"seq_len={args.seq_len} + dist={args.dist} (each window "
                f"needs seq_len + dist rows before the quench; raise "
                f"--synthetic_frames or lower --dist)")
        if len(np.unique(np.asarray(ds.labels))) < 2:
            raise SystemExit(
                f"{name} split is single-class: every window in the search "
                f"objective would score a constant F1 (0.5) and no search "
                f"algorithm can be ranked. With dist={args.dist} the "
                f"non-disruptive zone needs > seq_len + 2*dist rows; raise "
                f"--synthetic_frames or lower --dist")

    def make_model(config, generator):
        if args.model == "ViViT":
            cfg = ViViTConfig(image_size=min(args.image_size, 64), n_frames=args.seq_len,
                              dim=config.get("dim", 64), depth=config.get("depth", 1),
                              n_heads=config.get("n_heads", 2), d_head=32,
                              scale_dim=2, dropout=config.get("dropout", 0.1))
            return build_video_model(args.model, cfg, generator=generator)
        if args.model == "R2Plus1D":
            cfg = R2Plus1DConfig(image_size=min(args.image_size, 64), n_frames=args.seq_len,
                                 layer_sizes=tuple(config.get("layer_sizes", (1, 1, 1, 1))))
            return build_video_model(args.model, cfg, generator=generator)
        if args.model == "SlowFast":
            L = args.seq_len - args.seq_len % config.get("alpha", 4)
            cfg = SlowFastConfig(image_size=min(args.image_size, 64), n_frames=L,
                                 alpha=config.get("alpha", 4))
            return build_video_model(args.model, cfg, generator=generator)
        if args.model == "Transformer":
            cfg = TransformerConfig(n_features=len(cols), max_len=args.seq_len,
                                    feature_dims=config.get("feature_dims", 128),
                                    n_layers=config.get("n_layers", 2),
                                    dropout=config.get("dropout", 0.1))
        elif args.model == "CnnLSTM":
            cfg = CnnLSTMConfig(seq_len=args.seq_len, n_features=len(cols),
                                conv_dim=config.get("conv_dim", 64),
                                lstm_dim=config.get("lstm_dim", 128),
                                n_layers=config.get("n_layers", 2))
        else:
            cfg = MLSTMFCNConfig(n_features=len(cols), seq_len=args.seq_len,
                                 fcn_dim=config.get("fcn_dim", 128),
                                 lstm_dim=config.get("lstm_dim", 64),
                                 lstm_dropout=config.get("lstm_dropout", 0.1))
        return build_0d_model(args.model, cfg, generator=generator)

    _trial_ids = itertools.count()      # .__next__ is atomic in CPython

    def trainable(config, n_epochs, carry, trial_device=None):
        """Train n_epochs more; carry = (model, state, eval_step, puts) for
        resume. ``trial_device`` is this trial's (parallel rungs; default
        ``--device``). The train step is made anew each rung, so a trial
        waiting for its next rung holds no captured graph
        (``train/loop.py _TrainStep``). Vision trials train under the real
        run's augmentation (the reference's HPO forwards its augmentation
        args, hyperparameter_tuning.py:84-92 / :199-207), each from its own
        train-mode preprocessor seeded from a fresh trial id, so concurrent
        trials are augmented independently."""
        dev = device if trial_device is None else trial_device
        batch_size = int(config.get("batch_size", 128))
        loss_cfg = LossConfig(loss_type="Focal",
                              focal_gamma=config.get("focal_gamma", 2.0))
        if carry is None:
            model = make_model(config, torch.Generator().manual_seed(args.random_seed))
            state = create_train_state(model.to(dev), OptimConfig(lr=config.get("lr", 1e-3)),
                                       seed=args.random_seed)
            eval_step = make_eval_step(loss_cfg)
            if kind == "vision":
                puts = (DevicePreprocessor(crop, AugmentConfig(), train=True,
                                           out_dtype=torch.float32, device=dev,
                                           seed=args.random_seed + 7919 * next(_trial_ids)),
                        DevicePreprocessor(crop, train=False, out_dtype=torch.float32,
                                           device=dev))
            else:
                put = lambda item: to_device(item, dev)
                puts = (put, put)
        else:
            model, state, eval_step, puts = carry
        train_step = make_train_step(loss_cfg)

        counts = train_ds.class_counts()
        rng = np.random.default_rng(args.random_seed)
        scores = []
        for ep in range(n_epochs):
            w, m = _loss_aux(loss_cfg, counts, ep, max(n_epochs, 1), dev)
            state, *_ = run_train_epoch(train_step, state, train_ds, batch_size, rng,
                                        w, m, put=puts[0])
            _, _, f1 = run_eval_epoch(eval_step, state.model, valid_ds, batch_size,
                                      w, m, put=puts[1])
            scores.append(f1)
        return (model, state, eval_step, puts), scores

    space = (search_space_video(args.model) if kind == "vision"
             else search_space_0d(args.model))
    if args.hpo_vmap and kind != "0D":
        raise SystemExit("--hpo_vmap supports the 0D models only "
                         "(vision trials rarely fit in device memory together)")
    devices = None
    if args.hpo_workers > 1:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
    best, trials = run_asha(
        trainable, space, n_trials=args.n_trials,
        max_epochs=args.max_epochs, grace_period=args.grace_period,
        reduction_factor=args.reduction_factor, seed=args.random_seed,
        log_path=os.path.join(args.save_dir, f"hpo_{args.model}.json"),
        n_workers=args.hpo_workers, devices=devices,
        search=args.search,
        tpe_startup=args.tpe_startup, tpe_batch=args.tpe_batch)

    print(f"best trial {best.trial_id}: valid F1 {best.best:.4f}")
    print(f"config: {best.config}")

    # best-trial test evaluation (reference hyperparameter_tuning.py:548-570)
    model = best.state[0]
    eval_put = (DevicePreprocessor(crop, train=False, out_dtype=torch.float32,
                                   device=next(model.parameters()).device)
                if kind == "vision" else None)
    results = evaluate(model, test_ds, LossConfig(loss_type="Focal"), batch_size=128,
                       put=eval_put)
    print(f"test macro-F1 {results['macro_f1']:.4f} | ROC-AUC {results['roc_auc']:.4f}")
    return best, results


if __name__ == "__main__":
    main()
