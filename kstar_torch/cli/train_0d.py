"""0D network training CLI (port of ``kstar_tpu/cli/train_0d.py``, a rebuild
of reference train_0D_network.py): 0D dataset -> Transformer / CnnLSTM /
MLSTM-FCN -> train/train_DRW with last and best checkpoints -> reload the
best checkpoint -> test macro-F1 and ROC-AUC -> permutation feature
importance -> the latent-space view -> the continuous probability curve of
the last shot; the learning curve, evaluation, importance, latent and
probability figures.

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.train_0d --model MLSTM_FCN --synthetic --num_epoch 4

Several ``--seeds`` train a seed ensemble (``train/ensemble.py``): one
``{tag}_seed_{s}_{best,last}.ckpt`` pair per seed, then the evaluation and
the extras go on with the seed of the best valid F1. Figures go through
``common.draw_figure``: without matplotlib each is skipped with a line that
names its file.

``--dp N`` trains data-parallel over N ranks as ``train_vision`` does
(``cli/common.py``, ``parallel/dp.py``): each rank uploads its rows, the
steps sum the loss, the gradients and the BatchNorm statistics over the
ranks, the test evaluation gathers the probabilities, and rank 0 alone
writes and runs the extras (feature importance, the latent view and the
probability curve, one-device computations). ``--seeds`` whose count N
divides split over the ranks (each rank's members on the full batches, no
collectives), as JAX shards its ensemble axis; another count trains every
member on every rank, replicated, rank 0 writing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .common import check_dp, join_dp, start_dp


def build_parser() -> argparse.ArgumentParser:
    from .common import add_common_args

    p = argparse.ArgumentParser(description="train 0D disruption predictor")
    p.add_argument("--model", type=str, default="Transformer",
                   choices=["Transformer", "CnnLSTM", "MLSTM_FCN"])
    p.add_argument("--tag", type=str, default=None)
    add_common_args(p, batch_size=256)
    # model hyperparameters (reference train_0D_network.py:117-136)
    p.add_argument("--alpha", type=float, default=0.01)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--feature_dims", type=int, default=128)
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--dim_feedforward", type=int, default=1024)
    p.add_argument("--cls_dims", type=int, default=128)
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--conv_kernel", type=int, default=3)
    p.add_argument("--lstm_dim", type=int, default=128)
    p.add_argument("--lstm_layers", type=int, default=4)
    p.add_argument("--fcn_dim", type=int, default=128)
    p.add_argument("--reduction", type=int, default=16)
    p.add_argument("--skip_extras", action="store_true",
                   help="skip feature importance and the probability curve")
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="one seed trains with that seed; several train a "
                        "seed ensemble and go on with the best member")
    return p


def model_config(args, n_features: int):
    from ..config import CnnLSTMConfig, MLSTMFCNConfig, TransformerConfig

    if args.model == "Transformer":
        return TransformerConfig(
            n_features=n_features, feature_dims=args.feature_dims,
            max_len=args.seq_len, n_layers=args.n_layers, n_heads=args.n_heads,
            dim_feedforward=args.dim_feedforward, dropout=args.dropout,
            cls_dims=args.cls_dims)
    if args.model == "CnnLSTM":
        return CnnLSTMConfig(
            seq_len=args.seq_len, n_features=n_features, conv_dim=args.conv_dim,
            conv_kernel=args.conv_kernel, lstm_dim=args.lstm_dim,
            n_layers=args.lstm_layers)
    return MLSTMFCNConfig(
        n_features=n_features, fcn_dim=args.fcn_dim, seq_len=args.seq_len,
        lstm_dim=args.lstm_dim, lstm_dropout=args.dropout,
        reduction=args.reduction, alpha=args.alpha)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.seeds and len(args.seeds) == 1:
        # a single --seeds value trains the normal path with that seed
        args.random_seed, args.seeds = args.seeds[0], None
    check_dp(args)
    if args.dp and not join_dp(args):
        return start_dp("kstar_torch.cli.train_0d", argv, args)

    from .. import resolve_device
    from ..config import DT_0D, Schema
    from ..data import ImbalancedSampler, TSDataset, prepare_0d_dataset
    from ..eval import (compute_permute_feature_importance, evaluate,
                        evaluation_figure, plot_feature_importance)
    from ..infer import predict_0d_shot
    from ..models import build_0d_model
    from ..parallel.comm import barrier
    from ..train import (MetricWriter, create_ensemble_state, create_train_state, fit,
                         fit_ensemble, load_checkpoint)
    from ..train.ensemble import local_seeds
    from ..viz import plot_learning_curve, plot_shot_probability, visualize_latent_space
    from .common import (best_member, configs_from_args, draw_figure, ensemble_tag,
                         load_data, make_dp_mesh, make_tag, save_figure, setup_dp)

    mesh = make_dp_mesh(args)
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else resolve_device(args.device)
    train_cfg, loss_cfg, optim_cfg = configs_from_args(args)
    cols = Schema.INPUT_FEATURES
    test_shot = None if args.synthetic else args.test_shot_num

    disrupt_df, ts_df, _ = load_data(args, need_video=False, dt=DT_0D)
    df_train, df_valid, df_test, scaler = prepare_0d_dataset(
        ts_df, cols, scaler=args.scaler, test_shot=test_shot)

    # --train_with_normal: non-disruptive shots already land in the splits
    # (prepare_0d_dataset partitions every shot in the table); the flag turns
    # their zero-window walks into negative-only windows
    mk = lambda df: TSDataset(df, disrupt_df, cols, seq_len=args.seq_len,
                              dist=args.dist, dt=DT_0D, scaler=scaler,
                              include_normal=args.train_with_normal)
    train_ds, valid_ds, test_ds = mk(df_train), mk(df_valid), mk(df_test)
    if main_rank:
        print(f"datasets: train {len(train_ds)} valid {len(valid_ds)} test {len(test_ds)} "
              f"| class counts {train_ds.class_counts().tolist()}")

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    make_model = lambda gen: build_0d_model(args.model, model_config(args, len(cols)),
                                            dtype=dtype, generator=gen)
    steps = max(len(train_ds) // args.batch_size, 1)
    tag = args.tag or make_tag(args.model, args, loss_cfg, train_cfg)
    writer = (MetricWriter(os.path.join(args.save_dir, "tensorboard", tag))
              if main_rank else None)
    sampler = ImbalancedSampler(train_ds.labels) if args.use_sampling else None

    if args.seeds:
        # the seed ensemble: members train on shared batches, then the run
        # goes on with the member of the best valid F1 (under --dp split over
        # the ranks where the count allows)
        ens_tag = ensemble_tag(tag, args)
        ens_mesh = mesh if mesh is not None and len(args.seeds) % args.dp == 0 else None
        states = create_ensemble_state(make_model, args.seeds, optim_cfg,
                                       steps_per_epoch=steps, device=device, mesh=ens_mesh)
        states, hists = fit_ensemble(states, local_seeds(args.seeds, ens_mesh), train_ds,
                                     valid_ds, train_cfg, loss_cfg, tag=ens_tag,
                                     sampler=sampler,
                                     writes=ens_mesh is not None or main_rank)
        best_i, hist = best_member(args.seeds, hists, ens_mesh)
        barrier()
        state = states[0]
        best_path = os.path.join(args.weight_dir,
                                 f"{ens_tag}_seed_{args.seeds[best_i]}_best.ckpt")
    else:
        model = make_model(torch.Generator().manual_seed(args.random_seed)).to(device)
        state = create_train_state(model, optim_cfg, steps_per_epoch=steps,
                                   seed=args.random_seed)
        if args.resume:
            last = os.path.join(args.weight_dir, f"{tag}_last.ckpt")
            if os.path.exists(last):
                state = load_checkpoint(state, last)
                if main_rank:
                    print(f"resumed from {last} at step {int(state.step)}")
        state, _, _ = setup_dp(args, state, mesh)
        state, hist = fit(state, train_ds, valid_ds, train_cfg, loss_cfg, tag=tag,
                          sampler=sampler, writer=writer, mesh=mesh)
        best_path = os.path.join(args.weight_dir, f"{tag}_best.ckpt")
    model = state.model

    # test evaluation + extras run on the BEST checkpoint, not the final
    # epoch (reference train_0D_network.py:393 reloads best before eval)
    if os.path.exists(best_path):
        state = load_checkpoint(state, best_path)

    os.makedirs(args.save_dir, exist_ok=True)
    results = evaluate(model, test_ds, loss_cfg, args.batch_size, args.threshold,
                       save_txt=os.path.join(args.save_dir, f"{tag}_report.txt"), mesh=mesh)
    if not main_rank:
        return results
    lc_path = os.path.join(args.save_dir, f"{tag}_learning_curve.png")
    draw_figure(lc_path, lambda: plot_learning_curve(hist, lc_path))
    print(f"test macro-F1 {results['macro_f1']:.4f} | ROC-AUC {results['roc_auc']:.4f}")
    eval_path = os.path.join(args.save_dir, f"{tag}_eval.png")
    draw_figure(eval_path, lambda: save_figure(evaluation_figure(results), eval_path))

    if not args.skip_extras:
        fi = compute_permute_feature_importance(model, test_ds, loss_cfg,
                                                batch_size=args.batch_size)
        fi_path = os.path.join(args.save_dir, f"{tag}_feature_importance.png")
        draw_figure(fi_path, lambda: plot_feature_importance(fi, fi_path))
        top = sorted(fi.items(), key=lambda kv: -kv[1])[:5]
        print("feature importance (top 5): "
              + ", ".join(f"{Schema.FEATURE_MAP.get(k, k)} {v:.4f}" for k, v in top))
        latent_path = os.path.join(args.save_dir, f"{tag}_latent_2d.png")
        try:
            draw_figure(latent_path, lambda: visualize_latent_space(
                model, test_ds, method="pca", save_path=latent_path))
        except Exception as e:  # noqa: BLE001 — the JAX CLI's best-effort view
            print(f"latent viz skipped: {e}")

        # continuous prob curve on one held-out shot
        shot = int(disrupt_df.shot.values[-1])
        d = ts_df[ts_df.shot == shot]
        if len(d) > args.seq_len + args.dist + 1:
            time_x, probs = predict_0d_shot(
                model, d[cols].to_numpy(np.float32), d["time"].to_numpy(), scaler,
                seq_len=args.seq_len, dist=args.dist, dt=DT_0D,
                batch_size=args.batch_size, device=device)
            print(f"probability curve of shot {shot}: {len(probs)} samples over "
                  f"{time_x[-1]:.2f} s, max {probs.max():.4f}")
            row = disrupt_df[disrupt_df.shot == shot].iloc[0]
            pc_path = os.path.join(args.save_dir, f"{tag}_prob_curve.png")
            draw_figure(pc_path, lambda: plot_shot_probability(
                d, time_x, probs, shot, float(row.tftsrt), float(row.tTQend),
                float(row.tipminf), save_path=pc_path))
    if writer is not None:
        writer.close()
    return results


if __name__ == "__main__":
    main()
