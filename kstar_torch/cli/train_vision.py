"""Vision network training CLI (port of ``kstar_tpu/cli/train_vision.py``,
a rebuild of reference train_vision_network.py): video dataset build ->
ViViT / SlowFast / R2Plus1D -> train/train_DRW -> reload the best
checkpoint -> test macro-F1 and ROC-AUC -> shot-level alarms from
whole-shot sweeps of the test shots (ViViT through the spatial-table
kernel, the conv models through the window-gather kernel) -> the learning
curve and the last test shot's zoomed probability curve.

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.train_vision --model ViViT --synthetic --num_epoch 2
    python -m kstar_torch.cli.train_vision --model SlowFast --bn_splits 2 --synthetic

SlowFast rounds ``--seq_len`` down to a multiple of alpha * tau_fast; the
datasets and the alarm sweep take the rounded length, the checkpoint tag
keeps ``--seq_len`` (as the JAX CLI's does).
With ``--bn_splits`` the SubBatchNorm statistics are aggregated after
every train epoch (``fit(eval_stats_fn=aggregate_batch_stats)``).

Several ``--seeds`` train a seed ensemble (``train/ensemble.py``): one
``{tag}_seed_{s}_{best,last}.ckpt`` pair per seed, then the evaluation and
the alarm sweep go on with the seed of the best valid F1; with
``--bn_splits`` they are refused, as in JAX. Figures go through
``common.draw_figure``: without matplotlib each is skipped with a line that
names its file.

``--dp N`` trains data-parallel over N ranks (``cli/common.py``: spawned
processes on N GPUs, or ``--device cpu``): each rank uploads its rows of
every batch, the steps sum the loss, the gradients and the BatchNorm
statistics over the ranks (``parallel/dp.py``), the test evaluation
gathers the probabilities, and the alarm sweep splits the shots over the
ranks (each sweeps its own through the spatial table or the window
gather); rank 0 alone writes checkpoints, reports and figures. With
``--seeds`` whose count N divides, each rank trains its block of members
on the full batches with no collectives and the best seed is chosen over
all of them (JAX shards the ensemble axis the same way); a count N does
not divide trains every member on every rank, replicated, rank 0 writing
(JAX's single controller runs that ensemble unsharded). ``--bn_splits``
needs the per-rank batch to divide by the split count.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .common import check_dp, join_dp, start_dp


def build_parser() -> argparse.ArgumentParser:
    from .common import add_common_args

    p = argparse.ArgumentParser(description="train vision disruption predictor")
    p.add_argument("--model", type=str, default="ViViT",
                   choices=["ViViT", "SlowFast", "R2Plus1D"])
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="one seed trains with that seed; several train a "
                        "seed ensemble and go on with the best member")
    add_common_args(p, batch_size=64)
    p.add_argument("--image_size", type=int, default=128)
    # augmentation (reference train_vision_network.py:52-63)
    p.add_argument("--bright_val", type=int, default=10)
    p.add_argument("--bright_p", type=float, default=0.25)
    p.add_argument("--contrast_min", type=float, default=1.0)
    p.add_argument("--contrast_max", type=float, default=1.25)
    p.add_argument("--contrast_p", type=float, default=0.25)
    p.add_argument("--blur_k", type=int, default=5)
    p.add_argument("--blur_p", type=float, default=0.25)
    p.add_argument("--flip_p", type=float, default=0.25)
    p.add_argument("--vertical_ratio", type=float, default=0.1)
    p.add_argument("--vertical_p", type=float, default=0.25)
    p.add_argument("--horizontal_ratio", type=float, default=0.1)
    p.add_argument("--horizontal_p", type=float, default=0.25)
    # ViViT hyperparameters (reference :106-114)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--embedd_dropout", type=float, default=0.1)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--d_head", type=int, default=64)
    p.add_argument("--scale_dim", type=int, default=8)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--norm_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="ViViT LayerNorm/softmax accumulation dtype")
    # SlowFast (reference :117-118)
    p.add_argument("--tau_alpha", type=int, default=4)
    p.add_argument("--tau_fast", type=int, default=1)
    p.add_argument("--bn_splits", type=int, default=None,
                   help="SubBatchNorm split count for SlowFast multigrid training "
                        "(reference base_bn_splits; the statistics are aggregated "
                        "after every train epoch)")
    # R2Plus1D
    p.add_argument("--layer_sizes", type=int, nargs=4, default=[1, 2, 2, 1])
    p.add_argument("--skip_extras", action="store_true",
                   help="skip the alarm sweep after the test evaluation")
    return p


def refuse_unsupported(args) -> None:
    """SystemExit for ``--bn_splits`` with an ensemble (as the JAX CLI
    refuses it), for a per-rank batch ``--bn_splits`` does not divide, and
    for a ``--dp`` that cannot run (``common.check_dp``)."""
    if args.bn_splits and args.seeds and len(args.seeds) > 1:
        raise SystemExit("--bn_splits is not supported with the --seeds ensemble "
                         "(stat aggregation is wired into the single-model fit loop)")
    check_dp(args)
    if args.bn_splits and args.dp and (args.batch_size // args.dp) % args.bn_splits:
        raise SystemExit(f"--batch_size {args.batch_size} over --dp {args.dp} ranks "
                         f"is not divisible by --bn_splits {args.bn_splits} per rank")


def model_config(args):
    """(model config, seq_len): SlowFast's seq_len is rounded down to a
    multiple of alpha * tau_fast (at least one), since its slow pathway
    takes every (alpha * tau_fast)-th frame and its lateral concat needs
    matching time axes (reference even-seq fixup,
    train_vision_network.py:153-155)."""
    from ..config import R2Plus1DConfig, SlowFastConfig, ViViTConfig

    seq_len = args.seq_len
    if args.model == "SlowFast":
        step = args.tau_alpha * args.tau_fast
        if seq_len % step != 0:
            seq_len = max(seq_len - seq_len % step, step)
        return SlowFastConfig(image_size=args.image_size, n_frames=seq_len,
                              alpha=args.tau_alpha, tau_fast=args.tau_fast,
                              base_bn_splits=args.bn_splits), seq_len
    if args.model == "R2Plus1D":
        return R2Plus1DConfig(image_size=args.image_size, n_frames=seq_len,
                              layer_sizes=tuple(args.layer_sizes), alpha=0.01), seq_len
    return ViViTConfig(
        image_size=args.image_size, patch_size=args.patch_size,
        n_frames=seq_len, dim=args.dim, depth=args.depth,
        n_heads=args.n_heads, d_head=args.d_head, scale_dim=args.scale_dim,
        dropout=args.dropout, embedd_dropout=args.embedd_dropout,
        norm_dtype=args.norm_dtype), seq_len


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.seeds and len(args.seeds) == 1:
        # a single --seeds value trains the normal path with that seed
        args.random_seed, args.seeds = args.seeds[0], None
    refuse_unsupported(args)
    if args.dp and not join_dp(args):
        return start_dp("kstar_torch.cli.train_vision", argv, args)

    from .. import resolve_device
    from ..config import AugmentConfig
    from ..data import ImbalancedSampler, VideoDataset, split_shots, to_device
    from ..data.augment import make_pre_fns
    from ..eval.evaluate import evaluate
    from ..models import aggregate_batch_stats, build_video_model
    from ..parallel.comm import barrier
    from ..train import (MetricWriter, create_ensemble_state, create_train_state, fit,
                         fit_ensemble, load_checkpoint)
    from ..train.ensemble import local_seeds
    from ..train.loop import default_puts
    from ..viz import plot_learning_curve
    from .common import (best_member, configs_from_args, draw_figure, emit_alarm_artifacts,
                         ensemble_tag, load_data, make_dp_mesh, make_tag,
                         partition_shots, resolve_normal_splits, setup_dp)

    mesh = make_dp_mesh(args)
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else resolve_device(args.device)
    train_cfg, loss_cfg, optim_cfg = configs_from_args(args)
    test_shot = None if args.synthetic else args.test_shot_num

    disrupt_df, ts_df, store = load_data(args, need_video=True)
    shots, normal_s, eval_disrupt_s, eval_normal_s = partition_shots(
        disrupt_df, sorted(store.arrays.keys()))
    train_s, valid_s, test_s = split_shots(shots, test_shot)
    train_n, valid_n, test_n, sweep_normals, inc_normal = resolve_normal_splits(
        args, normal_s, lambda ss: split_shots(ss, None))

    cfg, seq_len = model_config(args)
    if args.bn_splits and args.batch_size % args.bn_splits:
        raise SystemExit(f"--batch_size {args.batch_size} must be "
                         f"divisible by --bn_splits {args.bn_splits}")
    mk = lambda ss: VideoDataset(store, disrupt_df, ss, seq_len=seq_len,
                                 dist=args.dist, include_normal=inc_normal)
    train_ds, valid_ds, test_ds = (mk(list(train_s) + train_n),
                                   mk(list(valid_s) + valid_n),
                                   mk(list(test_s) + test_n))
    if main_rank:
        print(f"datasets: train {len(train_ds)} valid {len(valid_ds)} test {len(test_ds)} "
              f"| class counts {train_ds.class_counts().tolist()}")

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    make_model = lambda gen: build_video_model(args.model, cfg, dtype=dtype, generator=gen)

    aug = AugmentConfig(
        bright_val=args.bright_val, bright_p=args.bright_p,
        contrast_min=args.contrast_min, contrast_max=args.contrast_max,
        contrast_p=args.contrast_p, blur_k=args.blur_k, blur_p=args.blur_p,
        flip_p=args.flip_p, vertical_ratio=args.vertical_ratio,
        vertical_p=args.vertical_p, horizontal_ratio=args.horizontal_ratio,
        horizontal_p=args.horizontal_p)

    crop = min(args.image_size, store.arrays[shots[0]].shape[1])
    # crop/augment/normalize run inside the train/eval steps on the device;
    # the put hook only ships raw uint8 bytes (pinned, non_blocking): on a
    # mesh this rank's rows
    pre_train, pre_eval = make_pre_fns(crop, aug, out_dtype=dtype)
    put_raw = default_puts(device, mesh)[0]

    steps = max(len(train_ds) // args.batch_size, 1)
    tag = args.tag or make_tag(args.model, args, loss_cfg, train_cfg)
    writer = (MetricWriter(os.path.join(args.save_dir, "tensorboard", tag))
              if main_rank else None)
    sampler = ImbalancedSampler(train_ds.labels) if args.use_sampling else None

    if args.seeds:
        # the seed ensemble: members train on shared batches (each member
        # augments with its own draws), then the run goes on with the member
        # of the best valid F1. Under --dp the members split over the ranks
        # where they can (each on the full batches), else every rank holds
        # them all and rank 0 writes
        ens_tag = ensemble_tag(tag, args)
        ens_mesh = mesh if mesh is not None and len(args.seeds) % args.dp == 0 else None
        mine = local_seeds(args.seeds, ens_mesh)
        states = create_ensemble_state(make_model, args.seeds, optim_cfg,
                                       steps_per_epoch=steps, device=device, mesh=ens_mesh)
        states, hists = fit_ensemble(states, mine, train_ds, valid_ds,
                                     train_cfg, loss_cfg, tag=ens_tag, sampler=sampler,
                                     put=lambda bl: to_device(bl, device), pre_fn=pre_train,
                                     pre_fn_eval=pre_eval,
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
                          sampler=sampler, writer=writer, put=put_raw,
                          put_eval=put_raw, pre_fn=pre_train, pre_fn_eval=pre_eval,
                          eval_stats_fn=aggregate_batch_stats if args.bn_splits else None,
                          mesh=mesh)
        best_path = os.path.join(args.weight_dir, f"{tag}_best.ckpt")
    model = state.model
    lc_path = os.path.join(args.save_dir, f"{tag}_learning_curve.png")
    if main_rank:
        draw_figure(lc_path, lambda: plot_learning_curve(hist, lc_path))

    # test evaluation + extras run on the BEST checkpoint, not the final
    # epoch (reference train_vision_network.py:393 reloads best before eval)
    if os.path.exists(best_path):
        state = load_checkpoint(state, best_path)

    os.makedirs(args.save_dir, exist_ok=True)
    results = evaluate(model, test_ds, loss_cfg, args.batch_size, args.threshold,
                       save_txt=os.path.join(args.save_dir, f"{tag}_report.txt"),
                       put=put_raw, pre_fn=pre_eval, mesh=mesh)
    if main_rank:
        print(f"test macro-F1 {results['macro_f1']:.4f} | ROC-AUC {results['roc_auc']:.4f}")

    curves = []
    if not args.skip_extras:
        # shot-level alarm scoring over the test shots; normal shots join the
        # sweep as the false-alarm population (under --train_with_normal
        # only the held-out test normals)
        try:
            curves = emit_alarm_artifacts(
                model, store, disrupt_df,
                list(test_s) + list(eval_disrupt_s) + list(sweep_normals)
                + list(eval_normal_s),
                seq_len=seq_len, dist=args.dist, crop=crop,
                batch_size=args.batch_size, dtype=dtype,
                threshold=args.threshold, save_dir=args.save_dir, tag=tag,
                min_dwell_s=args.alarm_dwell_s, device=device, mesh=mesh)
        except Exception as e:  # noqa: BLE001 — the JAX CLI's best-effort extras
            print(f"alarm evaluation skipped: {type(e).__name__}: {e}")
    if not args.skip_extras and main_rank:
        from ..infer import predict_video_shot
        from ..viz import plot_shot_probability_zoom

        shot = test_s[-1] if test_s else shots[-1]
        row = disrupt_df[disrupt_df.shot == shot].iloc[0]
        # the alarm block already swept this shot (sweep_prob_curves pads and
        # suppresses as predict_video_shot does): reuse its curve instead of
        # a second whole-shot sweep
        held = [(tx, p) for s, _, tx, p in curves if s == int(shot)]
        if held:
            time_x, probs_c = held[0]
        else:
            time_x, probs_c = predict_video_shot(
                model, np.asarray(store.arrays[shot]), int(row.frame_startup),
                int(row.frame_cutoff), seq_len=seq_len, dist=args.dist,
                crop_size=crop, batch_size=args.batch_size, compute_dtype=dtype,
                device=device)
        pc_path = os.path.join(args.save_dir, f"{tag}_prob_curve.png")
        draw_figure(pc_path, lambda: plot_shot_probability_zoom(
            time_x, probs_c, shot, float(row.tftsrt), float(row.tTQend),
            float(row.tipminf), args.dist / 210.0, save_path=pc_path))
    if writer is not None:
        writer.close()
    return results


if __name__ == "__main__":
    main()
