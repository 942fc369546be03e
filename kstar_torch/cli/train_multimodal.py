"""Multimodal training CLI (port of ``kstar_tpu/cli/train_multimodal.py``, a
rebuild of reference train_multimodal.py): paired video + 0D dataset ->
{concat, TFN} x use_GB -> optional CCA pre-training -> train/train_DRW or
train_GB(_dynamic) with last and best checkpoints -> reload the best
checkpoint -> test macro-F1 and ROC-AUC -> shot-level alarms from whole-shot
multimodal sweeps of the test shots (the spatial-table kernel builds each
shot's video table on the GPU) -> the learning curve, the last test shot's
probability curve and the fusion/video/0D latent views.

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.train_multimodal --model_type concat --synthetic
    python -m kstar_torch.cli.train_multimodal --model_type TFN --use_GB --gb_dynamic

Refused: several ``--seeds`` at once (the JAX package has no multimodal
ensemble; this option is the port's own). Figures go through
``common.draw_figure``: without matplotlib each is skipped with a line that
names its file.

``--dp N`` trains data-parallel over N ranks as ``train_vision`` does
(``cli/common.py``, ``parallel/dp.py``), ``--use_GB`` too (``fit_gb`` and
the probe copies of ``gb_estimate`` run the data-parallel steps), and
``--use_cca_pretrain`` all-gathers both encodings before the CCA loss,
whose covariances run over the batch. The test evaluation gathers the
probabilities; rank 0 alone writes and runs the extras (the multimodal
alarm sweep, the probability curve and the latent views), one-device
computations as in JAX, whose multimodal sweeper takes no mesh.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .common import check_dp, join_dp, start_dp

NO_ENSEMBLE = ("--seeds with more than one seed is refused: the JAX package has no "
               "multimodal ensemble (its train_multimodal has no --seeds)")


def build_parser() -> argparse.ArgumentParser:
    from .common import add_common_args

    p = argparse.ArgumentParser(description="train multimodal disruption predictor")
    p.add_argument("--model_type", type=str, default="concat", choices=["concat", "TFN"])
    p.add_argument("--use_GB", action="store_true")
    p.add_argument("--gb_dynamic", action="store_true")
    p.add_argument("--epoch_per_GB_estimate", type=int, default=16)
    p.add_argument("--n_epochs_GB_estimate", type=int, default=4)
    p.add_argument("--w_vis", type=float, default=0.1)
    p.add_argument("--w_0D", type=float, default=0.4)
    p.add_argument("--w_multi", type=float, default=0.5)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="one seed trains with that seed; several are refused "
                        "(the JAX package has no multimodal ensemble)")
    add_common_args(p, batch_size=32)
    p.add_argument("--tau", type=int, default=1)
    p.add_argument("--synthetic_dt", type=float, default=4.0 / 210.0,
                   help="ts-table period for --synthetic runs; the default "
                        "keeps smoke runs small, pass 1/210 (the reference's "
                        "5ms multimodal table period) for time-axis-correct "
                        "whole-shot sweeps/alarm artifacts")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--d_head", type=int, default=64)
    p.add_argument("--scale_dim", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--feature_dims", type=int, default=128)
    p.add_argument("--ts_layers", type=int, default=4)
    p.add_argument("--ts_heads", type=int, default=8)
    p.add_argument("--dim_feedforward", type=int, default=512)
    p.add_argument("--use_cca_pretrain", action="store_true")
    p.add_argument("--skip_extras", action="store_true",
                   help="skip the alarm sweep after the test evaluation")
    p.add_argument("--pair_mode", choices=("reference", "aligned"),
                   default="reference",
                   help="video<->0D window pairing after the t_disrupt filter: "
                        "'reference' reproduces the reference's shifted "
                        "re-pairing (src/dataset.py:639-652); 'aligned' drops "
                        "filtered entries as pairs (data/windows.py "
                        "multimodal_windows)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.seeds and len(args.seeds) == 1:
        # a single --seeds value trains the normal path with that seed
        args.random_seed, args.seeds = args.seeds[0], None
    if args.seeds:
        raise SystemExit(NO_ENSEMBLE)
    check_dp(args)
    if args.dp and not join_dp(args):
        return start_dp("kstar_torch.cli.train_multimodal", argv, args)

    from .. import resolve_device
    from ..config import DT_MULTI, AugmentConfig, Schema
    from ..data import (DevicePreprocessor, ImbalancedSampler, MultiModalDataset,
                        Scaler, random_split_shots)
    from ..data.augment import make_pre_fns
    from ..eval.evaluate import evaluate_probs, format_report
    from ..losses import ldam_margins
    from ..models import TFN, TFNGB, MultiModalConcat, MultiModalGB
    from ..train import (MetricWriter, create_train_state, fit, load_checkpoint)
    from ..train.gb import fit_gb
    from ..train.loop import default_puts, make_eval_step, run_eval_epoch
    from ..viz import plot_learning_curve
    from .common import (configs_from_args, draw_figure, load_data, make_dp_mesh,
                         make_tag, partition_shots, resolve_normal_splits,
                         setup_dp, write_alarm_artifacts)

    mesh = make_dp_mesh(args)
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else resolve_device(args.device)
    train_cfg, loss_cfg, optim_cfg = configs_from_args(args)
    cols = Schema.INPUT_FEATURES
    test_shot = None if args.synthetic else args.test_shot_num
    dt = DT_MULTI if not args.synthetic else args.synthetic_dt

    disrupt_df, ts_df, store = load_data(args, need_video=True, dt=dt)
    shots, normal_s, eval_disrupt_s, eval_normal_s = partition_shots(
        disrupt_df, sorted(store.arrays.keys()))
    # seeded random split (reference preparing_multi_data, utility.py:121-172)
    train_s, valid_s, test_s = random_split_shots(shots, test_shot, seed=42)
    train_n, valid_n, test_n, sweep_normals, inc_normal = resolve_normal_splits(
        args, normal_s, lambda ss: random_split_shots(ss, None, seed=42))

    scaler = Scaler(args.scaler)
    df_train = ts_df[ts_df.shot.isin(list(train_s) + train_n)]
    scaler.fit(df_train[cols].values)

    mk = lambda ss: MultiModalDataset(store, ts_df, disrupt_df, cols, ss,
                                      seq_len=args.seq_len, dist=args.dist,
                                      dt=dt, tau=args.tau, scaler=scaler,
                                      pair_mode=args.pair_mode,
                                      include_normal=inc_normal)
    train_ds, valid_ds, test_ds = (mk(list(train_s) + train_n),
                                   mk(list(valid_s) + valid_n),
                                   mk(list(test_s) + test_n))
    if main_rank:
        print(f"datasets: train {len(train_ds)} valid {len(valid_ds)} test {len(test_ds)} "
              f"| class counts {train_ds.class_counts().tolist()}")

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    crop = min(args.image_size, store.arrays[shots[0]].shape[1])
    vivit_kw = dict(image_size=crop, patch_size=args.patch_size, n_frames=args.seq_len,
                    dim=args.dim, depth=args.depth, n_heads=args.n_heads,
                    d_head=args.d_head, scale_dim=args.scale_dim,
                    dropout=args.dropout, embedd_dropout=args.dropout)
    ts_kw = dict(n_features=len(cols), feature_dims=args.feature_dims,
                 max_len=args.seq_len, n_layers=args.ts_layers,
                 n_heads=args.ts_heads, dim_feedforward=args.dim_feedforward,
                 dropout=args.dropout, cls_dims=128)
    if args.model_type == "concat":
        cls = MultiModalGB if args.use_GB else MultiModalConcat
    else:
        cls = TFNGB if args.use_GB else TFN
    init = torch.Generator().manual_seed(args.random_seed)
    model = cls(vivit_kw, ts_kw, dtype=dtype, generator=init).to(device)

    # crop/augment/normalize run inside the train/eval steps on the device;
    # the put hook only ships the raw uint8 video and the float 0D block (on
    # a mesh, this rank's rows)
    pre_train, pre_eval = make_pre_fns(crop, AugmentConfig(), out_dtype=dtype)
    put_raw = default_puts(device, mesh)[0]

    steps = max(len(train_ds) // args.batch_size, 1)
    state = create_train_state(model, optim_cfg, steps_per_epoch=steps,
                               seed=args.random_seed)

    name = f"{args.model_type}{'_GB' if args.use_GB else ''}"
    tag = args.tag or make_tag(name, args, loss_cfg, train_cfg)
    if args.resume:
        last = os.path.join(args.weight_dir, f"{tag}_last.ckpt")
        if os.path.exists(last):
            state = load_checkpoint(state, last)
            if main_rank:
                print(f"resumed from {last} at step {int(state.step)}")
    state, _, _ = setup_dp(args, state, mesh)
    writer = (MetricWriter(os.path.join(args.save_dir, "tensorboard", tag))
              if main_rank else None)
    sampler = ImbalancedSampler(train_ds.labels) if args.use_sampling else None

    if args.use_cca_pretrain and not args.use_GB:
        from ..train.cca import train_cca
        put_train = DevicePreprocessor(crop, AugmentConfig(), train=True,
                                       out_dtype=dtype, seed=args.random_seed,
                                       device=device, mesh=mesh)
        state, cca_losses = train_cca(state, train_ds, batch_size=args.batch_size,
                                      n_epochs=4, put=put_train, mesh=mesh)
        if main_rank:
            print(f"CCA pretrain losses: {[round(l, 3) for l in cca_losses]}")

    if args.use_GB:
        gb0 = {"video": args.w_vis, "0D": args.w_0D, "multi": args.w_multi}
        state, hist, gb_w = fit_gb(state, train_ds, valid_ds, train_cfg, loss_cfg,
                                   tag=tag, gb_weights=gb0, dynamic=args.gb_dynamic,
                                   epoch_per_gb_estimate=args.epoch_per_GB_estimate,
                                   n_epochs_gb_estimate=args.n_epochs_GB_estimate,
                                   sampler=sampler, writer=writer, put=put_raw,
                                   pre_fn=pre_train, pre_fn_eval=pre_eval, mesh=mesh)
        if main_rank:
            print(f"final GB weights: {gb_w}")
        model_type = "multi-GB"
    else:
        state, hist = fit(state, train_ds, valid_ds, train_cfg, loss_cfg,
                          model_type="multi", tag=tag, sampler=sampler,
                          writer=writer, put=put_raw, put_eval=put_raw,
                          pre_fn=pre_train, pre_fn_eval=pre_eval, mesh=mesh)
        model_type = "multi"
    lc_path = os.path.join(args.save_dir, f"{tag}_learning_curve.png")
    if main_rank:
        draw_figure(lc_path, lambda: plot_learning_curve(hist, lc_path))

    # test evaluation + extras run on the BEST checkpoint, not the final
    # epoch (reference train_multimodal.py:464 reloads best before eval)
    best_path = os.path.join(args.weight_dir, f"{tag}_best.ckpt")
    if os.path.exists(best_path):
        state = load_checkpoint(state, best_path)

    put_eval = DevicePreprocessor(crop, AugmentConfig(), train=False, out_dtype=dtype,
                                  device=device, mesh=mesh)
    eval_step = make_eval_step(loss_cfg, model_type=model_type, mesh=mesh)
    counts = test_ds.class_counts()
    w = torch.ones(2, device=device)
    m = torch.as_tensor(ldam_margins(counts, loss_cfg.ldam_max_m)).to(device)
    gb = torch.tensor([0.0, 0.0, 1.0], device=device)
    _, _, _, (probs, labels) = run_eval_epoch(eval_step, model, test_ds, args.batch_size,
                                              w, m, put=put_eval, collect_probs=True,
                                              gb_w=gb, mesh=mesh)
    results = evaluate_probs(probs, labels, args.threshold)
    if not main_rank:
        return results
    if mesh is not None:
        # the extras below are one-device computations on rank 0
        put_eval = DevicePreprocessor(crop, AugmentConfig(), train=False, out_dtype=dtype,
                                      device=device)
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, f"{tag}_report.txt"), "w") as f:
        f.write(format_report(results))
    print(f"test macro-F1 {results['macro_f1']:.4f} | ROC-AUC {results['roc_auc']:.4f}")

    if not args.skip_extras and test_s:
        # shot-level alarm scoring over the test shots; normal shots join the
        # sweep as the false-alarm population (under --train_with_normal
        # only the held-out test normals)
        curves = []
        try:
            from ..eval import sweep_multimodal_prob_curves

            curves = sweep_multimodal_prob_curves(
                model, store, ts_df, disrupt_df,
                list(test_s) + list(eval_disrupt_s) + list(sweep_normals)
                + list(eval_normal_s),
                cols, scaler, seq_len=args.seq_len, dist=args.dist, dt=dt,
                tau=args.tau, crop_size=crop, batch_size=args.batch_size,
                compute_dtype=dtype, device=device)
            write_alarm_artifacts(curves, args.threshold, args.save_dir, tag,
                                  min_dwell_s=args.alarm_dwell_s)
        except Exception as e:  # noqa: BLE001 — the JAX CLI's best-effort extras
            print(f"alarm evaluation skipped: {type(e).__name__}: {e}")

        from ..infer import predict_multimodal_shot
        from ..viz import plot_shot_probability, visualize_latent_space_multi

        shot = test_s[-1]
        row = disrupt_df[disrupt_df.shot == shot].iloc[0]
        d = ts_df[ts_df.shot == shot]
        # the alarm block already swept this shot: reuse its curve instead
        # of a second whole-shot sweep
        held = [(tx, p) for s, _, tx, p in curves if s == int(shot)]
        if held:
            time_x, probs_c = held[0]
        else:
            time_x, probs_c = predict_multimodal_shot(
                model, np.asarray(store.arrays[shot]), d[cols].to_numpy(np.float32),
                d["time"].to_numpy(), scaler, int(row.frame_startup),
                int(row.frame_cutoff), float(row.tftsrt), float(row.tipminf),
                seq_len=args.seq_len, dist=args.dist, dt=dt, tau=args.tau,
                crop_size=crop, batch_size=args.batch_size, compute_dtype=dtype,
                device=device)
        if len(time_x):
            pc_path = os.path.join(args.save_dir, f"{tag}_prob_curve.png")
            draw_figure(pc_path, lambda: plot_shot_probability(
                d, time_x, probs_c, shot, float(row.tftsrt), float(row.tTQend),
                float(row.tipminf), save_path=pc_path))
        latent_path = os.path.join(args.save_dir, f"{tag}_latent_multi.png")
        try:
            draw_figure(latent_path, lambda: visualize_latent_space_multi(
                model, test_ds, method="pca", put=put_eval, save_path=latent_path))
        except Exception as e:  # noqa: BLE001 — the JAX CLI's best-effort view
            print(f"latent viz skipped: {e}")
    writer.close()
    return results


if __name__ == "__main__":
    main()
