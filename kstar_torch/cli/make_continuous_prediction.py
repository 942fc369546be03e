"""Real-time continuous prediction + GIF CLI (port of
``kstar_tpu/cli/make_continuous_prediction.py``, a rebuild of reference
make_continuous_prediction.py): load trained video + 0D checkpoints, sweep
one whole shot (the ViViT sweep builds its spatial-cls table with the
spatial-table kernel on the GPU), print the alarm time and warning margin,
and render the probability figures and the side-by-side camera/probability
animation.

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.make_continuous_prediction --synthetic --shot 30009
    python -m kstar_torch.cli.make_continuous_prediction --synthetic --video_tag <tag>

The ViViT is built at ``--image_size`` with ``patch_size = min(--patch_size,
crop // 4)``, as train_vision builds it, so a ``train_vision`` checkpoint
loads; its positional table covers the ``--image_size`` frame and the sweep
reads the crop's share of it. (The JAX CLI builds it at the crop, and its
checkpoint loader does not check shapes; ``load_state_dict`` does.)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    from .common import add_common_args

    p = argparse.ArgumentParser(description="continuous disruption prediction demo")
    p.add_argument("--shot", type=int, default=21310)
    p.add_argument("--video_tag", type=str, default=None,
                   help="checkpoint tag of the trained ViViT (optional)")
    p.add_argument("--ts_tag", type=str, default=None,
                   help="checkpoint tag of the trained 0D Transformer (optional)")
    add_common_args(p, batch_size=64)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--d_head", type=int, default=64)
    p.add_argument("--scale_dim", type=int, default=8)
    p.add_argument("--feature_dims", type=int, default=128)
    p.add_argument("--gif", action="store_true", default=True)
    return p


def main(argv=None):
    """Returns {"shot", "video": (time_x, probs), "0D": (time_x, probs) or
    None, "alarm_s", "warning_s"}."""
    args = build_parser().parse_args(argv)

    from .. import resolve_device
    from ..config import DT_0D, Schema, TransformerConfig, ViViTConfig
    from ..data.splits import Scaler
    from ..infer import alarm_times, predict_0d_shot, predict_video_shot, warning_time
    from ..models import build_0d_model, build_video_model
    from ..train import load_params
    from ..viz import (plot_shot_probability, plot_shot_probability_zoom,
                       render_realtime_gif)
    from .common import draw_figure, load_data

    device = resolve_device(args.device)
    disrupt_df, ts_df, store = load_data(args, need_video=True, dt=DT_0D)
    shot = args.shot if args.shot in store.arrays else sorted(store.arrays)[-1]
    row = disrupt_df[disrupt_df.shot == shot].iloc[0]
    frames = np.asarray(store.arrays[shot])
    cols = Schema.INPUT_FEATURES

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    crop = min(args.image_size, frames.shape[1])
    init = torch.Generator().manual_seed(args.random_seed)

    # --- video model sweep ---------------------------------------------------
    vcfg = ViViTConfig(image_size=args.image_size,
                       patch_size=min(args.patch_size, crop // 4),
                       n_frames=args.seq_len, dim=args.dim, depth=args.depth,
                       n_heads=args.n_heads, d_head=args.d_head,
                       scale_dim=args.scale_dim)
    vmodel = build_video_model("ViViT", vcfg, dtype=dtype, generator=init).to(device)
    if args.video_tag:
        load_params(vmodel, os.path.join(args.weight_dir, f"{args.video_tag}_best.ckpt"))

    t_vid, p_vid = predict_video_shot(
        vmodel, frames, int(row.frame_startup), int(row.frame_cutoff),
        seq_len=args.seq_len, dist=args.dist, crop_size=crop,
        batch_size=args.batch_size, compute_dtype=dtype, device=device)

    t_alarm = alarm_times(t_vid, p_vid, args.threshold,
                          min_dwell_s=args.alarm_dwell_s)
    t_warn = warning_time(t_alarm, float(row.tipminf))
    print(f"shot {shot} | video alarm at {t_alarm} s | warning margin "
          f"{t_warn if t_warn is None else round(t_warn, 4)} s")

    os.makedirs(args.save_dir, exist_ok=True)
    marks = (float(row.tftsrt), float(row.tTQend), float(row.tipminf))
    # --- 0D model sweep (skipped on video-only datasets: load_data returns
    # ts_df=None when no 0D csv exists) -----------------------------------
    curve_0d = None
    d = ts_df[ts_df.shot == shot] if ts_df is not None else None
    if d is not None and len(d) > args.seq_len + args.dist + 1:
        tcfg = TransformerConfig(n_features=len(cols), feature_dims=args.feature_dims,
                                 max_len=args.seq_len)
        tmodel = build_0d_model("Transformer", tcfg, dtype=dtype, generator=init).to(device)
        if args.ts_tag:
            load_params(tmodel, os.path.join(args.weight_dir, f"{args.ts_tag}_best.ckpt"))
        # a fresh scaler, refit on the shot by predict_0d_shot (as JAX's)
        t_0d, p_0d = predict_0d_shot(
            tmodel, d[cols].to_numpy(np.float32), d["time"].to_numpy(),
            Scaler(args.scaler), seq_len=args.seq_len, dist=args.dist, dt=DT_0D,
            device=device)
        curve_0d = (t_0d, p_0d)
        path = os.path.join(args.save_dir, f"prob_0D_{shot}.png")
        draw_figure(path, lambda: plot_shot_probability(d, t_0d, p_0d, shot, *marks,
                                                        save_path=path))
        if args.gif:
            # 0D real-time animation (reference generate_real_time_experiment_0D,
            # src/visualization/visualize_application.py:354-527)
            path0 = os.path.join(args.save_dir,
                                 f"real_time_disruption_prediction_0D_{shot}.gif")
            draw_figure(path0, lambda: render_realtime_gif(
                frames, t_0d, p_0d, shot, float(row.tipminf), save_path=path0))

    # --- figures + GIF -------------------------------------------------------
    path = os.path.join(args.save_dir, f"prob_video_{shot}.png")
    if d is not None and len(d):
        draw_figure(path, lambda: plot_shot_probability(d, t_vid, p_vid, shot, *marks,
                                                        save_path=path))
    else:
        draw_figure(path, lambda: plot_shot_probability_zoom(
            t_vid, p_vid, shot, *marks, args.dist / 210.0, save_path=path))
    if args.gif:
        gif = os.path.join(args.save_dir, f"real_time_disruption_prediction_{shot}.gif")
        if draw_figure(gif, lambda: render_realtime_gif(
                frames, t_vid, p_vid, shot, float(row.tipminf), save_path=gif)):
            print(f"wrote {gif}")
    return {"shot": shot, "video": (t_vid, p_vid), "0D": curve_0d,
            "alarm_s": t_alarm, "warning_s": t_warn}


if __name__ == "__main__":
    main()
