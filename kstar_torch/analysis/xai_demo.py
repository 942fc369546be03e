"""XAI demo through the port: Grad-CAM of R(2+1)D and ViViT attention
rollout on one shot.

    python -m kstar_torch.analysis.xai_demo --synthetic [--device cpu]

The port's twin of ``analysis/xai_demo.py``: the first shot of the data
(``cli/common.py load_data``), the ``--seq_len`` frames before its current
quench cropped to ``--image_size`` and less the BGR mean; an R(2+1)D with
layer sizes (1, 1, 1, 1) and a ViViT (dim 32, depth 2, 2 heads x 16, patch
a quarter of the crop), both initialised from the port's seeded init
(generator seed 0; JAX's keys give other weights), in f32 on ``--device``
(the GPU unless ``cpu``); Grad-CAM (``viz.gradcam_r2plus1d``, the middle
frame overlaid by ``overlay_cam``) and the spatial and temporal rollouts
(``viz.vivit_attention_rollout``). The four-panel figure goes through
``draw_figure`` (a skip line where matplotlib is missing) into
``results/torch/xai`` by default.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def xai_figure(clip_u8, over, space, temporal, L: int, path: str):
    """Frame, Grad-CAM overlay, spatial and temporal rollout (JAX's figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    axes[0].imshow(clip_u8[L // 2][..., ::-1])
    axes[0].set_title("frame")
    axes[1].imshow(over[..., ::-1])
    axes[1].set_title("Grad-CAM (R2+1D)")
    sp = space.reshape(-1, space.shape[-2], space.shape[-1])
    axes[2].imshow(sp[min(L // 2, len(sp) - 1)], cmap="inferno")
    axes[2].set_title("ViViT spatial rollout")
    axes[3].bar(range(temporal.shape[-1]), temporal[0])
    axes[3].set_title("ViViT temporal rollout")
    for ax in axes[:3]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    return fig


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", type=str, default="./dataset")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--save_dir", type=str, default="./results/torch/xai")
    p.add_argument("--seq_len", type=int, default=8)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..cli.common import draw_figure, load_data
    from ..config import PIXEL_MEAN_BGR
    from ..models import R2Plus1DClassifier, ViViT
    from ..viz import gradcam_r2plus1d, overlay_cam, vivit_attention_rollout

    device = resolve_device(args.device)
    ns = argparse.Namespace(synthetic=args.synthetic, data_root=args.data_root,
                            random_seed=42)
    disrupt_df, _, store = load_data(ns, need_video=True)
    shot = sorted(store.arrays)[0]
    row = disrupt_df[disrupt_df.shot == shot].iloc[0]
    frames = np.asarray(store.arrays[shot])
    H = min(args.image_size, frames.shape[1])
    L = args.seq_len

    # the window that ends right before the quench
    end = int(row.frame_tipminf)
    clip_u8 = frames[end - L:end, :H, :H, :]
    clip = torch.from_numpy((clip_u8.astype(np.float32) - np.asarray(PIXEL_MEAN_BGR))[None])
    os.makedirs(args.save_dir, exist_ok=True)

    r2 = R2Plus1DClassifier(image_size=H, n_frames=L, layer_sizes=(1, 1, 1, 1),
                            generator=torch.Generator().manual_seed(0))
    cam = gradcam_r2plus1d(r2, clip, target_class=0, device=device)
    over = overlay_cam(clip_u8[len(clip_u8) // 2], cam[0, cam.shape[1] // 2])

    vv = ViViT(image_size=H, patch_size=H // 4, n_frames=L, dim=32, depth=2, n_heads=2,
               d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0,
               generator=torch.Generator().manual_seed(0))
    space = vivit_attention_rollout(vv, clip, "space", device=device)
    temporal = vivit_attention_rollout(vv, clip, "temporal", device=device)

    out = os.path.join(args.save_dir, f"xai_shot_{shot}.png")
    if draw_figure(out, lambda: xai_figure(clip_u8, over, space, temporal, L, out)) is not None:
        print(f"wrote {out}")
    return {"shot": int(shot), "gradcam": cam, "space": space, "temporal": temporal}


if __name__ == "__main__":
    main()
