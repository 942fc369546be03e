"""Model architecture summary CLI (port of ``kstar_tpu/cli/model_summary.py``,
a rebuild of reference plot_model_structure.py): the module tree with output
shapes and parameter counts, from one f32 forward of zero inputs.

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.model_summary --model ViViT
    python -m kstar_torch.cli.model_summary --model MLSTM_FCN --out summary.txt
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="print a model's module tree")
    p.add_argument("--model", type=str, default="ViViT",
                   choices=["ViViT", "R2Plus1D", "SlowFast", "Transformer",
                            "CnnLSTM", "MLSTM_FCN", "concat", "TFN"])
    p.add_argument("--seq_len", type=int, default=21)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--n_features", type=int, default=18)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--graph", type=str, default=None,
                   help="also render the module hierarchy as a PNG diagram "
                        "(the reference's torchviz/hiddenlayer graph, "
                        "plot_model_structure.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the GPU)")
    args = p.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..config import (CnnLSTMConfig, MLSTMFCNConfig, R2Plus1DConfig,
                          SlowFastConfig, TransformerConfig, ViViTConfig)
    from ..models import TFN, MultiModalConcat, build_0d_model, build_video_model
    from ..utils import model_summary, render_model_graph

    device = resolve_device(args.device)
    L, H, F = args.seq_len, args.image_size, args.n_features
    gen = torch.Generator().manual_seed(0)
    video = torch.zeros((1, L, H, H, 3))
    ts = torch.zeros((1, L, F))

    if args.model in ("ViViT", "R2Plus1D", "SlowFast"):
        cfgs = {"ViViT": ViViTConfig(image_size=H, n_frames=L),
                "R2Plus1D": R2Plus1DConfig(image_size=H, n_frames=L),
                "SlowFast": SlowFastConfig(image_size=H, n_frames=L - L % 4)}
        model = build_video_model(args.model, cfgs[args.model], generator=gen)
        sample = (video if args.model != "SlowFast"
                  else torch.zeros((1, L - L % 4, H, H, 3)),)
    elif args.model in ("Transformer", "CnnLSTM", "MLSTM_FCN"):
        cfgs = {"Transformer": TransformerConfig(n_features=F, max_len=L),
                "CnnLSTM": CnnLSTMConfig(seq_len=L, n_features=F),
                "MLSTM_FCN": MLSTMFCNConfig(seq_len=L, n_features=F)}
        model = build_0d_model(args.model, cfgs[args.model], generator=gen)
        sample = (ts,)
    else:
        vk = dict(image_size=H, patch_size=16, n_frames=L, dim=128, depth=2,
                  n_heads=4, d_head=64, scale_dim=4)
        tk = dict(n_features=F, feature_dims=128, max_len=L, n_layers=4,
                  n_heads=8, dim_feedforward=512)
        cls = MultiModalConcat if args.model == "concat" else TFN
        model = cls(vk, tk, generator=gen)
        sample = (video, ts)

    text = model_summary(model.to(device), *sample, save_path=args.out, depth=args.depth)
    print(text)
    if args.graph:
        render_model_graph(model, save_path=args.graph, depth=args.depth)
        print(f"module graph rendered to {args.graph}")
    return text


if __name__ == "__main__":
    main()
