"""Latency/throughput CLI (port of ``kstar_tpu/cli/compute_time.py``, a
rebuild of reference compute_time.py + analysis/compute_time_multimodal.py):
reference-style mean/std of n timed forwards at the reference shapes — 0D
models (B, 21, 18), the video models (B, 21, 128, 128, 3) (SlowFast at
21 - 21 % 4 = 20 frames), multimodal both — plus batched clips/s, in bf16
with random weights from seed 0.

Each timed forward ends in a synchronise (``infer/latency.py``); the two
warm-up forwards per shape are excluded. cuDNN's autotuner is off
(``torch.backends.cudnn.benchmark`` False, PyTorch's default), so no
algorithm search runs at a new shape; the warm-up covers the lazy set-up of
the first calls (cuBLAS and cuDNN handles, workspaces).

Usage (the GPU by default; ``--device cpu`` runs on the CPU):
    python -m kstar_torch.cli.compute_time --models ViViT Transformer --n_samples 16
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="model latency harness")
    p.add_argument("--models", nargs="+",
                   default=["ViViT", "R2Plus1D", "SlowFast", "Transformer",
                            "CnnLSTM", "MLSTM_FCN", "multimodal"])
    p.add_argument("--n_samples", type=int, default=16)
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 64])
    p.add_argument("--seq_len", type=int, default=21)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--n_features", type=int, default=18)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the GPU)")
    args = p.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..config import (CnnLSTMConfig, MLSTMFCNConfig, R2Plus1DConfig,
                          SlowFastConfig, TransformerConfig, ViViTConfig)
    from ..infer.latency import measure_model
    from ..models import MultiModalConcat, build_0d_model, build_video_model

    device = resolve_device(args.device)
    L, H, F = args.seq_len, args.image_size, args.n_features
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    results = {}

    def bench_one(name, model, make_args):
        for B in args.batch_sizes:
            stats = measure_model(model, make_args(B), n_samples=args.n_samples,
                                  device=device)
            results[f"{name}_b{B}"] = stats
            print(f"{name:12s} B={B:<4d} mean {stats['mean_s']*1e3:8.2f} ms  "
                  f"p50 {stats['p50_s']*1e3:8.2f} ms  {stats['clips_per_s']:10.1f} clips/s")
        del model

    video_shape = lambda B: (torch.zeros((B, L, H, H, 3), dtype=bf16),)
    ts_shape = lambda B: (torch.zeros((B, L, F)),)

    for name in args.models:
        if name == "ViViT":
            bench_one(name, build_video_model(name, ViViTConfig(image_size=H, n_frames=L),
                                              dtype=bf16, generator=gen), video_shape)
        elif name == "R2Plus1D":
            bench_one(name, build_video_model(name, R2Plus1DConfig(image_size=H, n_frames=L),
                                              dtype=bf16, generator=gen), video_shape)
        elif name == "SlowFast":
            Ls = L - L % 4
            bench_one(name, build_video_model(name, SlowFastConfig(image_size=H, n_frames=Ls),
                                              dtype=bf16, generator=gen),
                      lambda B: (torch.zeros((B, Ls, H, H, 3), dtype=bf16),))
        elif name == "Transformer":
            bench_one(name, build_0d_model(name, TransformerConfig(n_features=F, max_len=L),
                                           dtype=bf16, generator=gen), ts_shape)
        elif name == "CnnLSTM":
            bench_one(name, build_0d_model(name, CnnLSTMConfig(seq_len=L, n_features=F),
                                           dtype=bf16, generator=gen), ts_shape)
        elif name == "MLSTM_FCN":
            bench_one(name, build_0d_model(name, MLSTMFCNConfig(seq_len=L, n_features=F),
                                           dtype=bf16, generator=gen), ts_shape)
        elif name == "multimodal":
            vk = dict(image_size=H, patch_size=16, n_frames=L, dim=128, depth=2,
                      n_heads=4, d_head=64, scale_dim=4)
            tk = dict(n_features=F, feature_dims=128, max_len=L, n_layers=4,
                      n_heads=8, dim_feedforward=512)
            bench_one(name, MultiModalConcat(vk, tk, dtype=bf16, generator=gen),
                      lambda B: (torch.zeros((B, L, H, H, 3), dtype=bf16),
                                 torch.zeros((B, L, F))))
        else:
            raise SystemExit(f"unknown model: {name}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
