"""Operation and byte counts of the TFN-GB configuration, from its shapes.

K1's table and the patch embedding are the fusion ViViT's (dim 128, depth
2, 4 heads x 64, MLP 512), counted as ``vivit-flagship``'s counts count
them (``table_work``). A window is the temporal transformer over L + 1
tokens, the 0D encoder (two Conv1d, four post-norm layers over L rows, the
connector) and the fusion head (``cls_fc1`` and ``cls_fc2``): products as
2 x multiply-adds; normalisations, activations, the softmax and the outer
product are not counted.
"""

from __future__ import annotations

from pathlib import Path

from benchmark.core.spec import load_module

_V = load_module(Path(__file__).with_name("vivit-flagship.py"), "counts_vivit_flagship")


def _vivit(cfg: dict, image_size: int):
    """``vivit-flagship``'s counts' view of the fusion ViViT."""
    return {"program_config": dict(cfg["program_config"]["vivit_kwargs"], image_size=image_size)}


def table_ops(cfg: dict, image_size: int, frames: int, elem: int = 2):
    """(operations, bytes) of K1's table over a shot of ``frames`` frames."""
    return _V.table_ops(_vivit(cfg, image_size), image_size, frames, elem)


def embed_ops(cfg: dict, image_size: int, frames: int) -> float:
    return _V.embed_ops(_vivit(cfg, image_size), image_size, frames)


def _fused(cfg: dict) -> int:
    c = cfg["program_config"]
    return (c["vivit_kwargs"]["dim"] + 1) * (c["ts_kwargs"]["feature_dims"] + 1)


def ts_ops(cfg: dict) -> float:
    """The 0D encoder over one window of L rows."""
    t = cfg["program_config"]["ts_kwargs"]
    L, F, D, k, M = t["max_len"], t["n_features"], t["feature_dims"], t["kernel_size"], \
        t["dim_feedforward"]
    filters = 2 * L * k * D * (F + D)
    layer = 2 * L * (D * 3 * D + D * D + 2 * D * M) + 4 * L * L * D
    return float(filters + t["n_layers"] * layer + 2 * D * D)


def head_ops(cfg: dict, chunks: int, batch: int):
    """(operations, bytes) of the fusion head over ``chunks`` chunks of
    ``batch`` windows: ``cls_fc1`` and ``cls_fc2``'s products; their f32
    weights and biases read once a chunk, their f32 inputs read and outputs
    written once."""
    f, h = _fused(cfg), _fused(cfg) // 2
    n = cfg["program_config"]["n_classes"]
    windows = chunks * batch
    ops = 2.0 * windows * (f * h + h * n)
    weights = (f * h + h + h * n + n) * 4
    nbytes = chunks * weights + windows * (f + h + h + n) * 4
    return ops, float(nbytes)


def window_ops(cfg: dict, image_size: int, windows: int) -> float:
    """The temporal transformer over L + 1 tokens, the 0D encoder and the
    fusion head, per window."""
    v = cfg["program_config"]["vivit_kwargs"]
    D, depth, H, dh, L = v["dim"], v["depth"], v["n_heads"], v["d_head"], v["n_frames"]
    temporal = depth * _V._layer(L + 1, D, H, dh, D * v["scale_dim"])
    return float(windows) * (temporal + ts_ops(cfg)) + head_ops(cfg, 1, 1)[0] * windows


def sweep_ops(cfg: dict, image_size: int, frames: int, windows: int) -> float:
    """A whole-shot sweep's model operations: the table, the embedding and
    the windows."""
    return (table_ops(cfg, image_size, frames)[0] + embed_ops(cfg, image_size, frames)
            + window_ops(cfg, image_size, windows))


def forward_ops(cfg: dict, image_size: int) -> float:
    """One window's full fusion forward, as the reference computes it:
    every frame's tokens through the spatial transformer, then the window."""
    v = cfg["program_config"]["vivit_kwargs"]
    D, depth, H, dh, L = v["dim"], v["depth"], v["n_heads"], v["d_head"], v["n_frames"]
    N = (image_size // v["patch_size"]) ** 2 + 1
    return (embed_ops(cfg, image_size, L) + L * depth * _V._layer(N, D, H, dh, D * v["scale_dim"])
            + window_ops(cfg, image_size, 1))
