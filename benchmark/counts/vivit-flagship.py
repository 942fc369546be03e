"""Operation and byte counts of the ViViT configuration, from its shapes.

``table_work`` is a frozen copy of ``chip_smoke.py table_work``: what K1's
spatial-cls table needs, counting only what its output needs (the last layer
computes K and V for every row and the rest for the cls row alone), each
input read once and the output written once.
"""

from __future__ import annotations


def _dims(cfg: dict, image_size: int):
    c = cfg["program_config"]
    D, depth, H, dh = c["dim"], c["depth"], c["n_heads"], c["d_head"]
    n_tokens = (image_size // c["patch_size"]) ** 2 + 1
    return D, depth, H, dh, D * c["scale_dim"], c["patch_size"], c["n_frames"], n_tokens


def table_work(T, n_off, N, D, depth, H, dh, M, elem):
    inner = H * dh
    full_layer = 2 * N * (D * 3 * inner + inner * D + D * M + M * D) + 4 * H * N * N * dh
    last_layer = (2 * N * D * 2 * inner
                  + 2 * (D * inner + inner * D + D * M + M * D)
                  + 4 * H * N * dh)
    ops = ((depth - 1) * full_layer + last_layer) * n_off * T
    weights = depth * (3 * inner * D + inner * D + D * M + M * D + 2 * D + M) * elem \
        + depth * 4 * D * 4 + 2 * D * 4
    nbytes = (T * N * D + n_off * N * D + n_off * T * D) * elem + weights
    return ops, nbytes


def _layer(N, D, H, dh, M):
    """One full pre-norm transformer layer over N tokens."""
    inner = H * dh
    return 2 * N * (D * 3 * inner + inner * D + D * M + M * D) + 4 * H * N * N * dh


def table_ops(cfg: dict, image_size: int, frames: int, elem: int = 2):
    """(operations, bytes) of K1's table over a shot of ``frames`` frames."""
    D, depth, H, dh, M, _, L, N = _dims(cfg, image_size)
    return table_work(frames, L, N, D, depth, H, dh, M, elem)


def embed_ops(cfg: dict, image_size: int, frames: int) -> float:
    D, _, _, _, _, p, _, N = _dims(cfg, image_size)
    return 2.0 * frames * (N - 1) * p * p * 3 * D


def window_ops(cfg: dict, image_size: int, windows: int) -> float:
    """The temporal transformer over L + 1 tokens and the head, per window."""
    D, depth, H, dh, M, _, L, _ = _dims(cfg, image_size)
    head = 2 * (D * (D // 2) + (D // 2) * 2)
    return float(windows) * (depth * _layer(L + 1, D, H, dh, M) + head)


def sweep_ops(cfg: dict, image_size: int, frames: int, windows: int) -> float:
    """A whole-shot sweep's model operations: the table, the embedding and
    the windows."""
    return (table_ops(cfg, image_size, frames)[0] + embed_ops(cfg, image_size, frames)
            + window_ops(cfg, image_size, windows))


def forward_ops(cfg: dict, image_size: int) -> float:
    """One clip's full forward as training runs it: every frame's tokens
    through the spatial transformer, then the temporal one and the head."""
    D, depth, H, dh, M, _, L, N = _dims(cfg, image_size)
    return (embed_ops(cfg, image_size, L) + L * depth * _layer(N, D, H, dh, M)
            + window_ops(cfg, image_size, 1))
