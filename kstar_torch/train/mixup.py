"""Mixup + video CutMix (port of ``kstar_tpu/train/mixup.py``, a rebuild of
reference src/utils/mixup.py).

Each function is split into a draw and an apply. The draws (the mixing
weight ``lam``, the permutation and the box/span centre) come from an
explicit ``torch.Generator``; the apply functions are pure tensor functions
of those draws, so the same draws give the same mixed batch on any device.
They return the mixed inputs plus the (y_a, y_b, lam) triple for loss
mixing ``lam*L(y_a) + (1-lam)*L(y_b)``. ``lam`` is an f32 0-dim tensor and
the scalar arithmetic is in f32, as JAX's.

JAX's ``"both"`` mode draws the box's ``cx`` and the span's ``t0`` from one
key (``kstar_tpu/train/mixup.py:40, 54``), so the two are correlated; here
they are independent draws (ROADMAP.md, differences kept on purpose).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

CUTMIX_MODES = ("spatio", "temporal", "both")


def _beta(generator: torch.Generator, alpha: float) -> float:
    """One Beta(alpha, alpha) draw: the inverse CDF of one uniform from
    ``generator`` (torch's Beta sampler takes no generator)."""
    from scipy.special import betaincinv

    u = float(torch.rand((), generator=generator, device=generator.device))
    return float(np.float32(betaincinv(alpha, alpha, u)))


def _perm(generator: torch.Generator, n: int) -> torch.Tensor:
    return torch.randperm(n, generator=generator, device=generator.device)


def mixup_draw(generator: torch.Generator, batch: int,
               alpha: float = 1.0) -> Tuple[float, torch.Tensor]:
    """(lam, perm): lam ~ Beta(alpha, alpha) (1.0 when alpha <= 0) and a
    permutation of the batch."""
    lam = _beta(generator, alpha) if alpha > 0 else 1.0
    return lam, _perm(generator, batch)


def mixup_apply(x: torch.Tensor, y: torch.Tensor, lam, perm: torch.Tensor):
    """Standard mixup (reference :5-23): convex-combine shuffled pairs.
    Returns (x_mix, y, y[perm], lam); x_mix is f32 (or wider), as JAX's f32
    ``lam`` promotes it."""
    perm = perm.to(x.device)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    lam = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    return lam * x + (1.0 - lam) * x[perm], y, y[perm.to(y.device)], lam


def mixup(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
          alpha: float = 1.0):
    """``mixup_apply`` on ``mixup_draw``'s draws."""
    lam, perm = mixup_draw(generator, x.shape[0], alpha)
    return mixup_apply(x, y, lam, perm)


def _clip(v: int, hi: int) -> int:
    return min(max(int(v), 0), hi)


def video_cutmix_draw(generator: torch.Generator, shape, mode: str = "spatio",
                      alpha: float = 1.0):
    """(lam, perm, cx, cy, t0) for ``video_cutmix_apply`` on a (B, T, H, W, C)
    batch: lam ~ Beta(alpha, alpha), the box centre (cx, cy) for the
    spatial modes and the span centre t0 for the temporal ones (None where
    the mode does not use them)."""
    if mode not in CUTMIX_MODES:
        raise ValueError(f"mode must be one of {CUTMIX_MODES}, got {mode!r}")
    B, T, H, W, _ = shape
    lam = _beta(generator, alpha)
    perm = _perm(generator, B)
    randint = lambda hi: int(torch.randint(0, hi, (), generator=generator,
                                           device=generator.device))
    cx = cy = t0 = None
    if mode in ("spatio", "both"):
        cx, cy = randint(W), randint(H)
    if mode in ("temporal", "both"):
        t0 = randint(T)
    return lam, perm, cx, cy, t0


def video_cutmix_apply(x: torch.Tensor, y: torch.Tensor, mode: str, lam,
                       perm: torch.Tensor, cx=None, cy=None, t0=None):
    """Video CutMix (reference video_mixup_data :26-89): replace a spatial
    box of side sqrt(1 - lam) around (cx, cy), a temporal span around t0,
    or both, with the shuffled clip's content. x: (B, T, H, W, C). Returns
    (x, y, y[perm], lam_adj), lam_adj the share of x that was kept."""
    if mode not in CUTMIX_MODES:
        raise ValueError(f"mode must be one of {CUTMIX_MODES}, got {mode!r}")
    B, T, H, W, _ = x.shape
    perm = perm.to(x.device)
    f32 = np.float32
    lam = f32(lam)
    cut = np.sqrt(f32(1.0) - lam)
    lam_adj = lam

    if mode in ("spatio", "both"):
        cw, ch = int(f32(W) * cut), int(f32(H) * cut)
        x1, x2 = _clip(cx - cw // 2, W), _clip(cx + cw // 2, W)
        y1, y2 = _clip(cy - ch // 2, H), _clip(cy + ch // 2, H)
        rows = torch.arange(H, device=x.device)[None, None, :, None, None]
        cols = torch.arange(W, device=x.device)[None, None, None, :, None]
        box = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
        x = torch.where(box, x[perm], x)
        lam_adj = f32(1.0) - f32((x2 - x1) * (y2 - y1)) / f32(W * H)

    if mode in ("temporal", "both"):
        ct = int(f32(T) * cut)
        t1, t2 = _clip(t0 - ct // 2, T), _clip(t0 + ct // 2, T)
        ts = torch.arange(T, device=x.device)[None, :, None, None, None]
        x = torch.where((ts >= t1) & (ts < t2), x[perm], x)
        kept = f32(1.0) - f32(t2 - t1) / f32(T)
        lam_adj = kept if mode == "temporal" else lam_adj * kept

    lam_adj = torch.tensor(lam_adj, dtype=torch.float32, device=x.device)
    return x, y, y[perm.to(y.device)], lam_adj


def video_cutmix(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                 mode: str = "spatio", alpha: float = 1.0):
    """``video_cutmix_apply`` on ``video_cutmix_draw``'s draws."""
    draws = video_cutmix_draw(generator, x.shape, mode, alpha)
    return video_cutmix_apply(x, y, mode, *draws)


def mixup_loss(loss_fn, logits, y_a, y_b, lam):
    """lam * L(y_a) + (1-lam) * L(y_b) (reference mixup_criterion)."""
    return lam * loss_fn(logits, y_a) + (1.0 - lam) * loss_fn(logits, y_b)
