"""Losses and class-imbalance machinery as functions on tensors.

Port of ``kstar_tpu/losses.py`` (reference src/loss.py FocalLoss/LDAMLoss/
CELoss, the DRW schedule of src/train.py:318-329 and the Gradient Blending
loss of src/GradientBlending.py:20-50). Class weights, LDAM margins and GB
weights are tensor inputs, so per-epoch DRW or re-estimated GB weights are
plain arguments. Reductions follow the JAX module, not torch's defaults: CE
and focal are SUMS over the batch, LDAM is a weighted MEAN with its
denominator floored at 1e-8; logits go to f32 before ``log_softmax``.

Label convention: 0 = disruptive, 1 = normal.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .parallel.comm import reduce_data


def _ce_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unreduced cross entropy, f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted cross entropy, sum reduction (reference CELoss,
    src/loss.py:71-81 uses reduction='sum')."""
    ce = _ce_per_sample(logits, labels)
    if weight is not None:
        ce = ce * weight[labels]
    if mask is not None:
        ce = ce * mask
    return torch.sum(ce)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    gamma: float = 2.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Focal loss, sum reduction (reference FocalLoss, src/loss.py:14-34):
    ``sum(alpha * (1 - p)^gamma * CE)`` with ``p = exp(-CE)`` and alpha the
    per-class weight gathered by target."""
    ce = _ce_per_sample(logits, labels)
    p = torch.exp(-ce)
    alpha = weight[labels] if weight is not None else 1.0
    loss = alpha * (1.0 - p) ** gamma * ce
    if mask is not None:
        loss = loss * mask
    return torch.sum(loss)


def ldam_margins(cls_num_list: np.ndarray, max_m: float = 0.5) -> np.ndarray:
    """Per-class margins ``m_c = max_m * n_c^(-1/4) / max(...)``
    (reference LDAMLoss.update_m_list, src/loss.py:52-56)."""
    m = 1.0 / np.sqrt(np.sqrt(np.maximum(np.asarray(cls_num_list, np.float64), 1.0)))
    return (m * (max_m / np.max(m))).astype(np.float32)


def ldam_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    m_list: torch.Tensor,
    s: float = 1.0,
    weight: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LDAM loss (reference LDAMLoss.forward, src/loss.py:58-69): subtract the
    true-class margin from its logit, scale by ``s``, weighted-mean CE
    (torch cross_entropy's default reduction with class weights)."""
    logits = logits.float()
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    x_m = logits - onehot * m_list[labels][:, None]
    ce = _ce_per_sample(s * x_m, labels)
    if mask is None:
        mask = torch.ones_like(ce)
    w = weight[labels] * mask if weight is not None else mask
    # in a data-parallel step the mean is over the global batch: the
    # denominator is the data group's sum (parallel/comm.py)
    return torch.sum(ce * w) / torch.clamp(reduce_data(torch.sum(w)), min=1e-8)


def classification_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    loss_type: str,
    weight: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    gamma: float = 2.0,
    m_list: Optional[torch.Tensor] = None,
    s: float = 1.0,
) -> torch.Tensor:
    """Dispatch on loss_type in {CE, Focal, LDAM}."""
    if loss_type == "Focal":
        return focal_loss(logits, labels, weight, gamma, mask)
    if loss_type == "LDAM":
        if m_list is None:
            raise ValueError("LDAM loss needs the per-class margins m_list")
        return ldam_loss(logits, labels, m_list, s, weight, mask)
    return ce_loss(logits, labels, weight, mask)


# ---------------------------------------------------------------------------
# Re-weighting schedules (numpy, as in the JAX module)
# ---------------------------------------------------------------------------

def inverse_freq_weights(cls_num_list: np.ndarray) -> np.ndarray:
    """Inverse-frequency class weights, normalized to sum to n_classes
    (reference train_vision_network.py:312-318)."""
    n = np.asarray(cls_num_list, np.float64)
    w = 1.0 / np.maximum(n, 1.0)
    return (w / w.sum() * len(n)).astype(np.float32)


def drw_weights(epoch: int, num_epoch: int, cls_num_list: np.ndarray,
                beta: float = 0.25) -> np.ndarray:
    """Deferred re-weighting: step betas = [0, b, 2b, 3b] across epoch
    quarters, effective-number weights ``(1-beta)/(1-beta^n_c)`` normalized
    to sum to n_classes (reference src/train.py:318-329)."""
    betas = [0.0, beta, 2 * beta, 3 * beta]
    idx = min(epoch // max(int(num_epoch / len(betas)), 1), len(betas) - 1)
    b = betas[idx]
    n = np.asarray(cls_num_list, np.float64)
    effective = 1.0 - np.power(b, n)
    w = (1.0 - b) / np.maximum(effective, 1e-12)
    return (w / w.sum() * len(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# Gradient Blending
# ---------------------------------------------------------------------------

def gradient_blending_loss(
    out_multi: torch.Tensor,
    out_vis: torch.Tensor,
    out_ts: torch.Tensor,
    labels: torch.Tensor,
    gb_weights: torch.Tensor,   # (3,) = [w_vis, w_ts, w_multi]
    loss_type: str = "Focal",
    weight: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    gamma: float = 2.0,
    m_list: Optional[torch.Tensor] = None,
    s: float = 1.0,
    loss_scale: float = 1.0,
) -> torch.Tensor:
    """Weighted sum of per-stream losses (reference GradientBlending.forward,
    src/GradientBlending.py:45-50)."""
    kw = dict(weight=weight, mask=mask, gamma=gamma, m_list=m_list, s=s)
    l_vis = classification_loss(out_vis, labels, loss_type, **kw) * loss_scale
    l_ts = classification_loss(out_ts, labels, loss_type, **kw) * loss_scale
    l_multi = classification_loss(out_multi, labels, loss_type, **kw) * loss_scale
    return gb_weights[0] * l_vis + gb_weights[1] * l_ts + gb_weights[2] * l_multi


def estimate_gb_weights(train_losses: Dict[str, list], valid_losses: Dict[str, list]) -> Dict[str, float]:
    """Offline G-Blend weight estimate from per-stream loss trajectories
    (reference GB_estimate, src/GradientBlending.py:52-114):
    ``w = G / (Of - Oi)^2`` with O = valid - train overfitting measures,
    normalized across streams.

    Deviation from the reference on MIXED-sign trajectories only (as in the
    JAX module): when every stream's raw ratio shares one sign the
    normalization reproduces the reference's positive weights exactly; with
    mixed signs the reference's ``w / sum(w)`` would hand the minority-sign
    streams NEGATIVE blending weights, so here they drop to 0 instead and
    the dominant side normalizes to 1."""
    raw = {}
    for key in train_losses:
        tr, va = train_losses[key], valid_losses[key]
        Oi = va[0] - tr[0]
        Of = va[-1] - tr[-1]
        G = va[-1] - va[0]
        raw[key] = G / max((Of - Oi) ** 2, 1e-12)
    pos = {k: max(v, 0.0) for k, v in raw.items()}
    neg = {k: max(-v, 0.0) for k, v in raw.items()}
    ws = neg if sum(neg.values()) >= sum(pos.values()) else pos
    total = sum(ws.values())
    if total == 0:
        return {k: 1.0 / len(ws) for k in ws}
    return {k: v / total for k, v in ws.items()}


# ---------------------------------------------------------------------------
# Deep CCA loss (reference src/CCA.py:25-83)
# ---------------------------------------------------------------------------

def cca_loss(h1: torch.Tensor, h2: torch.Tensor, out_dim: int,
             use_all_singular_values: bool = False,
             r1: float = 1e-3, r2: float = 1e-3, eps: float = 1e-9) -> torch.Tensor:
    """Negative total canonical correlation between two views.

    Whitens per-view covariances, forms T = S11^-1/2 S12 S22^-1/2, and returns
    -sum of its singular values (or -sqrt(trace(T'T)) of the top-k), as in the
    reference's torch.symeig implementation."""
    h1 = h1.T.float()  # (d, N)
    h2 = h2.T.float()
    d1, n = h1.shape
    d2 = h2.shape[0]
    eye = lambda d: torch.eye(d, dtype=h1.dtype, device=h1.device)

    h1c = h1 - h1.mean(dim=1, keepdim=True)
    h2c = h2 - h2.mean(dim=1, keepdim=True)

    s12 = (h1c @ h2c.T) / (n - 1)
    s11 = (h1c @ h1c.T) / (n - 1) + r1 * eye(d1)
    s22 = (h2c @ h2c.T) / (n - 1) + r2 * eye(d2)

    def inv_sqrt(s):
        vals, vecs = torch.linalg.eigh(s)
        vals = torch.clamp(vals, min=eps)
        return (vecs * (vals ** -0.5)) @ vecs.T

    t = inv_sqrt(s11) @ s12 @ inv_sqrt(s22)
    if use_all_singular_values:
        corr = torch.sqrt(torch.clamp(torch.trace(t.T @ t), min=eps))
    else:
        tt = t.T @ t + r1 * eye(d2)
        vals = torch.linalg.eigvalsh(tt)
        topk = torch.topk(vals, min(out_dim, d2)).values
        corr = torch.sum(torch.sqrt(torch.clamp(topk, min=eps)))
    return -corr
