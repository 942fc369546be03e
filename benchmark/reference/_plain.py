"""Plain PyTorch pieces the references share: f32 products with TF32 off,
the lower-precision control's fp8 operands, LayerNorm, GELU, the Focal loss
and optax's clipped AdamW. Imports torch alone.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

PIXEL_MEAN_BGR = (90.0, 98.0, 102.0)    # subtracted per channel (reference src/dataset.py:201-205)
FP8_MAX = 448.0                          # largest float8_e4m3fn


@contextlib.contextmanager
def exact_f32():
    """f32 products as f32: TF32 off for matmuls and cuDNN while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude to 448), back in f32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand in ``precision``: ``f32`` as it is, ``fp8`` rounded;
    ``bf16`` (a witness, not the control) rounded, and its gradient with it."""
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return fp8(x) if precision == "fp8" else x


def dense(x, w, b, precision: str):
    y = operand(x, precision) @ operand(w, precision).t()
    return y if b is None else y + b


def layer_norm(x, w, b, eps: float = 1e-6):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def gelu(x):
    """GELU in its tanh form, the one the JAX package and the port use."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def normalise(clips_u8: torch.Tensor) -> torch.Tensor:
    """(..., C) uint8 BGR -> f32 with the channel means subtracted."""
    return clips_u8.float() - torch.tensor(PIXEL_MEAN_BGR, device=clips_u8.device)


def centre_crop(clips: torch.Tensor, crop: int) -> torch.Tensor:
    H, W = clips.shape[-3], clips.shape[-2]
    y0, x0 = H // 2 - crop // 2, W // 2 - crop // 2
    return clips[..., y0:y0 + crop, x0:x0 + crop, :]


def focal_loss(logits, labels, gamma: float):
    """sum((1 - p_t)^gamma * CE) with p_t = exp(-CE) (reference src/loss.py:14-34,
    sum reduction, no class weights)."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    return torch.sum((1.0 - torch.exp(-ce)) ** gamma * ce)


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr)) with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8 outside the root, weight decay 1e-4
    added to the update) and a staircase decay of the learning rate by
    ``gamma`` every ``transition`` applied updates."""

    def __init__(self, lr, max_norm, transition, gamma):
        self.lr, self.max_norm, self.transition, self.gamma = lr, max_norm, transition, gamma
        self.count, self.mu, self.nu = 0, None, None

    def clip(self, grads: dict) -> dict:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if norm < self.max_norm:
            return grads
        return {k: g / norm * self.max_norm for k, g in grads.items()}

    def step(self, params: dict, grads: dict) -> dict:
        """The clipped gradient the moments took; updates ``params`` in place."""
        g = self.clip(grads)
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in g.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in g.items()}
        lr = self.lr * self.gamma ** (self.count // self.transition)
        self.count += 1
        for k in params:
            self.mu[k] = 0.1 * g[k] + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * g[k] ** 2 + 0.999 * self.nu[k]
            mu_hat = self.mu[k] / (1 - 0.9 ** self.count)
            nu_hat = self.nu[k] / (1 - 0.999 ** self.count)
            u = mu_hat / (torch.sqrt(nu_hat) + 1e-8) + 1e-4 * params[k]
            params[k] -= lr * u
        return g
