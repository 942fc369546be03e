"""Batched on-device video augmentation + normalization.

Port of ``kstar_tpu/data/augment.py``. Replaces the reference's per-sample
cv2 augmentations in DataLoader worker processes (reference
src/dataset.py:124-227) with tensor ops over the whole uint8 batch on the
device: the host only gathers bytes; crop, augment, normalize and the cast
run where the model runs.

The random draws are split from their application: ``augment_params``
draws the ten scalars of each clip from an explicit ``torch.Generator``,
and ``apply_augment`` is a pure function of the clips and those scalars, so
the JAX package's draws can be fed in to compare the arithmetic.

The arithmetic is the JAX module's (reference quirks kept as it keeps them):
  * brightness: offset ``floor(U(-v, v))``, the batch gets ``|offset|``
    added and is clipped to [10, 255] (both signs add, as the reference's
    negative branch subtracts a negative offset);
  * contrast: float alpha ~ U(min, max), clip(|x * alpha|, 0, 255);
  * blur: cv2's GaussianBlur(k, sigma 0) as two depthwise passes of the
    1-D Gaussian (sigma = 0.3*((k-1)*0.5 - 1) + 0.8) with k//2 zero padding,
    run with TF32 off, so the convolution is full f32 as in JAX;
  * flip: one real horizontal flip;
  * shifts: a stripe of width floor(|ratio| * size) at one edge is zeroed,
    only when that width is > 0;
  * normalize: subtract the per-channel BGR mean (90, 98, 102), then cast.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PIXEL_MEAN_BGR, AugmentConfig
from ..parallel.comm import draw_rows

N_PARAMS = 10
# columns of augment_params' (B, N_PARAMS) output
(BRIGHT, BRIGHT_U, ALPHA, CONTRAST_U, BLUR_U, FLIP_U,
 V_RATIO, V_U, H_RATIO, H_U) = range(N_PARAMS)


def _const(values, device) -> torch.Tensor:
    """A small f32 constant on ``device``, uploaded once per device and kept:
    an upload on every call would be a host copy inside a captured train
    step (``train/loop.py``)."""
    return _uploaded(tuple(np.asarray(values, np.float32).tolist()),
                     torch.device(device))


@functools.lru_cache(maxsize=None)
def _uploaded(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32).to(device)


def center_crop(video: torch.Tensor, crop_size: int) -> torch.Tensor:
    """(..., H, W, C) center crop (reference crop, src/dataset.py:232-257)."""
    H, W = video.shape[-3], video.shape[-2]
    y0 = H // 2 - crop_size // 2
    x0 = W // 2 - crop_size // 2
    return video[..., y0:y0 + crop_size, x0:x0 + crop_size, :]


def gaussian_kernel1d(ksize: int) -> np.ndarray:
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # cv2 sigma-from-ksize rule
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W, C) f32 frames: a depthwise
    pass along H, then one along W, each with ksize//2 zeros of padding."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    k = _const(gaussian_kernel1d(ksize), x.device)
    pad = ksize // 2
    y = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)       # NCHW view of NHWC
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(y, k.view(1, 1, ksize, 1).repeat(C, 1, 1, 1),
                     padding=(pad, 0), groups=C)
        y = F.conv2d(y, k.view(1, 1, 1, ksize).repeat(C, 1, 1, 1),
                     padding=(0, pad), groups=C)
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], C)


def augment_params(generator: torch.Generator, batch: int,
                   cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """The random draws of ``batch`` clips, (batch, N_PARAMS) f32 on the
    generator's device: per clip the brightness offset (floored), the
    contrast alpha and the two shift ratios, each beside the uniform that
    gates its augmentation, and the blur and flip gates. In a data-parallel
    step, this rank's rows of the global batch's draws."""
    p = draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                           device=generator.device), (batch, N_PARAMS))
    for col, lo, hi in ((BRIGHT, -cfg.bright_val, cfg.bright_val),
                        (ALPHA, cfg.contrast_min, cfg.contrast_max),
                        (V_RATIO, -cfg.vertical_ratio, cfg.vertical_ratio),
                        (H_RATIO, -cfg.horizontal_ratio, cfg.horizontal_ratio)):
        p[:, col].mul_(hi - lo).add_(lo)
    p[:, BRIGHT].floor_()
    return p


def _stripe_keep(ratio: torch.Tensor, size: int, axis_shape) -> tuple:
    """(keep mask, shift) of the shift augmentation along one axis: ratio > 0
    zeros the last ``shift`` positions, ratio < 0 keeps only them."""
    shift = torch.floor(ratio.abs() * size).to(torch.int32)
    pos = torch.arange(size, device=ratio.device).view(axis_shape)
    keep = torch.where(ratio > 0, pos < size - shift, pos >= size - shift)
    return keep, shift


def apply_augment(clip: torch.Tensor, params: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """All probability-gated augmentations of (B, T, H, W, C) f32 clips,
    given ``augment_params``' (B, N_PARAMS) draws. Pure: the same inputs
    give the same output."""
    B, T, H, W, C = clip.shape
    col = lambda i: params[:, i].view(B, 1, 1, 1, 1)
    x = clip
    x = torch.where(col(BRIGHT_U) < cfg.bright_p,
                    torch.clamp(x + col(BRIGHT).abs(), 10.0, 255.0), x)
    x = torch.where(col(CONTRAST_U) < cfg.contrast_p,
                    torch.clamp((x * col(ALPHA)).abs(), 0.0, 255.0), x)
    x = torch.where(col(BLUR_U) < cfg.blur_p, blur(x, cfg.blur_k), x)
    x = torch.where(col(FLIP_U) < cfg.flip_p, x.flip(3), x)
    keep, shift = _stripe_keep(col(V_RATIO), H, (1, 1, H, 1, 1))
    x = torch.where((col(V_U) < cfg.vertical_p) & (shift > 0), x * keep, x)
    keep, shift = _stripe_keep(col(H_RATIO), W, (1, 1, 1, W, 1))
    x = torch.where((col(H_U) < cfg.horizontal_p) & (shift > 0), x * keep, x)
    return x


def preprocess(video_u8: torch.Tensor, crop_size: int,
               cfg: AugmentConfig = AugmentConfig(), train: bool = True,
               out_dtype: torch.dtype = torch.float32,
               generator: torch.Generator = None) -> torch.Tensor:
    """Crop -> (train only) augment -> normalize -> cast, batched: (B, T, H,
    W, C) uint8 -> (B, T, crop, crop, C) ``out_dtype`` with the per-channel
    BGR mean subtracted (reference normalize, src/dataset.py:201-205).
    ``generator`` (on the video's device) draws the augmentations."""
    x = center_crop(video_u8, crop_size).float()
    if train:
        if generator is None:
            raise ValueError("preprocess(train=True) draws its augmentations "
                             "from an explicit torch.Generator; pass generator=")
        x = apply_augment(x, augment_params(generator, x.shape[0], cfg), cfg)
    x = x - _const(PIXEL_MEAN_BGR, x.device)
    return x.to(out_dtype)


def make_pre_fns(crop_size: int, cfg: AugmentConfig = AugmentConfig(),
                 out_dtype: torch.dtype = torch.bfloat16):
    """(pre_train, pre_eval) closures for the train/eval steps
    (train/loop.py ``pre_fn``): each takes (generator, batch), where batch
    is a raw uint8 video tensor or a multimodal {'video', '0D'} dict."""

    def _run(generator, batch, train: bool):
        if isinstance(batch, dict):
            out = dict(batch)
            out["video"] = preprocess(batch["video"], crop_size, cfg, train,
                                      out_dtype, generator)
            return out
        return preprocess(batch, crop_size, cfg, train, out_dtype, generator)

    def pre_train(generator, batch):
        return _run(generator, batch, True)

    def pre_eval(generator, batch):
        return _run(generator, batch, False)

    return pre_train, pre_eval
