"""The 3-D ResNet blocks shared by the SlowFast pathways.

Port of ``kstar_tpu/models/resnet3d.py`` (rebuild of reference
src/models/resnet.py): ``Bottleneck3D`` (1x1x1, or 3x1x1 with
``head_conv=3``, then 1x3x3 with the stride, then 1x1x1 expanding x4), with
squeeze-excite and Swish on EVERY block (the reference builds every block
with index 0, so its ``index % 2 == 0`` gate is always open), ``ResStage``
and the ``Stem3D`` (1x7x7 stride (1, 2, 2) conv with a bias, BatchNorm,
ReLU, 1x3x3 stride (1, 2, 2) max-pool).

With ``bn_splits`` the block BatchNorms bn1/bn2/bn3 are ``SubBatchNorm``;
the stem and the shortcut projection keep flax's BatchNorm, as in the
reference. Numerics as in JAX: convs in the compute ``dtype``, flax
BatchNorm in f32 (a SubBatchNorm returns its input's dtype), the
activation on that, cast to ``dtype``; the squeeze-excite gate is a
``dtype`` mean over (T, H, W), two 1x1x1 convs with bias in ``dtype`` and
an f32 sigmoid cast back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv3d, act_relu, max_pool3d
from .subbn import SubBatchNorm

EXPANSION = 4


def _round_width(width: int, multiplier: float = 0.0625, min_width: int = 8,
                 divisor: int = 8) -> int:
    """Squeeze-excite bottleneck width (reference Bottleneck3D.round_width,
    src/models/resnet.py:154-169)."""
    if not multiplier:
        return width
    w = width * multiplier
    width_out = max(min_width, int(w + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * w:
        width_out += divisor
    return int(width_out)


class Bottleneck3D(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1, head_conv: int = 1,
                 has_shortcut_proj: bool = False, dtype: torch.dtype = torch.float32,
                 bn_splits: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, g = dtype, generator
        out = planes * EXPANSION
        bn = ((lambda c: SubBatchNorm(c, bn_splits)) if bn_splits else BatchNorm)
        if head_conv == 3:
            self.conv1 = Conv3d(in_channels, planes, (3, 1, 1), padding=(1, 0, 0),
                                dtype=dtype, generator=g)
        else:
            self.conv1 = Conv3d(in_channels, planes, (1, 1, 1), dtype=dtype, generator=g)
        self.bn1 = bn(planes)
        self.conv2 = Conv3d(planes, planes, (1, 3, 3), (1, stride, stride), (0, 1, 1),
                            dtype=dtype, generator=g)
        self.bn2 = bn(planes)
        width = _round_width(planes)
        self.se_fc1 = Conv3d(planes, width, (1, 1, 1), bias=True, dtype=dtype, generator=g)
        self.se_fc2 = Conv3d(width, planes, (1, 1, 1), bias=True, dtype=dtype, generator=g)
        self.conv3 = Conv3d(planes, out, (1, 1, 1), dtype=dtype, generator=g)
        self.bn3 = bn(out)
        if has_shortcut_proj:
            self.shortcut_conv = Conv3d(in_channels, out, (1, 1, 1), (1, stride, stride),
                                        dtype=dtype, generator=g)
            self.shortcut_bn = BatchNorm(out)
        else:
            self.shortcut_conv = self.shortcut_bn = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = act_relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        out = act_relu(self.bn2(self.conv2(out), train)).to(self.dtype)
        # squeeze-excite (on every block, see the module docstring), then Swish
        se = out.mean(dim=(1, 2, 3), keepdim=True)                  # (B, 1, 1, 1, C)
        se = self.se_fc2(act_relu(self.se_fc1(se)))
        out = out * torch.sigmoid(se.float()).to(out.dtype)
        out = F.silu(out)
        out = self.bn3(self.conv3(out), train)
        residual = x
        if self.shortcut_conv is not None:
            residual = self.shortcut_bn(self.shortcut_conv(x), train)
        return act_relu(out + residual).to(self.dtype)


class ResStage(nn.Module):
    """One ``_make_layer`` stage (reference src/models/resnet.py:245-265):
    the first block strides and projects when the stride is not 1 or the
    channels differ."""

    def __init__(self, in_channels: int, planes: int, blocks: int, stride: int = 1,
                 head_conv: int = 1, dtype: torch.dtype = torch.float32,
                 bn_splits: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        needs_proj = stride != 1 or in_channels != planes * EXPANSION
        for i in range(blocks):
            self.add_module(f"block_{i}", Bottleneck3D(
                in_channels if i == 0 else planes * EXPANSION, planes, stride if i == 0 else 1,
                head_conv, needs_proj and i == 0, dtype, bn_splits, generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self.children():
            x = block(x, train)
        return x


class Stem3D(nn.Module):
    """layer0: 1x7x7 stride (1, 2, 2) conv (with a bias, flax's default) +
    BatchNorm + ReLU + 1x3x3 stride (1, 2, 2) max-pool (reference
    src/models/resnet.py:219-230)."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(in_channels, features, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=True,
                           dtype=dtype, generator=generator)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = act_relu(self.bn(self.conv(x), train)).to(self.dtype)
        return max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
