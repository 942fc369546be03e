"""R(2+1)D: the factorised spatiotemporal conv video classifier.

Port of ``kstar_tpu/models/r2plus1d.py`` (rebuild of reference
src/models/R2Plus1D.py): every 3-D conv is a spatial (1, k, k) conv and a
temporal (k, 1, 1) conv with the middle width of reference :150-155; each
is conv + flax BatchNorm + LeakyReLU; residual blocks downsample with
stride (2, 2, 2) and a (2+1)D 1 x 1 x 1 projection shortcut; the stem is
3 -> 45 -> 32 (1x7x7 stride (1, 2, 2), then 3x1x1); stages 32/32/64/64/128;
global average pool; a BatchNorm + ELU MLP head.

Numerics follow the JAX module: convs in the compute ``dtype`` with
torch-style symmetric padding (a stride-2 conv under flax's "SAME" would
pad differently), BatchNorm and the activation in f32, the result cast to
``dtype`` (in bf16 evaluation on the GPU one kernel pass, rounding where the
eager chain rounds, ``ops/bn_act.py``); the pool is a ``dtype`` mean cast to
f32; the head runs in f32 with the backbone's alpha (0.01) as its ELU alpha. Submodules carry the
flax names (``backbone.conv1.spatial.Conv_0`` ...), so
``weights.state_dict_from_flax`` maps the JAX parameters one to one.
Clips are channels-last (B, T, H, W, C).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .common import BatchNorm, Conv3d, MLPHead, bn_leaky_relu


def _middle_channels(kt: int, ks: int, cin: int, cout: int) -> int:
    """(2+1)D intermediate width: floor((t*k^2*Cin*Cout) / (k^2*Cin + t*Cout))
    (reference src/models/R2Plus1D.py:150-155)."""
    return int(math.floor((kt * ks * ks * cin * cout) / (ks * ks * cin + kt * cout)))


class Conv3dBN(nn.Module):
    """Conv3d + BatchNorm + LeakyReLU (reference Conv3dBlock, :25-59); with
    ``residual``, then a residual block's join, LeakyReLU(residual + that),
    in the same epilogue (``common.bn_leaky_relu``: one kernel pass in bf16
    evaluation on the GPU)."""

    def __init__(self, in_channels: int, features: int, kernel: Tuple[int, int, int],
                 stride=(1, 1, 1), padding=(1, 1, 1), alpha: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alpha, self.dtype = alpha, dtype
        self.Conv_0 = Conv3d(in_channels, features, kernel, stride, padding, dtype=dtype,
                             generator=generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return bn_leaky_relu(self.BatchNorm_0, self.Conv_0(x), train, self.alpha, self.dtype,
                             residual)


class SpatioTemporalConv(nn.Module):
    """Factorised (2+1)D conv: spatial (1, k, k) then temporal (kt, 1, 1),
    each a Conv3dBN (reference SpatioTemporalConv, :115-161). The stem
    (``is_first``) has the fixed middle width 45 and a 3x1x1 temporal conv.
    A ``residual`` joins in the temporal conv's epilogue."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1), alpha: float = 0.01, is_first: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kt, kh, kw = kernel
        st, sh, sw = stride
        pt, ph, pw = kt // 2, kh // 2, kw // 2
        if is_first:
            mid, t_kernel, t_pad = 45, (3, 1, 1), (1, 0, 0)
        else:
            mid = max(_middle_channels(kt, kh, in_channels, features), 1)
            t_kernel, t_pad = (kt, 1, 1), (pt, 0, 0)
        self.spatial = Conv3dBN(in_channels, mid, (1, kh, kw), (1, sh, sw), (0, ph, pw),
                                alpha, dtype, generator)
        self.temporal = Conv3dBN(mid, features, t_kernel, (st, 1, 1), t_pad, alpha, dtype,
                                 generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.temporal(self.spatial(x, train), train, residual)


class STResBlock(nn.Module):
    """Two (2+1)D convs and a residual; a downsampling block strides (2, 2, 2)
    with a 1x1x1 (2+1)D projection shortcut (reference
    SpatioTemporalResBlock, :164-188). The shortcut comes first and joins in
    ``conv2``'s last epilogue, LeakyReLU(shortcut + conv2's output)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 downsample: bool = False, alpha: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = (kernel,) * 3
        stride = (2, 2, 2) if downsample else (1, 1, 1)
        self.conv1 = SpatioTemporalConv(in_channels, features, k, stride, alpha, dtype=dtype,
                                        generator=generator)
        self.conv2 = SpatioTemporalConv(features, features, k, (1, 1, 1), alpha, dtype=dtype,
                                        generator=generator)
        self.shortcut = (SpatioTemporalConv(in_channels, features, (1, 1, 1), (2, 2, 2), alpha,
                                            dtype=dtype, generator=generator)
                         if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        short = x if self.shortcut is None else self.shortcut(x, train)
        return self.conv2(self.conv1(x, train), train, short)


class STResLayer(nn.Module):
    """``layer_size`` blocks; the first may downsample (reference
    SpatioTemporalResLayer, :190-204)."""

    def __init__(self, in_channels: int, features: int, layer_size: int,
                 downsample: bool = False, alpha: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(layer_size):
            self.add_module(f"block_{i}", STResBlock(
                in_channels if i == 0 else features, features, 3, downsample and i == 0,
                alpha, dtype, generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self.children():
            x = block(x, train)
        return x


class R2Plus1DNet(nn.Module):
    """Backbone: stem, four residual stages, global average pool -> (B, 128)
    f32 (reference R2Plus1DNet, :207-226)."""

    def __init__(self, layer_sizes: Sequence[int] = (1, 2, 2, 1), alpha: float = 0.01,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.conv1 = SpatioTemporalConv(in_channels, 32, (1, 7, 7), (1, 2, 2), alpha,
                                        is_first=True, dtype=dtype, generator=g)
        self.conv2 = STResLayer(32, 32, layer_sizes[0], False, alpha, dtype, g)
        self.conv3 = STResLayer(32, 64, layer_sizes[1], True, alpha, dtype, g)
        self.conv4 = STResLayer(64, 64, layer_sizes[2], True, alpha, dtype, g)
        self.conv5 = STResLayer(64, 128, layer_sizes[3], True, alpha, dtype, g)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5):
            x = stage(x, train)
        return x.mean(dim=(1, 2, 3)).float()


class R2Plus1DClassifier(nn.Module):
    """Backbone + BatchNorm/ELU MLP head (reference R2Plus1DClassifier,
    :228-297). ``generator`` seeds the flax-default initialisation:
    lecun-normal conv and Dense kernels, zero biases, unit BatchNorm
    scales."""

    def __init__(self, image_size: int = 128, n_frames: int = 21, n_classes: int = 2,
                 layer_sizes: Sequence[int] = (1, 2, 2, 1), alpha: float = 0.01,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = R2Plus1DNet(tuple(layer_sizes), alpha, in_channels, dtype, generator)
        # the head's ELU takes the backbone's alpha (reference :228-248)
        self.head = MLPHead(128, 64, n_classes, norm="batch", act="elu", alpha=alpha,
                            generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of (B, T, H, W, C) clips. The model has no dropout and no
        input noise: the train step's generators are unused."""
        return self.head(self.backbone(x, train), train)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The pooled (B, 128) backbone feature."""
        return self.backbone(x)
