"""SlowFast: the two-pathway video classifier.

Port of ``kstar_tpu/models/slowfast.py`` (rebuild of reference
src/models/slowfast.py). The fast pathway sees every ``tau_fast``-th frame
and sends a lateral after its stem and its stages 1-3: a (alpha+2)x1x1 conv
with temporal stride alpha and temporal padding 1, keeping the channel
count; the slow pathway sees every (alpha * tau_fast)-th frame and
concatenates each lateral on the channel axis before its next stage (20
frames: 5 slow frames, and (20 + 2 - 6) // 4 + 1 = 5 lateral frames). Both
pathways are pooled (a ``dtype`` mean) and concatenated; a BatchNorm + ELU
MLP head (hidden out_dim / 2) gives the logits in f32.

Widths (m = ``base_width`` = 16): fast stem m/alpha, stages m/alpha,
2m/alpha, 4m/alpha, 8m/alpha planes (head_conv 3 throughout); slow stem m,
stages m, 2m, 4m, 8m planes (head_conv 1 for stages 1-2, 3 for 3-4).
``base_bn_splits`` turns the block BatchNorms into ``SubBatchNorm``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .common import Conv3d, MLPHead
from .resnet3d import EXPANSION, ResStage, Stem3D


class FastPath(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), alpha: int = 4, m: int = 16,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 bn_splits: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a, g = alpha, generator

        def lateral(c):
            return Conv3d(c, c, (a + 2, 1, 1), (a, 1, 1), (1, 0, 0), dtype=dtype, generator=g)

        self.stem = Stem3D(in_channels, m // a, dtype, g)
        self.l_stem = lateral(m // a)
        c = m // a
        for i, planes in enumerate((m // a, 2 * m // a, 4 * m // a, 8 * m // a)):
            self.add_module(f"stage{i + 1}", ResStage(c, planes, layers[i], 1 if i == 0 else 2,
                                                      3, dtype, bn_splits, g))
            c = planes * EXPANSION
            if i < 3:
                self.add_module(f"l_stage{i + 1}", lateral(c))

    def forward(self, x: torch.Tensor, train: bool = False):
        """(pooled features, the four laterals)."""
        sub = self._modules
        x = self.stem(x, train)
        laterals: List[torch.Tensor] = [self.l_stem(x)]
        for i in range(1, 5):
            x = sub[f"stage{i}"](x, train)
            if i < 4:
                laterals.append(sub[f"l_stage{i}"](x))
        return x.mean(dim=(1, 2, 3)), laterals


class SlowPath(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), alpha: int = 4, m: int = 16,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 bn_splits: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stem = Stem3D(in_channels, m, dtype, g)
        # the laterals keep the fast pathway's channels: its stem's, then
        # its stages 1-3 outputs'
        lateral = [m // alpha] + [(2 ** i * m) // alpha * EXPANSION for i in range(3)]
        c = m
        for i, (planes, head) in enumerate(((m, 1), (2 * m, 1), (4 * m, 3), (8 * m, 3))):
            self.add_module(f"stage{i + 1}", ResStage(c + lateral[i], planes, layers[i],
                                                      1 if i == 0 else 2, head, dtype,
                                                      bn_splits, g))
            c = planes * EXPANSION

    def forward(self, x: torch.Tensor, laterals: List[torch.Tensor], train: bool = False):
        x = self.stem(x, train)
        for i in range(4):
            x = self._modules[f"stage{i + 1}"](torch.cat([x, laterals[i]], dim=-1), train)
        return x.mean(dim=(1, 2, 3))


class SlowFastEncoder(nn.Module):
    """Temporal split, both pathways, concat -> (B, out_dim) f32 (reference
    SlowFastEncoder, src/models/slowfast.py:92-141)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), alpha: int = 4,
                 tau_fast: int = 1, m: int = 16, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, bn_splits: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alpha, self.tau_fast, self.dtype = alpha, tau_fast, dtype
        self.fast = FastPath(tuple(layers), alpha, m, in_channels, dtype, bn_splits, generator)
        self.slow = SlowPath(tuple(layers), alpha, m, in_channels, dtype, bn_splits,
                             generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        h_fast, laterals = self.fast(x[:, :: self.tau_fast], train)
        h_slow = self.slow(x[:, :: self.alpha * self.tau_fast], laterals, train)
        return torch.cat([h_slow, h_fast], dim=-1).float()


class SlowFast(nn.Module):
    """Encoder + BatchNorm/ELU MLP head (reference SlowFast,
    src/models/slowfast.py:163-195). ``generator`` seeds the flax-default
    initialisation."""

    def __init__(self, image_size: int = 128, n_frames: int = 20, n_classes: int = 2,
                 layers: Sequence[int] = (3, 4, 6, 3), alpha: int = 4, tau_fast: int = 1,
                 in_channels: int = 3, base_width: int = 16,
                 dtype: torch.dtype = torch.float32, base_bn_splits: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = SlowFastEncoder(tuple(layers), alpha, tau_fast, base_width,
                                       in_channels, dtype, base_bn_splits, generator)
        out_dim = (8 * base_width * EXPANSION
                   + 8 * base_width // alpha * EXPANSION)
        self.head = MLPHead(out_dim, out_dim // 2, n_classes, norm="batch", act="elu",
                            generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of (B, T, H, W, C) clips. No dropout, no input noise: the
        train step's generators are unused."""
        return self.head(self.encoder(x, train), train)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
