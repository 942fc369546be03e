"""MLSTM-FCN 0D classifier (port of ``kstar_tpu/models/mlstm_fcn.py``, a
rebuild of reference src/models/MLSTM_FCN.py).

Two parallel branches over the (B, T, F) window:
  FCN : 2x (VALID Conv1d + BatchNorm + LeakyReLU(alpha) + squeeze-excite),
        mean over time (reference :106-111);
  RNN : bidirectional LSTM over time + attention pooling (reference
        SelfAttentionRnn :46-82).
Concat -> converter Dense -> MLP head (BatchNorm, LeakyReLU(alpha)).

Reference quirks kept: ``alpha`` defaults to 1.0, which makes every
LeakyReLU the identity (the CLI passes 0.01), and ``lstm_dropout`` is
accepted and unused.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import (AttentionPool, BatchNorm, BiLSTM, Conv1d, MLPHead, NoiseLayer,
                     SqueezeExcite1D)
from .vivit import Dense


class _ConvBlock(nn.Module):
    """VALID Conv1d + BatchNorm + LeakyReLU (reference ConvBlock,
    src/models/MLSTM_FCN.py:36-44)."""

    def __init__(self, in_channels: int, channels: int, kernel: int, stride: int,
                 alpha: float, dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.alpha, self.dtype = alpha, dtype
        self.Conv_0 = Conv1d(in_channels, channels, kernel, stride, "VALID", dtype, generator)
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x), train)
        return F.leaky_relu(x, negative_slope=self.alpha).to(self.dtype)


class MLSTMFCN(nn.Module):
    def __init__(self, n_features: int = 18, fcn_dim: int = 128, kernel_size: int = 5,
                 stride: int = 1, seq_len: int = 21, lstm_dim: int = 128,
                 lstm_n_layers: int = 1, lstm_bidirectional: bool = True,
                 lstm_dropout: float = 0.1, reduction: int = 16, alpha: float = 1.0,
                 n_classes: int = 2, noise_std: float = 1e-3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.noise = NoiseLayer(std=noise_std)
        self.fcn1 = _ConvBlock(n_features, fcn_dim, kernel_size, stride, alpha, dtype,
                               generator)
        self.se1 = SqueezeExcite1D(fcn_dim, reduction, dtype, generator)
        self.fcn2 = _ConvBlock(fcn_dim, 2 * fcn_dim, kernel_size, stride, alpha, dtype,
                               generator)
        self.se2 = SqueezeExcite1D(2 * fcn_dim, reduction, dtype, generator)
        self.rnn = BiLSTM(n_features, lstm_dim, lstm_n_layers, lstm_bidirectional, generator)
        rnn_out = lstm_dim * (2 if lstm_bidirectional else 1)
        self.pool = AttentionPool(rnn_out, lstm_dim, dtype, generator)
        feat = rnn_out + 2 * fcn_dim
        self.converter = Dense(feat, feat, generator=generator)
        self.head = MLPHead(feat, feat // 2, n_classes, norm="batch", act="leaky_relu",
                            alpha=alpha, generator=generator)

    def _encode(self, x: torch.Tensor, train: bool,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.noise(x, train, noise_generator).to(self.dtype)
        h_rnn = self.pool(self.rnn(x))                         # (B, rnn_out)
        f = self.se1(self.fcn1(x, train))
        f = self.se2(self.fcn2(f, train))
        h_fcn = f.mean(dim=1)                                  # (B, 2 * fcn_dim)
        return self.converter(torch.cat([h_rnn, h_fcn.to(h_rnn.dtype)], dim=-1).float())

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of (B, T, F) windows; ``generator`` is unused (no
        dropout), taken for the train step's common call."""
        return self.head(self._encode(x, train, noise_generator), train)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._encode(x, False)
