"""CnnLSTM 0D classifier (port of ``kstar_tpu/models/cnn_lstm.py``, a
rebuild of reference src/models/CnnLSTM.py).

Input noise -> two Conv1d over time (channels = conv_dim) -> BatchNorm ->
ReLU -> bidirectional LSTM OVER THE CHANNEL AXIS (a reference quirk: the
conv output (B, C, T') is fed to the LSTM as C tokens of feature size T',
reference src/models/CnnLSTM.py:51,99, so the LSTM's input size is T', not
conv_dim) -> attention pooling -> MLP head (BatchNorm, ReLU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import AttentionPool, BatchNorm, BiLSTM, Conv1d, MLPHead, NoiseLayer


class CnnLSTM(nn.Module):
    def __init__(self, seq_len: int = 21, n_features: int = 18, conv_dim: int = 64,
                 conv_kernel: int = 3, conv_stride: int = 1, conv_padding: int = 1,
                 lstm_dim: int = 128, n_layers: int = 4, bidirectional: bool = True,
                 n_classes: int = 2, noise_std: float = 1e-3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.noise = NoiseLayer(std=noise_std)
        self.conv1 = Conv1d(n_features, conv_dim, conv_kernel, conv_stride, conv_padding,
                            dtype=dtype, generator=generator)
        self.conv2 = Conv1d(conv_dim, conv_dim, conv_kernel, conv_stride, conv_padding,
                            dtype=dtype, generator=generator)
        self.bn = BatchNorm(conv_dim)
        t_out = self.conv2.out_len(self.conv1.out_len(seq_len))
        self.lstm = BiLSTM(t_out, lstm_dim, n_layers, bidirectional, generator)
        out_dim = lstm_dim * (2 if bidirectional else 1)
        self.pool = AttentionPool(out_dim, lstm_dim, dtype, generator)
        self.head = MLPHead(out_dim, out_dim // 2, n_classes, norm="batch", act="relu",
                            generator=generator)

    def _encode(self, x: torch.Tensor, train: bool,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.noise(x, train, noise_generator).to(self.dtype)
        x = self.conv2(self.conv1(x))
        x = F.relu(self.bn(x, train)).to(self.dtype)      # (B, T', C)
        h = self.lstm(x.transpose(1, 2))                   # C tokens of size T'
        return self.pool(h).float()                        # (B, D_out)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of (B, T, F) windows; ``generator`` is unused (no
        dropout), taken for the train step's common call."""
        return self.head(self._encode(x, train, noise_generator), train)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._encode(x, False)
