"""0D time-series Transformer (port of ``kstar_tpu/models/ts_transformer.py``,
a rebuild of reference src/models/transformer.py).

Input noise -> two Conv1d over time with SAME padding and no activation
between them -> BatchNorm -> ReLU -> sinusoidal positions -> causally masked
post-norm encoder blocks with a tanh-GELU feed-forward -> mean over time ->
connector (Dense, LayerNorm, erf-GELU); the classifier is Dense, LayerNorm,
tanh-GELU, Dense, all in f32 (reference :133-138).

The attention is written out as the JAX module writes it: logits rounded to
the compute dtype, then divided by sqrt(d_head) in f32, the causal mask, an
f32 softmax rounded back, dropout on the probabilities. Submodules carry the
flax names (``encoder.block_0._CausalSelfAttention_0.qkv``, ``LayerNorm_0``,
``Dense_0`` ...), so ``weights.state_dict_from_flax`` is a rename.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv1d, NoiseLayer, gelu_tanh, sinusoidal_positions
from .vivit import Dense, LayerNorm, dropout


class _CausalSelfAttention(nn.Module):
    def __init__(self, feature_dims: int, n_heads: int, dropout: float,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.n_heads, self.dropout, self.dtype = n_heads, dropout, dtype
        self.qkv = Dense(feature_dims, 3 * feature_dims, dtype=dtype, generator=generator)
        self.proj = Dense(feature_dims, feature_dims, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        h = self.n_heads
        dh = D // h
        q, k, v = (t.reshape(B, T, h, dh).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(dh)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        attn = dropout(attn, self.dropout, train, generator)
        out = (attn @ v).transpose(1, 2).reshape(B, T, D)
        return self.proj(out)


class _PostNormBlock(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` default (norm_first=False):
    x = LN(x + attn(x)); x = LN(x + ff(x)), the LayerNorms in f32."""

    def __init__(self, feature_dims: int, n_heads: int, dim_feedforward: int,
                 dropout: float, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self._CausalSelfAttention_0 = _CausalSelfAttention(
            feature_dims, n_heads, dropout, dtype, generator)
        self.LayerNorm_0 = LayerNorm(feature_dims)
        self.Dense_0 = Dense(feature_dims, dim_feedforward, dtype=dtype, generator=generator)
        self.Dense_1 = Dense(dim_feedforward, feature_dims, dtype=dtype, generator=generator)
        self.LayerNorm_1 = LayerNorm(feature_dims)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self._CausalSelfAttention_0(x, train, generator)
        a = dropout(a, self.dropout, train, generator)
        x = self.LayerNorm_0(x + a).to(self.dtype)
        f = gelu_tanh(self.Dense_0(x))
        f = dropout(f, self.dropout, train, generator)
        f = dropout(self.Dense_1(f), self.dropout, train, generator)
        return self.LayerNorm_1(x + f).to(self.dtype)


class TransformerEncoder0D(nn.Module):
    """Encoder producing the (B, feature_dims) latent (reference
    TransformerEncoder, src/models/transformer.py:39-113)."""

    def __init__(self, n_features: int = 18, kernel_size: int = 5,
                 feature_dims: int = 128, max_len: int = 21, n_layers: int = 4,
                 n_heads: int = 8, dim_feedforward: int = 1024, dropout: float = 0.1,
                 noise_std: float = 1e-3, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_dims, self.n_layers, self.dtype = feature_dims, n_layers, dtype
        self.noise = NoiseLayer(std=noise_std)
        self.filter1 = Conv1d(n_features, feature_dims, kernel_size, padding="SAME",
                              dtype=dtype, generator=generator)
        self.filter2 = Conv1d(feature_dims, feature_dims, kernel_size, padding="SAME",
                              dtype=dtype, generator=generator)
        self.filter_bn = BatchNorm(feature_dims)
        for i in range(n_layers):
            self.add_module(f"block_{i}", _PostNormBlock(
                feature_dims, n_heads, dim_feedforward, dropout, dtype, generator))
        self.connector = Dense(feature_dims, feature_dims, dtype=dtype, generator=generator)
        self.connector_ln = LayerNorm(feature_dims)
        self._positions = {}

    def _pe(self, t: int, device) -> torch.Tensor:
        """The (t, D) sinusoidal table in the compute dtype, made once per
        length and device."""
        key = (t, str(device))
        if key not in self._positions:
            self._positions[key] = sinusoidal_positions(t, self.feature_dims).to(
                device=device, dtype=self.dtype)
        return self._positions[key]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.noise(x, train, noise_generator).to(self.dtype)
        x = self.filter2(self.filter1(x))            # no activation between them
        x = F.relu(self.filter_bn(x, train)).to(self.dtype)
        x = x + self._pe(x.shape[1], x.device)[None]
        for i in range(self.n_layers):
            x = self._modules[f"block_{i}"](x, train, generator)
        x = self.connector(x.mean(dim=1))
        return F.gelu(self.connector_ln(x)).float()  # erf GELU (torch nn.GELU)


class Transformer0D(nn.Module):
    """Encoder + classifier (reference Transformer,
    src/models/transformer.py:115-153). ``generator`` seeds the flax-default
    initialisation."""

    def __init__(self, n_features: int = 18, kernel_size: int = 5,
                 feature_dims: int = 128, max_len: int = 21, n_layers: int = 4,
                 n_heads: int = 8, dim_feedforward: int = 1024, dropout: float = 0.1,
                 cls_dims: int = 128, n_classes: int = 2, noise_std: float = 1e-3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = TransformerEncoder0D(
            n_features, kernel_size, feature_dims, max_len, n_layers, n_heads,
            dim_feedforward, dropout, noise_std, dtype, generator)
        self.cls_fc1 = Dense(feature_dims, cls_dims, generator=generator)
        self.cls_ln = LayerNorm(cls_dims)
        self.cls_fc2 = Dense(cls_dims, n_classes, generator=generator)

    def classify(self, latent: torch.Tensor) -> torch.Tensor:
        return self.cls_fc2(gelu_tanh(self.cls_ln(self.cls_fc1(latent))))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of (B, T, F) windows. ``train=True`` turns on the input
        noise (drawn from ``noise_generator``), dropout (from ``generator``)
        and the batch statistics."""
        return self.classify(self.encoder(x, train, generator, noise_generator))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Latent extraction: the classifier's input (the fusion latent)."""
        return self.encoder(x)

    def forward_with_latent(self, x: torch.Tensor, train: bool = False,
                            generator: Optional[torch.Generator] = None,
                            noise_generator: Optional[torch.Generator] = None):
        h = self.encoder(x, train, generator, noise_generator)
        return self.classify(h), h
