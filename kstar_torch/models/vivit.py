"""ViViT — factorized space/time video transformer (ViViT Model 2).

PyTorch port of ``kstar_tpu/models/vivit.py`` (reference src/models/ViViT.py):
patch embedding, learnable (1, T, N+1, dim) positional embedding, per-frame
spatial cls token, spatial transformer over each frame's tokens, temporal
cls token, temporal transformer over T+1 tokens, cls/mean pool, and a
LayerNorm+ELU MLP head.

Numerics follow the JAX module, not torch's defaults:
  * parameters are kept in f32 and cast to the compute ``dtype`` at use, as
    flax's ``Dense(dtype=...)`` does; each product is rounded to ``dtype``
    and the bias is added in ``dtype``;
  * LayerNorm is flax's (eps 1e-6, variance = mean(x^2) - mean^2 clamped at
    0, computed in ``norm_dtype``), not ``torch.nn.LayerNorm`` (eps 1e-5,
    two-pass variance);
  * GELU is the tanh approximation;
  * the residual stream stays in ``dtype``; the head runs in f32.

Submodules carry the flax names (``patch_embed``, ``space_transformer.
attn_0.to_qkv``, ``mlp_fc1`` ...), so ``weights.state_dict_from_flax`` is
a mechanical rename. Public inputs stay channels-last (B, T, H, W, C).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..parallel.comm import copy_to_group, draw_rows, gather_last

# flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so the kept samples have unit variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in training keep each element with probability
    1 - rate and scale the kept ones by 1/(1 - rate). The mask comes from
    ``generator`` (on ``x``'s device), never from torch's global RNG; in a
    data-parallel step, this rank's rows of the global batch's mask
    (``parallel/comm.py draw_rows``)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws its masks from an explicit "
                         "torch.Generator; pass generator=")
    keep = 1.0 - rate
    mask = draw_rows(lambda shape: torch.rand(shape, generator=generator, device=x.device),
                     x.shape) < keep
    return torch.where(mask, x / keep, 0.0)


class Dense(nn.Module):
    """flax ``nn.Dense``: f32 parameters, product and bias in ``dtype``.
    ``weight`` is (out, in) as in ``torch.nn.Linear``. Split over a model
    group (``tp``, set by ``parallel/tp.py shard_state_tp``), it holds its
    rows of ``weight`` and ``bias``, computes those output columns and
    all-gathers them."""

    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        _lecun_normal_(self.weight.data, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_group(x, self.tp.group)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.tp is not None:
            y = gather_last(y, self.tp.group, self.tp.rank, self.tp.size)
        return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``LayerNorm`` semantics: mean-of-squares variance clamped at 0,
    computed and returned in ``dtype``."""
    x = x.to(dtype)
    mean = x.mean(-1, keepdim=True)
    mean2 = (x * x).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.to(dtype)
    return (x - mean) * mul + bias.to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, dtype=self.dtype)


class MHSA(nn.Module):
    """Multi-head self-attention with explicit d_head (reference Attention,
    src/models/ViViT.py:50-91): inner_dim = n_heads*d_head; the output
    projection is skipped iff single head with d_head == dim. With
    ``use_pallas`` the attention core runs the fused CUDA kernel
    (ops/attention.py) — the name is kept from the JAX module.

    ``capture``: None, or a list that each forward of the einsum path
    appends its softmax map to ((B, heads, N, N), in the compute dtype:
    the tensor the JAX module sows for attention rollout). Only
    ``viz.xai.collect_attention`` sets it, for one forward; the result of
    the forward is the same either way."""

    def __init__(self, dim: int, n_heads: int = 3, d_head: int = 64,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, norm_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads, self.d_head = n_heads, d_head
        self.dropout, self.dtype = dropout, dtype
        self.use_pallas, self.norm_dtype = use_pallas, norm_dtype
        self.capture: Optional[list] = None
        inner = n_heads * d_head
        self.project_out = not (n_heads == 1 and d_head == dim)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype,
                            generator=generator)
        if self.project_out:
            self.to_out = Dense(inner, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, _ = x.shape
        h, dh = self.n_heads, self.d_head
        # [q | k | v], each laid out head-major
        q, k, v = (t.reshape(B, N, h, dh).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        scale = dh ** -0.5
        if self.use_pallas:
            if train and torch.is_grad_enabled():
                raise RuntimeError(
                    "ViViT(use_pallas=True) cannot train: the fused-attention "
                    "kernel has no backward (neither has the JAX kernel); train "
                    "with use_pallas=False")
            out = fused_attention(q, k, v, scale)
        else:
            logits = (q @ k.transpose(-1, -2)).to(self.norm_dtype) * scale
            attn = torch.softmax(logits, dim=-1).to(self.dtype)
            if self.capture is not None:
                self.capture.append(attn.detach())
            out = attn @ v
        out = out.transpose(1, 2).reshape(B, N, h * dh)
        if self.project_out:
            out = dropout(self.to_out(out), self.dropout, train, generator)
        return out


class PreNormTransformer(nn.Module):
    """Depth x (PreNorm attention + PreNorm feedforward) with residuals and a
    final LayerNorm (reference Transformer, src/models/ViViT.py:93-109)."""

    def __init__(self, dim: int, depth: int, n_heads: int, d_head: int,
                 mlp_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 norm_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.dropout, self.dtype = depth, dropout, dtype
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", LayerNorm(dim, norm_dtype))
            self.add_module(f"attn_{i}", MHSA(dim, n_heads, d_head, dropout,
                                              dtype, use_pallas, norm_dtype,
                                              generator))
            self.add_module(f"ff_norm_{i}", LayerNorm(dim, norm_dtype))
            self.add_module(f"ff1_{i}", Dense(dim, mlp_dim, dtype=dtype,
                                              generator=generator))
            self.add_module(f"ff2_{i}", Dense(mlp_dim, dim, dtype=dtype,
                                              generator=generator))
        self.final_norm = LayerNorm(dim, norm_dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        sub = self._modules
        for i in range(self.depth):
            a = sub[f"attn_norm_{i}"](x).to(self.dtype)
            x = x + sub[f"attn_{i}"](a, train, generator)
            f = sub[f"ff_norm_{i}"](x).to(self.dtype)
            f = F.gelu(sub[f"ff1_{i}"](f), approximate="tanh")
            f = dropout(f, self.dropout, train, generator)
            f = dropout(sub[f"ff2_{i}"](f), self.dropout, train, generator)
            x = x + f
        return self.final_norm(x).to(self.dtype)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, N, patch*patch*C), token features laid out
    as the reference einops rearrange 'b t c (h p1) (w p2) -> b t (h w)
    (p1 p2 c)'."""
    B, T, H, W, C = x.shape
    hh, ww = H // patch, W // patch
    x = x.reshape(B, T, hh, patch, ww, patch, C)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)               # B T hh ww p1 p2 C
    return x.reshape(B, T, hh * ww, patch * patch * C)


class ViViTEncoder(nn.Module):
    """Encoder emitting the (B, dim) latent (reference ViViTEncoder,
    src/models/ViViT.py:226-299).

    Split into ``embed_frames`` (per-frame patch embedding, independent of
    the frame's offset within a clip) and ``encode_tokens`` (offset-dependent
    positional embedding + transformers); the continuous sweep embeds every
    frame of a shot once and precomputes the spatial-cls table from them.
    """

    def __init__(self, image_size: int = 128, patch_size: int = 16,
                 n_frames: int = 21, dim: int = 128, depth: int = 2,
                 n_heads: int = 4, d_head: int = 64, scale_dim: int = 8,
                 dropout: float = 0.1, embedd_dropout: float = 0.1,
                 pool: str = "cls", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 norm_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size, self.dim, self.pool = patch_size, dim, pool
        self.embedd_dropout, self.dtype = embedd_dropout, dtype
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = Dense(patch_size * patch_size * in_channels, dim,
                                 dtype=dtype, generator=generator)
        normal = lambda *shape: nn.Parameter(
            torch.randn(*shape, generator=generator))
        self.space_token = normal(1, 1, dim)
        self.temporal_token = normal(1, 1, dim)
        self.pos_embedding = normal(1, n_frames, n_patches + 1, dim)
        args = (dim, depth, n_heads, d_head, dim * scale_dim, dropout, dtype,
                use_pallas, norm_dtype, generator)
        self.space_transformer = PreNormTransformer(*args)
        self.temporal_transformer = PreNormTransformer(*args)

    def embed_frames(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) or (T, H, W, C) pixels -> (..., N, dim) patch
        embeddings (no cls token / positional embedding: offset-free)."""
        squeeze = x.dim() == 4
        if squeeze:
            x = x[None]
        x = self.patch_embed(patchify(x.to(self.dtype), self.patch_size))
        return x[0] if squeeze else x

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return x.float()

    def encode_tokens(self, tokens: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, N, dim) embedded patches -> (B, dim) pooled latent. In
        training (``train=True``) the dropout masks come from ``generator``."""
        B, T = tokens.shape[0], tokens.shape[1]
        x = tokens.to(self.dtype)
        cls_s = self.space_token.to(self.dtype).expand(B, T, 1, self.dim)
        x = torch.cat([cls_s, x], dim=2)                        # (B,T,N+1,D)
        x = x + self.pos_embedding[:, :T, : x.shape[2]].to(self.dtype)
        x = dropout(x, self.embedd_dropout, train, generator)

        x = self.space_transformer(x.reshape(B * T, x.shape[2], self.dim), train,
                                   generator)
        x = x[:, 0].reshape(B, T, self.dim)                     # spatial cls

        cls_t = self.temporal_token.to(self.dtype).expand(B, 1, self.dim)
        x = self.temporal_transformer(torch.cat([cls_t, x], dim=1), train,
                                      generator)
        return self._pool(x)

    def spatial_cls(self, tokens: torch.Tensor, offset: int) -> torch.Tensor:
        """Spatial-transformer cls embedding for frames at one in-window
        offset: tokens (T, N, dim) embedded patches -> (T, dim)."""
        T = tokens.shape[0]
        x = tokens.to(self.dtype)
        cls_s = self.space_token.to(self.dtype).expand(T, 1, self.dim)
        x = torch.cat([cls_s, x], dim=1)                        # (T, N+1, D)
        pos = self.pos_embedding[0, offset]
        x = x + pos[None, : x.shape[1]].to(self.dtype)
        return self.space_transformer(x)[:, 0].to(self.dtype)

    def encode_spatial_cls(self, window_cls: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) per-frame spatial cls embeddings -> (B, dim) latent
        (temporal transformer + pool only)."""
        B = window_cls.shape[0]
        x = window_cls.to(self.dtype)
        cls_t = self.temporal_token.to(self.dtype).expand(B, 1, self.dim)
        return self._pool(self.temporal_transformer(torch.cat([cls_t, x], dim=1)))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode_tokens(self.embed_frames(x), train, generator)


class ViViT(nn.Module):
    """Encoder + LayerNorm/ELU MLP head (reference ViViT,
    src/models/ViViT.py:111-224). ``generator`` seeds the flax-default
    initialisation: lecun-normal Dense kernels, zero biases, unit LayerNorm
    scales, and normal(1.0) tokens and positional embedding."""

    def __init__(self, image_size: int = 128, patch_size: int = 16,
                 n_frames: int = 21, n_classes: int = 2, dim: int = 128,
                 depth: int = 2, n_heads: int = 4, d_head: int = 64,
                 scale_dim: int = 8, dropout: float = 0.1,
                 embedd_dropout: float = 0.1, pool: str = "cls",
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False,
                 norm_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.n_heads, self.d_head = n_heads, d_head
        self.dtype, self.use_pallas = dtype, use_pallas
        self.encoder = ViViTEncoder(
            image_size, patch_size, n_frames, dim, depth, n_heads, d_head,
            scale_dim, dropout, embedd_dropout, pool, in_channels, dtype,
            use_pallas, norm_dtype, generator)
        self.mlp_fc1 = Dense(dim, dim // 2, generator=generator)
        self.mlp_ln = LayerNorm(dim // 2)
        self.mlp_fc2 = Dense(dim // 2, n_classes, generator=generator)

    def classify(self, latent: torch.Tensor) -> torch.Tensor:
        return self.mlp_fc2(F.elu(self.mlp_ln(self.mlp_fc1(latent.float()))))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of (B, T, H, W, C) clips. ``train=True`` turns dropout on,
        with its masks drawn from ``generator``; ViViT has no input noise,
        so ``noise_generator`` (the train step's third stream) is unused."""
        return self.classify(self.encoder(x, train, generator))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled latent (also the fusion latent of the GB models)."""
        return self.encoder(x)

    def forward_with_latent(self, x: torch.Tensor, train: bool = False,
                            generator: Optional[torch.Generator] = None):
        """(logits, pooled latent) of one forward: the Gradient-Blending
        fusion models feed the latent to their fusion head."""
        h = self.encoder(x, train, generator)
        return self.classify(h), h

    def embed_frames(self, x: torch.Tensor) -> torch.Tensor:
        """Offset-free per-frame patch embeddings (see ViViTEncoder)."""
        return self.encoder.embed_frames(x)

    def forward_tokens(self, tokens: torch.Tensor, train: bool = False,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits from pre-embedded (B, T, N, dim) patch tokens."""
        return self.classify(self.encoder.encode_tokens(tokens, train, generator))

    def spatial_cls(self, tokens: torch.Tensor, offset: int) -> torch.Tensor:
        """Per-frame spatial cls at one in-window offset (see ViViTEncoder)."""
        return self.encoder.spatial_cls(tokens, offset)

    def forward_spatial_cls(self, window_cls: torch.Tensor) -> torch.Tensor:
        """Logits from precomputed per-frame spatial cls embeddings."""
        return self.classify(self.encoder.encode_spatial_cls(window_cls))
