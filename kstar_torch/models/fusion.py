"""Multimodal fusion models (port of ``kstar_tpu/models/fusion.py``, a
rebuild of reference src/models/MultiModal.py).

Four variants over the ViViT video encoder and the 0D Transformer encoder:

  * ``MultiModalConcat``: concat the two latents -> connector -> classifier
    (reference MultiModalModel :10-53);
  * ``MultiModalGB``: whole ViViT and Transformer0D classifiers; the forward
    returns the (multi, vis, ts) logits for Gradient Blending, the fusion
    head reading the two encoder latents (``forward_with_latent``);
  * ``TFN``: Tensor Fusion Network, latents (widths capped at 128) each
    given a constant 1 and outer-producted (reference :173-243);
  * ``TFNGB``: TFN with the unimodal heads, triple logits, a BatchNorm in
    its fusion head (reference :246-331).

The reference's ``use_stream`` switch is the explicit methods
``forward_video`` / ``forward_ts`` / ``forward``, as in the JAX package.

Numerics follow the JAX modules: the encoders run in the compute ``dtype``
and hand f32 latents on, the fusion heads (every Dense, LayerNorm and the
BatchNorm) run in f32, and ``_outer_fusion`` runs in the latents' dtype.
Submodules carry the flax names (``encoder_video``, ``encoder_0d``,
``vis_model``, ``ts_model``, ``connector``, ``cls_fc1``, ``cls_ln``,
``cls_bn``, ``cls_fc2``), so ``weights.state_dict_from_flax`` maps a
flax tree leaf by leaf. ``generator`` seeds the flax-default
initialisation; in training, dropout draws from ``generator`` and the 0D
input noise from ``noise_generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm
from .ts_transformer import Transformer0D, TransformerEncoder0D
from .vivit import Dense, LayerNorm, ViViT, ViViTEncoder

_HEAD_KEYS = ("cls_dims", "n_classes", "alpha")
TFN_MAX_DIM = 128        # the TFN variants cap both latent widths (reference :181-185)


def _encoder_kwargs(kwargs: Dict) -> Dict:
    """Encoder variants take the classifier-free subset of the model kwargs."""
    return {k: v for k, v in kwargs.items() if k not in _HEAD_KEYS}


def _capped(vivit_kwargs: Dict, ts_kwargs: Dict):
    vk = dict(vivit_kwargs)
    vk["dim"] = min(vk.get("dim", 128), TFN_MAX_DIM)
    tk = dict(ts_kwargs)
    tk["feature_dims"] = min(tk.get("feature_dims", 128), TFN_MAX_DIM)
    return vk, tk


def _outer_fusion(h_vis: torch.Tensor, h_ts: torch.Tensor) -> torch.Tensor:
    """Tensor fusion: a constant 1 before each latent, the batched outer
    product, flattened (reference TFN.forward, src/models/MultiModal.py:
    217-221): (B, 1 + Dv) x (B, 1 + Dt) -> (B, (1 + Dv) * (1 + Dt))."""
    ones = torch.ones(h_vis.shape[0], 1, dtype=h_vis.dtype, device=h_vis.device)
    hv = torch.cat([ones, h_vis], dim=-1)
    ht = torch.cat([ones, h_ts.to(h_vis.dtype)], dim=-1)
    return (hv[:, :, None] * ht[:, None, :]).reshape(h_vis.shape[0], -1)


class _Fusion(nn.Module):
    """What the four models share: the sweep's fast-path methods, which
    reach the ViViT encoder through ``video_encoder``, and the f32 head
    connector (ReLU) -> cls_fc1 -> cls_ln -> ReLU -> cls_fc2 of all but
    ``TFNGB``."""

    def embed_frames(self, x: torch.Tensor) -> torch.Tensor:
        """Offset-free per-frame patch embeddings (see ViViTEncoder)."""
        return self.video_encoder.embed_frames(x)

    def spatial_cls(self, tokens: torch.Tensor, offset: int) -> torch.Tensor:
        """Per-frame spatial cls at one in-window offset (see ViViTEncoder)."""
        return self.video_encoder.spatial_cls(tokens, offset)

    def _make_head(self, d_in: int, d_connector: int, d_hidden: int, n_classes: int,
                   generator: Optional[torch.Generator]) -> None:
        self.connector = Dense(d_in, d_connector, generator=generator)
        self.cls_fc1 = Dense(d_connector, d_hidden, generator=generator)
        self.cls_ln = LayerNorm(d_hidden)
        self.cls_fc2 = Dense(d_hidden, n_classes, generator=generator)

    def _connect(self, h: torch.Tensor) -> torch.Tensor:
        return F.relu(self.connector(h.float()))

    def _classify(self, h: torch.Tensor) -> torch.Tensor:
        return self.cls_fc2(F.relu(self.cls_ln(self.cls_fc1(h))))


class MultiModalConcat(_Fusion):
    """Concat fusion over the two encoder latents."""

    def __init__(self, vivit_kwargs: Dict, ts_kwargs: Dict, n_classes: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vivit_kwargs, self.ts_kwargs = dict(vivit_kwargs), dict(ts_kwargs)
        self.dtype = dtype
        self.encoder_video = ViViTEncoder(dtype=dtype, generator=generator,
                                          **_encoder_kwargs(vivit_kwargs))
        self.encoder_0d = TransformerEncoder0D(dtype=dtype, generator=generator,
                                               **_encoder_kwargs(ts_kwargs))
        d = vivit_kwargs.get("dim", 128) + ts_kwargs.get("feature_dims", 128)
        self._make_head(d, d // 2, d // 2, n_classes, generator)

    @property
    def video_encoder(self) -> ViViTEncoder:
        return self.encoder_video

    def _fuse(self, h_vis, h_ts):
        return self._connect(torch.cat([h_vis, h_ts], dim=-1))

    def forward(self, x_video: torch.Tensor, x_0d: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h_vis = self.encoder_video(x_video, train, generator)
        h_ts = self.encoder_0d(x_0d, train, generator, noise_generator)
        return self._classify(self._fuse(h_vis, h_ts))

    def encode(self, x_video: torch.Tensor, x_0d: torch.Tensor):
        """(fused latent, video latent, 0D latent) in evaluation mode."""
        h_vis = self.encoder_video(x_video)
        h_ts = self.encoder_0d(x_0d)
        return self._fuse(h_vis, h_ts), h_vis, h_ts

    def forward_spatial_cls(self, win_cls: torch.Tensor, x_0d: torch.Tensor) -> torch.Tensor:
        """Logits from precomputed per-frame spatial cls embeddings (B, L, D)
        and the paired 0D windows (the multimodal sweep's fast path)."""
        h_vis = self.encoder_video.encode_spatial_cls(win_cls)
        return self._classify(self._fuse(h_vis, self.encoder_0d(x_0d)))


class MultiModalGB(_Fusion):
    """Concat fusion with the unimodal heads, for Gradient Blending."""

    def __init__(self, vivit_kwargs: Dict, ts_kwargs: Dict, n_classes: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vivit_kwargs, self.ts_kwargs = dict(vivit_kwargs), dict(ts_kwargs)
        self.dtype = dtype
        self.vis_model = ViViT(n_classes=n_classes, dtype=dtype, generator=generator,
                               **{k: v for k, v in vivit_kwargs.items() if k != "alpha"})
        self.ts_model = Transformer0D(n_classes=n_classes, dtype=dtype,
                                      generator=generator, **ts_kwargs)
        d = vivit_kwargs.get("dim", 128) + ts_kwargs.get("feature_dims", 128)
        self._make_head(d, d // 2, d // 2, n_classes, generator)

    @property
    def video_encoder(self) -> ViViTEncoder:
        return self.vis_model.encoder

    def _fusion_logits(self, h_vis, h_ts):
        return self._classify(self._connect(torch.cat([h_vis, h_ts], dim=-1)))

    def forward(self, x_video: torch.Tensor, x_0d: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None):
        """(multi, vis, ts) logits."""
        out_vis, h_vis = self.vis_model.forward_with_latent(x_video, train, generator)
        out_ts, h_ts = self.ts_model.forward_with_latent(x_0d, train, generator,
                                                         noise_generator)
        return self._fusion_logits(h_vis, h_ts), out_vis, out_ts

    def forward_video(self, x_video: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Video-only stream (reference use_stream='video')."""
        return self.vis_model(x_video, train, generator)

    def forward_ts(self, x_0d: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """0D-only stream (reference use_stream='0D')."""
        return self.ts_model(x_0d, train, generator, noise_generator)

    def encode(self, x_video: torch.Tensor, x_0d: torch.Tensor):
        h_vis = self.vis_model.encode(x_video)
        h_ts = self.ts_model.encode(x_0d)
        return self._connect(torch.cat([h_vis, h_ts], dim=-1)), h_vis, h_ts

    def forward_spatial_cls(self, win_cls: torch.Tensor, x_0d: torch.Tensor) -> torch.Tensor:
        """Fusion logits only, from the spatial cls embeddings."""
        h_vis = self.vis_model.encoder.encode_spatial_cls(win_cls)
        return self._fusion_logits(h_vis, self.ts_model.encoder(x_0d))


class TFN(_Fusion):
    """Tensor Fusion Network (encoder widths capped at 128, reference
    :181-185)."""

    def __init__(self, vivit_kwargs: Dict, ts_kwargs: Dict, n_classes: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vivit_kwargs, self.ts_kwargs = dict(vivit_kwargs), dict(ts_kwargs)
        self.dtype = dtype
        vk, tk = _capped(vivit_kwargs, ts_kwargs)
        self.encoder_video = ViViTEncoder(dtype=dtype, generator=generator,
                                          **_encoder_kwargs(vk))
        self.encoder_0d = TransformerEncoder0D(dtype=dtype, generator=generator,
                                               **_encoder_kwargs(tk))
        d = vk["dim"] + tk["feature_dims"]
        self._make_head((vk["dim"] + 1) * (tk["feature_dims"] + 1), d, d // 2,
                        n_classes, generator)

    @property
    def video_encoder(self) -> ViViTEncoder:
        return self.encoder_video

    def _head(self, fused):
        return self._classify(self._connect(fused))

    def forward(self, x_video: torch.Tensor, x_0d: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h_vis = self.encoder_video(x_video, train, generator)
        h_ts = self.encoder_0d(x_0d, train, generator, noise_generator)
        return self._head(_outer_fusion(h_vis, h_ts))

    def encode(self, x_video: torch.Tensor, x_0d: torch.Tensor):
        h_vis = self.encoder_video(x_video)
        h_ts = self.encoder_0d(x_0d)
        return self._connect(_outer_fusion(h_vis, h_ts)), h_vis, h_ts

    def forward_spatial_cls(self, win_cls: torch.Tensor, x_0d: torch.Tensor) -> torch.Tensor:
        h_vis = self.encoder_video.encode_spatial_cls(win_cls)
        return self._head(_outer_fusion(h_vis, self.encoder_0d(x_0d)))


class TFNGB(_Fusion):
    """TFN with the unimodal heads, for Gradient Blending (reference TFN_GB
    :246-331): the fusion classifier reads the outer product of the two
    penultimate latents through Dense -> BatchNorm -> ReLU -> Dense; the
    forward returns the (multi, vis, ts) logits."""

    def __init__(self, vivit_kwargs: Dict, ts_kwargs: Dict, n_classes: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vivit_kwargs, self.ts_kwargs = dict(vivit_kwargs), dict(ts_kwargs)
        self.dtype = dtype
        vk, tk = _capped(vivit_kwargs, ts_kwargs)
        self.vis_model = ViViT(n_classes=n_classes, dtype=dtype, generator=generator,
                               **{k: v for k, v in vk.items() if k != "alpha"})
        self.ts_model = Transformer0D(n_classes=n_classes, dtype=dtype,
                                      generator=generator, **tk)
        fusion_dim = (vk["dim"] + 1) * (tk["feature_dims"] + 1)
        self.cls_fc1 = Dense(fusion_dim, fusion_dim // 2, generator=generator)
        self.cls_bn = BatchNorm(fusion_dim // 2)
        self.cls_fc2 = Dense(fusion_dim // 2, n_classes, generator=generator)

    @property
    def video_encoder(self) -> ViViTEncoder:
        return self.vis_model.encoder

    def _head(self, fused: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.cls_bn(self.cls_fc1(fused), train)
        return self.cls_fc2(F.relu(x))

    def forward(self, x_video: torch.Tensor, x_0d: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None):
        """(multi, vis, ts) logits; in training the head's BatchNorm moves
        its running statistics."""
        out_vis, h_vis = self.vis_model.forward_with_latent(x_video, train, generator)
        out_ts, h_ts = self.ts_model.forward_with_latent(x_0d, train, generator,
                                                         noise_generator)
        return self._head(_outer_fusion(h_vis, h_ts), train), out_vis, out_ts

    def forward_video(self, x_video: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.vis_model(x_video, train, generator)

    def forward_ts(self, x_0d: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.ts_model(x_0d, train, generator, noise_generator)

    def encode(self, x_video: torch.Tensor, x_0d: torch.Tensor):
        h_vis = self.vis_model.encode(x_video)
        h_ts = self.ts_model.encode(x_0d)
        return _outer_fusion(h_vis, h_ts), h_vis, h_ts

    def forward_spatial_cls(self, win_cls: torch.Tensor, x_0d: torch.Tensor) -> torch.Tensor:
        h_vis = self.vis_model.encoder.encode_spatial_cls(win_cls)
        return self._head(_outer_fusion(h_vis, self.ts_model.encoder(x_0d)), train=False)
