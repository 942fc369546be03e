"""Plain TFN-GB (Tensor Fusion Network with Gradient Blending heads), f32,
for the cells of the configuration ``tfngb``: the fusion logits a sweep
reads.

Follows the reference model (Kim et al., Fusion Eng. Des. 200 (2024)
114204; src/models/MultiModal.py TFN_GB :246-331, src/models/ViViT.py,
src/models/transformer.py) as the JAX package defines it. Each window is
computed whole, from its raw frames and its 0D rows:

* video: centre crop, the channel means subtracted, patch embedding, a
  spatial cls token and a learnt (1, frames, patches + 1, dim) positional
  embedding, a pre-norm spatial transformer over each frame, a temporal cls
  token and a pre-norm temporal transformer over the frames' cls outputs,
  the cls pooled (the transformer layers are ``vivit-flagship``'s
  reference's);
* 0D: two Conv1d (kernel 5, SAME, no activation between them), BatchNorm
  with the calibrated statistics, ReLU, sinusoidal positions, four
  post-norm layers of causal self-attention and a tanh-GELU feed-forward,
  the mean over time, the connector Dense, LayerNorm and erf GELU;
* fusion: a constant 1 before each latent, their outer product flattened
  ((1 + 128) x (1 + 128) = 16,641), ``cls_fc1`` -> ``cls_bn`` (evaluation,
  the calibrated statistics) -> ReLU -> ``cls_fc2``, softmax.

Departures from the published PyTorch modules, all as the JAX package has
them: LayerNorm eps 1e-6 (torch's 1e-5), GELU in its tanh form inside the
transformers (the 0D connector's is erf, as the reference's ``nn.GELU``),
BatchNorm eps 1e-5 over the running statistics. Dropout and the 0D input
noise are off (evaluation). Every product is computed in f32 with TF32 off,
or with fp8 (bf16) operands for the lower-precision control (its witness).
Nothing here shares work between windows, caches a table or batches
beyond ``block`` windows. ``head_log_odds`` runs the head alone on given
fused features, for the check of the head's own f32.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch
import torch.nn.functional as F

from benchmark.core.spec import load_module
from benchmark.reference import _plain as P

BN_EPS = 1e-5
_V = load_module(Path(__file__).with_name("vivit-flagship.py"), "reference_vivit_flagship")


def _dims(cfg: dict):
    c = cfg["program_config"]
    return c["vivit_kwargs"], c["ts_kwargs"], c["n_classes"]


def param_spec(cfg: dict, image_size: int) -> list:
    """(name, shape, init) of every leaf and statistic, named as the port's
    state_dict (the unimodal heads, which a sweep does not read, too)."""
    vk, tk, n_cls = _dims(cfg)
    vcfg = {"program_config": dict(vk, image_size=image_size)}
    spec = [(f"vis_model.{n}", shape, init) for n, shape, init in _V.param_spec(vcfg, image_size)]
    normal = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    D, Fn, k, M = tk["feature_dims"], tk["n_features"], tk["kernel_size"], tk["dim_feedforward"]
    pre = "ts_model.encoder."
    spec += [(pre + "filter1.weight", (D, Fn, k), normal(Fn * k)),
             (pre + "filter1.bias", (D,), ("zeros",)),
             (pre + "filter2.weight", (D, D, k), normal(D * k)),
             (pre + "filter2.bias", (D,), ("zeros",)),
             (pre + "filter_bn.weight", (D,), ("ones",)),
             (pre + "filter_bn.bias", (D,), ("zeros",)),
             (pre + "filter_bn.running_mean", (D,), ("zeros",)),
             (pre + "filter_bn.running_var", (D,), ("ones",))]
    for i in range(tk["n_layers"]):
        b = f"{pre}block_{i}."
        a = b + "_CausalSelfAttention_0."
        spec += [(a + "qkv.weight", (3 * D, D), normal(D)), (a + "qkv.bias", (3 * D,), ("zeros",)),
                 (a + "proj.weight", (D, D), normal(D)), (a + "proj.bias", (D,), ("zeros",)),
                 (b + "LayerNorm_0.weight", (D,), ("ones",)),
                 (b + "LayerNorm_0.bias", (D,), ("zeros",)),
                 (b + "Dense_0.weight", (M, D), normal(D)), (b + "Dense_0.bias", (M,), ("zeros",)),
                 (b + "Dense_1.weight", (D, M), normal(M)), (b + "Dense_1.bias", (D,), ("zeros",)),
                 (b + "LayerNorm_1.weight", (D,), ("ones",)),
                 (b + "LayerNorm_1.bias", (D,), ("zeros",))]
    C = tk["cls_dims"]
    spec += [(pre + "connector.weight", (D, D), normal(D)), (pre + "connector.bias", (D,), ("zeros",)),
             (pre + "connector_ln.weight", (D,), ("ones",)),
             (pre + "connector_ln.bias", (D,), ("zeros",)),
             ("ts_model.cls_fc1.weight", (C, D), normal(D)), ("ts_model.cls_fc1.bias", (C,), ("zeros",)),
             ("ts_model.cls_ln.weight", (C,), ("ones",)), ("ts_model.cls_ln.bias", (C,), ("zeros",)),
             ("ts_model.cls_fc2.weight", (n_cls, C), normal(C)),
             ("ts_model.cls_fc2.bias", (n_cls,), ("zeros",))]
    fused = (vk["dim"] + 1) * (D + 1)
    spec += [("cls_fc1.weight", (fused // 2, fused), normal(fused)),
             ("cls_fc1.bias", (fused // 2,), ("zeros",)),
             ("cls_bn.weight", (fused // 2,), ("ones",)), ("cls_bn.bias", (fused // 2,), ("zeros",)),
             ("cls_bn.running_mean", (fused // 2,), ("zeros",)),
             ("cls_bn.running_var", (fused // 2,), ("ones",)),
             ("cls_fc2.weight", (n_cls, fused // 2), normal(fused // 2)),
             ("cls_fc2.bias", (n_cls,), ("zeros",))]
    return spec


def _video_latent(w, clips, vk, prec):
    """(B, T, H, W, 3) normalised f32 clips -> (B, dim) pooled temporal cls."""
    B, T, Hh, Ww, C = clips.shape
    D, depth, H, dh, p = vk["dim"], vk["depth"], vk["n_heads"], vk["d_head"], vk["patch_size"]
    pre = "vis_model.encoder."
    x = clips.reshape(B, T, Hh // p, p, Ww // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = P.dense(x.reshape(B, T, -1, p * p * C), w[pre + "patch_embed.weight"],
                w[pre + "patch_embed.bias"], prec)
    x = torch.cat([w[pre + "space_token"].expand(B, T, 1, D), x], dim=2)
    x = x + w[pre + "pos_embedding"][:, :T, :x.shape[2]]
    x = _V._transformer(w, pre + "space_transformer.", x.reshape(B * T, -1, D), depth, H, dh, prec)
    x = torch.cat([w[pre + "temporal_token"].expand(B, 1, D), x[:, 0].reshape(B, T, D)], dim=1)
    return _V._transformer(w, pre + "temporal_transformer.", x, depth, H, dh, prec)[:, 0]


def _conv1d(x, w, b, prec):
    """flax ``nn.Conv`` with SAME padding over (B, T, C)."""
    k = w.shape[-1]
    x = F.pad(P.operand(x, prec).transpose(1, 2), ((k - 1) // 2, k // 2))
    return (F.conv1d(x, P.operand(w, prec)) + b[:, None]).transpose(1, 2)


def _batch_norm(w, stats, name, x, calibrate):
    if calibrate:
        axes = tuple(range(x.dim() - 1))
        stats[name] = (x.mean(axes), x.var(axes, unbiased=False))
    mean, var = stats[name]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w[name + ".weight"] + w[name + ".bias"]


def positions(t: int, d: int) -> torch.Tensor:
    """The (t, d) sinusoidal table (reference PositionalEncoding,
    src/models/transformer.py:10-33), f32."""
    pos = torch.arange(t, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * -(math.log(10000.0) / d))
    pe = torch.zeros(t, d, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)[:, :d // 2]
    return pe.float()


def _causal_attention(w, pre, x, n_heads, prec):
    B, T, D = x.shape
    dh = D // n_heads
    q, k, v = (t.reshape(B, T, n_heads, dh).transpose(1, 2)
               for t in P.dense(x, w[pre + "qkv.weight"], w[pre + "qkv.bias"], prec).chunk(3, -1))
    scores = P.operand(q, prec) @ P.operand(k, prec).transpose(-1, -2) / math.sqrt(dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    attn = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = (P.operand(attn, prec) @ P.operand(v, prec)).transpose(1, 2).reshape(B, T, D)
    return P.dense(out, w[pre + "proj.weight"], w[pre + "proj.bias"], prec)


def _ts_latent(w, stats, rows, tk, prec, calibrate):
    """(B, T, F) scaled 0D rows -> (B, feature_dims) latent."""
    pre = "ts_model.encoder."
    x = _conv1d(rows, w[pre + "filter1.weight"], w[pre + "filter1.bias"], prec)
    x = _conv1d(x, w[pre + "filter2.weight"], w[pre + "filter2.bias"], prec)
    x = F.relu(_batch_norm(w, stats, pre + "filter_bn", x, calibrate))
    x = x + positions(x.shape[1], x.shape[2]).to(x.device)
    for i in range(tk["n_layers"]):
        b = f"{pre}block_{i}."
        a = _causal_attention(w, b + "_CausalSelfAttention_0.", x, tk["n_heads"], prec)
        x = P.layer_norm(x + a, w[b + "LayerNorm_0.weight"], w[b + "LayerNorm_0.bias"])
        f = P.gelu(P.dense(x, w[b + "Dense_0.weight"], w[b + "Dense_0.bias"], prec))
        f = P.dense(f, w[b + "Dense_1.weight"], w[b + "Dense_1.bias"], prec)
        x = P.layer_norm(x + f, w[b + "LayerNorm_1.weight"], w[b + "LayerNorm_1.bias"])
    x = P.dense(x.mean(dim=1), w[pre + "connector.weight"], w[pre + "connector.bias"], prec)
    return F.gelu(P.layer_norm(x, w[pre + "connector_ln.weight"], w[pre + "connector_ln.bias"]))


def fused(w, stats, clips, rows, cfg, prec="f32", calibrate=False):
    """(B, T, H, W, 3) normalised f32 clips and their (B, T, F) 0D rows ->
    (B, (1 + dim) x (1 + feature_dims)) tensor-fusion features, with
    ``filter_bn``'s statistics from ``stats`` (filled in when
    ``calibrate``)."""
    vk, tk, _ = _dims(cfg)
    h_vis = _video_latent(w, clips, vk, prec)
    h_ts = _ts_latent(w, stats, rows, tk, prec, calibrate)
    ones = torch.ones(h_vis.shape[0], 1, device=h_vis.device)
    hv, ht = torch.cat([ones, h_vis], -1), torch.cat([ones, h_ts], -1)
    return (hv[:, :, None] * ht[:, None, :]).reshape(h_vis.shape[0], -1)


def head(w, stats, x, prec="f32", calibrate=False):
    """The fusion head over (B, fused) features -> (B, 2) logits:
    ``cls_fc1`` -> ``cls_bn`` (``stats``, filled in when ``calibrate``) ->
    ReLU -> ``cls_fc2``."""
    h = _batch_norm(w, stats, "cls_bn", P.dense(x, w["cls_fc1.weight"], w["cls_fc1.bias"], prec),
                    calibrate)
    return P.dense(F.relu(h), w["cls_fc2.weight"], w["cls_fc2.bias"], prec)


def logits(w, stats, clips, rows, cfg, prec="f32", calibrate=False):
    """(B, T, H, W, 3) normalised f32 clips and their (B, T, F) 0D rows ->
    (B, 2) fusion logits, with the BatchNorm statistics ``stats`` (filled
    in, layer after layer, when ``calibrate``)."""
    return head(w, stats, fused(w, stats, clips, rows, cfg, prec, calibrate), prec, calibrate)


def _clips(frames_u8, idx, cfg):
    crop = cfg["program_config"]["vivit_kwargs"]["image_size"]
    return P.normalise(P.centre_crop(frames_u8[idx], crop))


@torch.no_grad()
def calibrate(w: dict, clips_u8: torch.Tensor, rows: torch.Tensor, cfg: dict,
              prec: str = "f32") -> dict:
    """``filter_bn``'s and ``cls_bn``'s statistics, each its own input's in
    one forward of the calibration windows (``clips_u8`` (K, T, H, W, 3)
    uint8 and their (K, T, F) rows)."""
    stats = {}
    crop = cfg["program_config"]["vivit_kwargs"]["image_size"]
    with P.exact_f32():
        logits(w, stats, P.normalise(P.centre_crop(clips_u8, crop)), rows, cfg, prec,
               calibrate=True)
    return stats


@torch.no_grad()
def probs(w: dict, frames_u8: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
          ridx: torch.Tensor, cfg: dict, prec: str = "f32", block: int = 16,
          calib: tuple = None, with_fused: bool = False):
    """Disruption probability softmax[:, 0] of the paired windows
    ``frames_u8[idx]`` and ``rows[ridx]`` ((K, T) frame and row indices into
    (frames, H, W, 3) uint8 and (rows, F) f32), ``block`` windows at a time,
    with the statistics calibrated on ``calib`` (clips, rows). With
    ``with_fused``, also the windows' (K, fused) features."""
    stats = calibrate(w, *calib, cfg, prec)
    out, feats = [], []
    with P.exact_f32():
        for i in range(0, idx.shape[0], block):
            x = fused(w, stats, _clips(frames_u8, idx[i:i + block], cfg),
                      rows[ridx[i:i + block]], cfg, prec)
            out.append(torch.softmax(head(w, stats, x, prec), -1)[:, 0])
            if with_fused:
                feats.append(x)
    p = torch.cat(out)
    return (p, torch.cat(feats)) if with_fused else p


@torch.no_grad()
def head_log_odds(w: dict, x: torch.Tensor, prec: str = "f32", block: int = 128) -> torch.Tensor:
    """logit 0 less logit 1 of the fusion head alone over (K, fused)
    features, ``block`` rows at a time, with the head's parameters and
    ``cls_bn``'s running statistics from ``w`` (named as the port's
    state_dict)."""
    stats = {"cls_bn": (w["cls_bn.running_mean"], w["cls_bn.running_var"])}
    with P.exact_f32():
        out = [head(w, stats, x[i:i + block], prec) for i in range(0, x.shape[0], block)]
    z = torch.cat(out)
    return z[:, 0] - z[:, 1]
