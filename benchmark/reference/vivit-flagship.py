"""Plain ViViT (factorised space/time, ViViT model 2), f32, for the cells of
the configuration ``vivit-flagship``.

Follows the reference model (Kim et al., Fusion Eng. Des. 200 (2024)
114204; src/models/ViViT.py) as the JAX package defines it: patch
embedding, a spatial cls token and a learnt (1, frames, patches + 1, dim)
positional embedding, a pre-norm spatial transformer over each frame, a
temporal cls token and a pre-norm temporal transformer over the frames'
cls outputs, the cls pooled, and a Dense-LayerNorm-ELU-Dense head. Departures
from the published PyTorch module, all as the JAX package has them:
LayerNorm eps 1e-6, GELU in its tanh form. Every product is computed in f32
with TF32 off, or with fp8 operands for the lower-precision control.

Each window is computed whole: 21 frames through the spatial transformer,
then the temporal one. Nothing here shares work between windows as the
program's sweep does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import _plain as P


def _dims(cfg: dict, image_size: int):
    c = cfg["program_config"]
    n_patches = (image_size // c["patch_size"]) ** 2
    return (c["dim"], c["depth"], c["n_heads"], c["d_head"], c["dim"] * c["scale_dim"],
            c["patch_size"], c["n_frames"], n_patches)


def param_spec(cfg: dict, image_size: int) -> list:
    """(name, shape, init) of every leaf, named as the port's state_dict."""
    D, depth, H, dh, M, p, T, n_patches = _dims(cfg, image_size)
    inner, pix = H * dh, p * p * 3
    normal = lambda fan_in: ("normal", 1.0 / math.sqrt(fan_in))
    spec = [("encoder.patch_embed.weight", (D, pix), normal(pix)),
            ("encoder.patch_embed.bias", (D,), ("zeros",)),
            ("encoder.space_token", (1, 1, D), ("normal", 1.0)),
            ("encoder.temporal_token", (1, 1, D), ("normal", 1.0)),
            ("encoder.pos_embedding", (1, T, n_patches + 1, D), ("normal", 1.0))]
    for t in ("space_transformer", "temporal_transformer"):
        pre = f"encoder.{t}."
        for i in range(depth):
            spec += [(f"{pre}attn_norm_{i}.weight", (D,), ("ones",)),
                     (f"{pre}attn_norm_{i}.bias", (D,), ("zeros",)),
                     (f"{pre}attn_{i}.to_qkv.weight", (3 * inner, D), normal(D)),
                     (f"{pre}attn_{i}.to_out.weight", (D, inner), normal(inner)),
                     (f"{pre}attn_{i}.to_out.bias", (D,), ("zeros",)),
                     (f"{pre}ff_norm_{i}.weight", (D,), ("ones",)),
                     (f"{pre}ff_norm_{i}.bias", (D,), ("zeros",)),
                     (f"{pre}ff1_{i}.weight", (M, D), normal(D)),
                     (f"{pre}ff1_{i}.bias", (M,), ("zeros",)),
                     (f"{pre}ff2_{i}.weight", (D, M), normal(M)),
                     (f"{pre}ff2_{i}.bias", (D,), ("zeros",))]
        spec += [(f"{pre}final_norm.weight", (D,), ("ones",)),
                 (f"{pre}final_norm.bias", (D,), ("zeros",))]
    spec += [("mlp_fc1.weight", (D // 2, D), normal(D)), ("mlp_fc1.bias", (D // 2,), ("zeros",)),
             ("mlp_ln.weight", (D // 2,), ("ones",)), ("mlp_ln.bias", (D // 2,), ("zeros",)),
             ("mlp_fc2.weight", (2, D // 2), normal(D // 2)), ("mlp_fc2.bias", (2,), ("zeros",))]
    return spec


def _attention(w, pre, x, H, dh, prec):
    B, N, _ = x.shape
    q, k, v = (t.reshape(B, N, H, dh).transpose(1, 2)
               for t in P.dense(x, w[pre + "to_qkv.weight"], None, prec).chunk(3, dim=-1))
    scores = P.operand(q, prec) @ P.operand(k, prec).transpose(-1, -2) * dh ** -0.5
    out = P.operand(torch.softmax(scores, dim=-1), prec) @ P.operand(v, prec)
    out = out.transpose(1, 2).reshape(B, N, H * dh)
    return P.dense(out, w[pre + "to_out.weight"], w[pre + "to_out.bias"], prec)


def _transformer(w, pre, x, depth, H, dh, prec):
    for i in range(depth):
        a = P.layer_norm(x, w[f"{pre}attn_norm_{i}.weight"], w[f"{pre}attn_norm_{i}.bias"])
        x = x + _attention(w, f"{pre}attn_{i}.", a, H, dh, prec)
        f = P.layer_norm(x, w[f"{pre}ff_norm_{i}.weight"], w[f"{pre}ff_norm_{i}.bias"])
        f = P.gelu(P.dense(f, w[f"{pre}ff1_{i}.weight"], w[f"{pre}ff1_{i}.bias"], prec))
        x = x + P.dense(f, w[f"{pre}ff2_{i}.weight"], w[f"{pre}ff2_{i}.bias"], prec)
    return P.layer_norm(x, w[f"{pre}final_norm.weight"], w[f"{pre}final_norm.bias"])


def logits(w: dict, clips: torch.Tensor, cfg: dict, prec: str = "f32") -> torch.Tensor:
    """(B, T, H, W, 3) normalised f32 clips -> (B, 2) logits."""
    B, T, Hh, Ww, C = clips.shape
    D, depth, H, dh, _, p, _, _ = _dims(cfg, Hh)
    x = clips.reshape(B, T, Hh // p, p, Ww // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(B, T, -1, p * p * C)
    x = P.dense(x, w["encoder.patch_embed.weight"], w["encoder.patch_embed.bias"], prec)
    x = torch.cat([w["encoder.space_token"].expand(B, T, 1, D), x], dim=2)
    x = x + w["encoder.pos_embedding"][:, :T, :x.shape[2]]
    x = _transformer(w, "encoder.space_transformer.", x.reshape(B * T, -1, D), depth, H, dh, prec)
    x = torch.cat([w["encoder.temporal_token"].expand(B, 1, D), x[:, 0].reshape(B, T, D)], dim=1)
    x = _transformer(w, "encoder.temporal_transformer.", x, depth, H, dh, prec)[:, 0]
    x = P.layer_norm(P.dense(x, w["mlp_fc1.weight"], w["mlp_fc1.bias"], prec),
                     w["mlp_ln.weight"], w["mlp_ln.bias"])
    return P.dense(F.elu(x), w["mlp_fc2.weight"], w["mlp_fc2.bias"], prec)


@torch.no_grad()
def probs(w: dict, frames_u8: torch.Tensor, idx: torch.Tensor, cfg: dict, prec: str = "f32",
          block: int = 16, calib_u8: torch.Tensor = None) -> torch.Tensor:
    """Disruption probability softmax[:, 0] of the windows ``frames_u8[idx]``
    ((K, T) frame indices into (frames, H, W, 3) uint8), ``block`` windows at
    a time. ViViT has no statistics to calibrate."""
    with P.exact_f32():
        out = [torch.softmax(logits(w, P.normalise(frames_u8[idx[i:i + block]]), cfg, prec),
                             -1)[:, 0]
               for i in range(0, idx.shape[0], block)]
    return torch.cat(out)


def train(w0: dict, batches: list, cfg: dict, cell: dict, prec: str = "f32") -> dict:
    """``len(batches)`` steps of the cell's train step from the weights
    ``w0``: crop and normalise, the forward with dropout 0, the Focal loss,
    backward, optax's clipped AdamW. Returns each step's loss, the first
    step's logits and clipped gradient and the parameters after the last step."""
    opt = cell["optimizer"]
    adam = P.AdamW(opt["lr"], opt["max_norm_grad"], opt["step_size"] * cell["steps_per_epoch"],
                   opt["gamma"])
    params = {k: v.detach().clone() for k, v in w0.items()}
    losses, grads1, logits1 = [], None, None
    with P.exact_f32():
        for clips_u8, labels in batches:
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            x = P.normalise(P.centre_crop(clips_u8, cell["image_size"]))
            out = logits(leaves, x, cfg, prec)
            if logits1 is None:
                logits1 = out.detach()
            loss = P.focal_loss(out, labels, cell["loss"]["focal_gamma"])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            params = {k: v.detach() for k, v in leaves.items()}
            g = adam.step(params, grads)
            if grads1 is None:
                grads1 = g
            losses.append(loss.item())
    return {"logits1": logits1, "losses": losses, "grads1": grads1, "params": params}
