"""Plain R(2+1)D, f32, for the cells of the configuration ``r2plus1d``.

Follows the reference model (src/models/R2Plus1D.py) as the JAX package
defines it: every 3-D convolution factorised into a spatial (1, k, k) and a
temporal (k, 1, 1) convolution of the reference's middle width, each
followed by BatchNorm and LeakyReLU (0.01); the stem 3 -> 45 -> 32; four
residual stages of ``layer_sizes`` blocks at 32, 64, 64 and 128 channels,
the last three downsampling by 2 in time and space through a factorised
1x1x1 shortcut; global average pool; a Dense-BatchNorm-ELU(0.01)-Dense head.
Convolutions run channels-first through ``F.conv3d`` in f32 with TF32 off,
or with fp8 operands for the lower-precision control.

The backbone's BatchNorm statistics are worked out here from the
calibration clips (``calibrate``): each takes the batch statistics of its
own input in one forward, layer after layer; the head's keep their initial
zeros and ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import _plain as P

BN_EPS = 1e-5
STAGES = ((32, False), (64, True), (64, True), (128, True))   # (channels, downsample)


def _middle(kt: int, ks: int, cin: int, cout: int) -> int:
    """(2+1)D middle width (reference src/models/R2Plus1D.py:150-155)."""
    return max(int(math.floor(kt * ks * ks * cin * cout / (ks * ks * cin + kt * cout))), 1)


def _factorised(pre, cin, cout, k, stride, stem=False):
    """The two convolutions (name, cin, cout, kernel, stride, padding) of a
    factorised (2+1)D convolution."""
    (kt, ks), (st, ss) = k, stride
    if stem:
        mid, tk, tp = 45, 3, 1
    else:
        mid, tk, tp = _middle(kt, ks, cin, cout), kt, kt // 2
    return [(f"{pre}.spatial", cin, mid, (1, ks, ks), (1, ss, ss), (0, ks // 2, ks // 2)),
            (f"{pre}.temporal", mid, cout, (tk, 1, 1), (st, 1, 1), (tp, 0, 0))]


def blocks(cfg: dict) -> list:
    """The backbone as a list of blocks: the stem, then each residual block
    as (its two factorised convolutions, its shortcut or None)."""
    plan = [("stem", _factorised("backbone.conv1", 3, 32, (1, 7), (1, 2), stem=True), None, None)]
    cin = 32
    for s, ((cout, down), n) in enumerate(zip(STAGES, cfg["program_config"]["layer_sizes"])):
        for j in range(n):
            pre = f"backbone.conv{s + 2}.block_{j}"
            stride = 2 if down and j == 0 else 1
            convs = (_factorised(f"{pre}.conv1", cin, cout, (3, 3), (stride, stride))
                     + _factorised(f"{pre}.conv2", cout, cout, (3, 3), (1, 1)))
            short = (_factorised(f"{pre}.shortcut", cin, cout, (1, 1), (2, 2))
                     if down and j == 0 else None)
            plan.append(("block", convs[:2], convs[2:], short))
            cin = cout
    return plan


def convs(cfg: dict) -> list:
    out = []
    for _, a, b, c in blocks(cfg):
        out += a + (b or []) + (c or [])
    return out


def param_spec(cfg: dict, image_size: int) -> list:
    """(name, shape, init) of every leaf and statistic, named as the port's
    state_dict."""
    spec = []
    for name, cin, cout, k, _, _ in convs(cfg):
        spec += [(f"{name}.Conv_0.weight", (cout, cin, *k), ("normal", 1 / math.sqrt(cin * math.prod(k)))),
                 (f"{name}.BatchNorm_0.weight", (cout,), ("ones",)),
                 (f"{name}.BatchNorm_0.bias", (cout,), ("zeros",)),
                 (f"{name}.BatchNorm_0.running_mean", (cout,), ("zeros",)),
                 (f"{name}.BatchNorm_0.running_var", (cout,), ("ones",))]
    spec += [("head.fc1.weight", (64, 128), ("normal", 1 / math.sqrt(128))),
             ("head.fc1.bias", (64,), ("zeros",)),
             ("head.norm.weight", (64,), ("ones",)), ("head.norm.bias", (64,), ("zeros",)),
             ("head.norm.running_mean", (64,), ("zeros",)),
             ("head.norm.running_var", (64,), ("ones",)),
             ("head.fc2.weight", (2, 64), ("normal", 1 / math.sqrt(64))),
             ("head.fc2.bias", (2,), ("zeros",))]
    return spec


def _conv_bn(w, stats, conv, x, prec, calibrate):
    name, _, _, _, stride, pad = conv
    y = F.conv3d(P.operand(x, prec), P.operand(w[f"{name}.Conv_0.weight"], prec),
                 stride=stride, padding=pad)
    if calibrate:
        stats[name] = (y.mean((0, 2, 3, 4)), y.var((0, 2, 3, 4), unbiased=False))
    mean, var = stats[name]
    shape = (1, -1, 1, 1, 1)
    y = ((y - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
         * w[f"{name}.BatchNorm_0.weight"].view(shape) + w[f"{name}.BatchNorm_0.bias"].view(shape))
    return F.leaky_relu(y, 0.01)


def logits(w, stats, clips, cfg, prec="f32", calibrate=False):
    """(B, T, H, W, 3) normalised f32 clips -> (B, 2) logits, with the
    backbone's statistics ``stats`` (filled in when ``calibrate``)."""
    x = clips.permute(0, 4, 1, 2, 3)
    for kind, a, b, short in blocks(cfg):
        res = x
        for conv in a + (b or []):
            res = _conv_bn(w, stats, conv, res, prec, calibrate)
        if kind == "stem":
            x = res
            continue
        if short is not None:
            for conv in short:
                x = _conv_bn(w, stats, conv, x, prec, calibrate)
        x = F.leaky_relu(x + res, 0.01)
    h = P.dense(x.mean(dim=(2, 3, 4)), w["head.fc1.weight"], w["head.fc1.bias"], prec)
    h = ((h - w["head.norm.running_mean"]) * torch.rsqrt(w["head.norm.running_var"] + BN_EPS)
         * w["head.norm.weight"] + w["head.norm.bias"])
    h = torch.where(h > 0, h, 0.01 * torch.expm1(h))
    return P.dense(h, w["head.fc2.weight"], w["head.fc2.bias"], prec)


@torch.no_grad()
def calibrate(w: dict, clips_u8: torch.Tensor, cfg: dict, prec: str = "f32") -> dict:
    stats = {}
    with P.exact_f32():
        logits(w, stats, P.normalise(clips_u8), cfg, prec, calibrate=True)
    return stats


@torch.no_grad()
def probs(w: dict, frames_u8: torch.Tensor, idx: torch.Tensor, cfg: dict, prec: str = "f32",
          block: int = 32, calib_u8: torch.Tensor = None) -> torch.Tensor:
    """Disruption probability softmax[:, 0] of the windows ``frames_u8[idx]``
    ((K, T) frame indices into (frames, H, W, 3) uint8), ``block`` at a time,
    with the statistics calibrated on the clips ``calib_u8``."""
    stats = calibrate(w, calib_u8, cfg, prec)
    with P.exact_f32():
        out = [torch.softmax(logits(w, stats, P.normalise(frames_u8[idx[i:i + block]]), cfg,
                                    prec), -1)[:, 0]
               for i in range(0, idx.shape[0], block)]
    return torch.cat(out)
