"""Operations of the R(2+1)D configuration per clip, from its shapes: every
convolution (factorised spatial and temporal, the 1x1x1 shortcuts) and the
head's two Dense layers, 2 x multiply-adds. BatchNorm and activations are
not counted."""

from __future__ import annotations

import math

STAGES = ((32, False), (64, True), (64, True), (128, True))


def _middle(kt, ks, cin, cout):
    return max(int(math.floor(kt * ks * ks * cin * cout / (ks * ks * cin + kt * cout))), 1)


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _factorised(shape, cin, cout, k, stride, stem=False):
    """Operations and output shape (T, H, W) of one factorised convolution."""
    (kt, ks), (st, ss) = k, stride
    mid, tk, tp = (45, 3, 1) if stem else (_middle(kt, ks, cin, cout), kt, kt // 2)
    T, H, W = shape
    H, W = _out(H, ks, ss, ks // 2), _out(W, ks, ss, ks // 2)
    ops = 2 * T * H * W * mid * cin * ks * ks
    T = _out(T, tk, st, tp)
    ops += 2 * T * H * W * cout * mid * tk
    return ops, (T, H, W)


def clip_ops(cfg: dict, image_size: int) -> float:
    c = cfg["program_config"]
    shape = (c["n_frames"], image_size, image_size)
    ops, shape = _factorised(shape, 3, 32, (1, 7), (1, 2), stem=True)
    cin = 32
    for (cout, down), n in zip(STAGES, c["layer_sizes"]):
        for j in range(n):
            s = 2 if down and j == 0 else 1
            a, out = _factorised(shape, cin, cout, (3, 3), (s, s))
            b, out = _factorised(out, cout, cout, (3, 3), (1, 1))
            ops += a + b
            if down and j == 0:
                ops += _factorised(shape, cin, cout, (1, 1), (2, 2))[0]
            shape, cin = out, cout
    return float(ops + 2 * (128 * 64 + 64 * 2))
