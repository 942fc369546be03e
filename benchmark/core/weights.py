"""Random weights made on the device from the seed, in one draw.

A reference's ``param_spec`` lists each leaf as (name, shape, init), init one
of ``("normal", std)``, ``("zeros",)`` or ``("ones",)``. All normal leaves
come from one ``torch.randn`` on the device, carved into the leaves and
scaled. The leaves are f32, the type the configurations keep them in.
"""

from __future__ import annotations

import math

import torch

from .library import seed_for

STREAM = 10                     # the weights' random stream (core/library.py seed_for)


def make(spec: list, seed: int, device) -> dict:
    normal = [(name, shape, init[1]) for name, shape, init in spec if init[0] == "normal"]
    total = sum(math.prod(shape) for _, shape, _ in normal)
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, STREAM))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, o = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[o:o + n].view(shape) * std
        o += n
    for name, shape, init in spec:
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
    return out
