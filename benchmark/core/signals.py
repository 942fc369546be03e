"""The shot library's 0D signals: scaled rows made on the device from the seed.

Beside each frame of ``core/library.py``'s library, ``n_signals`` scaled f32
0D signals on the video's clock (one row a frame, the reference's 210 Hz
multimodal table period): per shot and signal a level, a random walk and
white noise; a disruptive shot's signals drift over the ``drift_frames``
frames before its quench, as its brightness flashes there, and hold after
it. The rows lie end to end in the library's shot order, at its offsets.
"""

from __future__ import annotations

import torch

from .library import seed_for

STREAM = 6                      # the signals' random stream (library.seed_for)


def make(lib, params: dict, seed: int, device) -> torch.Tensor:
    """(sum of the library's lengths, ``n_signals``) f32 rows on ``device``
    for the parameters ``n_signals``, ``walk_std`` (the walk's spread at a
    shot's end), ``noise_std``, ``drift`` and ``drift_frames``."""
    n, f = int(lib.lengths.sum()), params["n_signals"]
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, STREAM))
    steps = torch.randn((n, f), generator=gen, device=device)
    noise = torch.randn((n, f), generator=gen, device=device)
    levels = torch.randn((len(lib.lengths), f), generator=gen, device=device)
    signs = torch.randn((len(lib.lengths), f), generator=gen, device=device).sign()
    rows = torch.empty((n, f), dtype=torch.float32, device=device)
    for i, (o, t) in enumerate(zip(lib.offsets, lib.lengths)):
        o, t = int(o), int(t)
        walk = steps[o:o + t].cumsum(0) * (params["walk_std"] / t ** 0.5)
        x = levels[i] + walk + params["noise_std"] * noise[o:o + t]
        if lib.disrupt[i]:
            c = int(lib.cutoff[i])
            a = max(c - params["drift_frames"], 0)
            ramp = torch.linspace(0.0, 1.0, c - a, device=device)[:, None]
            x[a:c] += params["drift"] * signs[i] * ramp
            x[c:] += params["drift"] * signs[i]
        rows[o:o + t] = x
    return rows
