"""The synthetic shot library: camera frames made on the device from the seed.

A torch copy of the frames of ``kstar_torch/data/synthetic.py make_shot`` at
difficulty 0: a radial glow under a mean-brightness profile (dark, startup
ramp, flat top with a slow swing, a pre-quench flash on a disruptive shot or
a ramp-down on a normal one, dark), plus Gaussian pixel noise, clipped to
uint8. Every seed gets the same shot lengths (``lengths``), and the closed
loop takes them in one fixed pattern of arrivals (``order``); the seed draws
which shot has which length, and so the pixels of each shot in the order,
but never the amount of work in a window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GEN_BLOCK = 512                 # frames drawn per call: bounds the f32 noise buffer


def seed_for(seed: int, *stream: int) -> int:
    """A 63-bit seed for a torch or numpy generator, from the run's seed and
    a stream index (each use of randomness draws from its own stream)."""
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def lengths(params: dict) -> np.ndarray:
    """``n_shots`` lengths spaced evenly in log between ``min_frames`` and
    ``max_frames``, both ends included: a log-uniform law's quantiles."""
    n, lo, hi = params["n_shots"], params["min_frames"], params["max_frames"]
    q = np.arange(n) / (n - 1)
    return np.round(lo * (hi / lo) ** q).astype(np.int64)


def _brightness(n: int, disrupt: bool, rng: np.random.Generator) -> np.ndarray:
    """make_shot's mean-brightness curve (``_brightness_profile`` and
    ``_brightness_profile_normal``): startup at 10%, cutoff at 92%."""
    startup, cutoff = int(0.1 * n), int(0.92 * n)
    b = np.full(n, 8.0)
    ramp = min(startup + 10, n)
    b[startup:ramp] = np.linspace(10, 80, ramp - startup)
    if disrupt:
        b[ramp:cutoff] = 80 + 10 * np.sin(np.linspace(0, 6, max(cutoff - ramp, 1)))
        flash = max(cutoff - 5, 0)
        b[flash:cutoff] = np.linspace(120, 220, cutoff - flash)
    else:
        rd = max(cutoff - 24, ramp)
        b[ramp:rd] = 80 + 10 * np.sin(np.linspace(0, 6, max(rd - ramp, 1)))
        b[rd:cutoff] = np.linspace(b[rd - 1] if rd > 0 else 80.0, 10.0, cutoff - rd)
    b[cutoff:] = 6.0
    return b + rng.normal(0, 2, n)


@dataclass
class Library:
    frames: torch.Tensor          # (sum of lengths, crop, crop, 3) uint8, shots end to end
    offsets: np.ndarray           # first frame of each shot
    lengths: np.ndarray
    disrupt: np.ndarray           # bool per shot
    cutoff: np.ndarray            # the quench frame of each shot

    def shot(self, i: int) -> torch.Tensor:
        o = int(self.offsets[i])
        return self.frames[o:o + int(self.lengths[i])]

    def windows(self, i: int, seq_len: int) -> int:
        """Stride-1 windows of shot i: window s covers frames s+1 .. s+L."""
        return max(int(self.lengths[i]) - seq_len, 0)

    def clip_index(self, shots, starts, seq_len: int) -> torch.Tensor:
        """(K, L) rows of ``frames`` of the windows (shot, start)."""
        base = torch.as_tensor(self.offsets[np.asarray(shots)] + np.asarray(starts) + 1)
        return (base[:, None] + torch.arange(seq_len)[None, :]).to(self.frames.device)


def make(params: dict, seed: int, device, crop: int | None = None) -> Library:
    """The library of ``params`` (``n_shots``, ``min_frames``, ``max_frames``,
    ``frame_size``, ``noise_std``, ``disrupt_share``) for ``seed``, centre
    cropped to ``crop`` as the sweep's ``upload_shot`` crops."""
    size = params["frame_size"]
    crop = crop or size
    rng = np.random.default_rng(seed_for(seed, 1))
    lens = lengths(params)[rng.permutation(params["n_shots"])]
    disrupt = rng.random(len(lens)) < params["disrupt_share"]
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    frames = torch.empty((int(lens.sum()), crop, crop, 3), dtype=torch.uint8, device=device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    r = torch.sqrt((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
    glow = torch.clamp(1.2 - r / (0.6 * size), 0.05, 1.0)
    y0 = size // 2 - crop // 2
    glow = glow[y0:y0 + crop, y0:y0 + crop, None]
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 2))
    for o, n, d in zip(offsets, lens, disrupt):
        b = torch.as_tensor(_brightness(int(n), bool(d), rng), dtype=torch.float32,
                            device=device)
        for f in range(0, int(n), GEN_BLOCK):
            m = min(GEN_BLOCK, int(n) - f)
            noise = torch.randn((m, size, size, 3), generator=gen, device=device)
            noise = noise[:, y0:y0 + crop, y0:y0 + crop]
            block = b[f:f + m, None, None, None] * glow + params["noise_std"] * noise
            frames[o + f:o + f + m] = torch.clamp(block, 0, 255).to(torch.uint8)
    return Library(frames=frames, offsets=offsets, lengths=lens, disrupt=disrupt,
                   cutoff=(0.92 * lens).astype(np.int64))


ARRIVALS = 0        # the seed of the one pattern of lengths every seed's loop takes


def order(lib: Library):
    """The closed loop's shots, pass after pass: the lengths in one fixed
    mixed pattern, each the shot the seed gave that length."""
    by_length = np.argsort(lib.lengths, kind="stable")
    pattern = np.random.default_rng(ARRIVALS).permutation(len(by_length))
    while True:
        yield from (int(by_length[r]) for r in pattern)
