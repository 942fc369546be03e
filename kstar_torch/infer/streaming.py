"""Real-time streaming prediction: frames in, probabilities out.

Port of ``kstar_tpu/infer/streaming.py``: a device-resident rolling window
buffer takes each arriving frame, the window forward runs in the same step,
and the alarm fires on a threshold crossing after the startup-suppression
window.

Two push modes:

* ``push`` — one frame per step. Frame-to-alarm latency = one step.
* ``push_block`` — ``k`` frames per step (micro-batching). The k overlapping
  windows are gathered on the device from the ring buffer extended by the
  new frames and run as ONE batched forward, so the per-frame cost is
  ``(step overhead + batched compute) / k``. The same values as k sequential
  ``push`` calls (deterministic eval forward). The trade: the alarm for the
  i-th frame of a block is known only after the block completes, so the
  worst-case frame-to-alarm delay is ``(k-1) / fps + step latency``.

The video step gathers and normalises its windows with the window-gather
kernel (ops/preprocess.py). Per block size the extended buffer (and, on the
GPU, a pinned staging buffer for the upload) is allocated once and written
in place.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import FPS
from ..data.augment import center_crop
from ..ops.preprocess import gather_normalize, gather_normalize_reference


class StreamingPredictor:
    """Push frames (or 0D samples) one at a time — or ``block_size`` at a
    time — and get p_disrupt back. ``device=None`` means the GPU (raising
    without one); the model is moved to ``device``.
    ``use_fused_gather=False`` gathers the windows with the plain version
    instead of the kernel."""

    def __init__(self, model, seq_len: int = 21, crop_size: int = 128,
                 threshold: float = 0.5,
                 compute_dtype: torch.dtype = torch.bfloat16, fps: float = FPS,
                 suppress_s: float = 1.0, modality: str = "video",
                 n_features: int = 18, block_size: int = 1,
                 min_dwell_s: float = 0.0, use_fused_gather: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.seq_len = seq_len
        self.crop_size = crop_size
        self.threshold = threshold
        self.compute_dtype = compute_dtype
        self.fps = fps
        self.suppress_n = int(fps * suppress_s)
        self.modality = modality
        self.block_size = int(block_size)
        self.n_frames_seen = 0
        self.alarm_time: Optional[float] = None
        # dwell (hysteresis): the alarm fires only after dwell_n consecutive
        # unsuppressed frames above threshold (offline counterpart:
        # alarm_times(min_dwell_s=...), infer/continuous.py) — dwell 0 keeps
        # the reference's fire-on-first-crossing rule. ceil so the enforced
        # continuous armed time (dwell_n-1)/fps >= min_dwell_s, matching
        # alarm_times' ceil-based k (1e-9 guards exact multiples against
        # float noise).
        self.dwell_n = int(np.ceil(fps * min_dwell_s - 1e-9)) + 1
        self._run = 0

        self._gather = gather_normalize if use_fused_gather else gather_normalize_reference
        if modality == "video":
            self._item_shape, dtype = (crop_size, crop_size, 3), torch.uint8
        else:
            self._item_shape, dtype = (n_features,), torch.float32
        self._buffer = torch.zeros((seq_len, *self._item_shape), dtype=dtype,
                                   device=self.device)
        self._blocks: dict = {}   # k -> (extended buffer, window starts, staging)

    def _block(self, k: int):
        """The preallocated tensors of block size k: the (L+k, ...) extended
        buffer, the k window starts and the host staging buffer (pinned on
        the GPU)."""
        if k not in self._blocks:
            dtype = self._buffer.dtype
            ext = torch.empty((self.seq_len + k, *self._item_shape), dtype=dtype,
                              device=self.device)
            stage = torch.empty((k, *self._item_shape), dtype=dtype,
                                pin_memory=self.device.type == "cuda")
            self._blocks[k] = (ext, torch.arange(k, device=self.device), stage)
        return self._blocks[k]

    def _prep(self, frames: np.ndarray) -> torch.Tensor:
        """Host-side prep of a (k, H, W, 3) frame block / (k, F) samples:
        crop and copy into the block size's staging buffer."""
        frames = np.asarray(frames)
        if self.modality == "video":
            H, W = frames.shape[1], frames.shape[2]
            if H < self.crop_size or W < self.crop_size:
                raise ValueError(f"frames {H}x{W} smaller than crop_size "
                                 f"{self.crop_size}")
            # both axes, as the sweepers' upload_shot: a wide frame
            # (H == crop < W) must not reach the fixed-shape ring buffer
            # uncropped
            frames = center_crop(frames, self.crop_size)
        if frames.shape[1:] != self._item_shape:
            raise ValueError(f"expected a block of {self._item_shape} items, got "
                             f"{frames.shape}")
        stage = self._block(len(frames))[2]
        np.copyto(stage.numpy(), frames, casting="unsafe")
        return stage

    @torch.no_grad()
    def _step(self, host: torch.Tensor) -> np.ndarray:
        """Windows i = ext[i+1 : i+1+seq_len] for i in [0, k): the k
        overlapping stride-1 windows ending at each new frame, gathered on
        the device and run as one batched forward. Ends in the device-to-host
        copy of the k probabilities."""
        k, L = host.shape[0], self.seq_len
        ext, starts, _ = self._block(k)
        ext[:L].copy_(self._buffer)
        ext[L:].copy_(host, non_blocking=True)
        if self.modality == "video":
            x = self._gather(ext, starts, L, self.compute_dtype)
        else:
            x = ext[starts[:, None] + torch.arange(1, L + 1, device=self.device)]
        p = torch.softmax(self.model(x).float(), dim=-1)[:, 0]
        self._buffer.copy_(ext[k:])
        return p.cpu().numpy().astype(np.float64)

    def _account(self, probs: np.ndarray) -> np.ndarray:
        """Per-frame alarm bookkeeping shared by both push modes."""
        alarms = np.zeros(len(probs), dtype=bool)
        floor = max(self.suppress_n, self.seq_len)
        for i, p in enumerate(probs):
            self.n_frames_seen += 1
            suppressed = self.n_frames_seen <= floor
            above = (not suppressed) and p > self.threshold
            self._run = self._run + 1 if above else 0
            alarms[i] = self._run >= self.dwell_n
            if alarms[i] and self.alarm_time is None:
                self.alarm_time = self.n_frames_seen / self.fps
        return alarms

    def push(self, frame: np.ndarray) -> Tuple[float, bool]:
        """Feed one frame / 0D sample. Returns (p_disrupt, alarm_now).

        The first seq_len pushes fill the buffer (probability reported but a
        window of stale zeros contributes); startup suppression zeroes
        alarms within the first second, like the offline path."""
        probs = self._step(self._prep(np.asarray(frame)[None]))
        alarms = self._account(probs)
        return float(probs[0]), bool(alarms[0])

    def push_block(self, frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Feed k frames (video: (k, H, W, 3) uint8; 0D: (k, F)) in ONE
        step. Returns (probs (k,), alarms (k,) bool) — the same values as k
        sequential ``push`` calls. Buffers are kept per block size: use a
        fixed one (``self.block_size`` is the caller's configured default)."""
        probs = self._step(self._prep(frames))
        return probs, self._account(probs)

    def reset(self) -> None:
        self._buffer.zero_()
        self.n_frames_seen = 0
        self.alarm_time = None
        self._run = 0


def choose_block_size(probe_fn, fps: float = FPS,
                      candidates=(1, 2, 4, 8, 16, 32), q: float = 0.99,
                      budget_frac: float = 1.0):
    """Adaptive micro-batch size: the smallest block size k whose measured
    step-time quantile holds the real-time budget.

    A k-frame block arrives every ``k / fps`` seconds; streaming keeps up
    iff the block's step finishes within that window, so the per-frame
    budget (1/fps, 4.76 ms at the camera's 210 fps) is met exactly when
    ``quantile_q(block_time) <= budget_frac * k / fps``. Larger k amortises
    the per-step overhead over more frames but adds (k-1)/fps of block-fill
    wait to the first frame's alarm latency — so the smallest sustaining k
    minimises p50 frame-to-alarm subject to never falling behind the camera.

    ``probe_fn(k)`` must return a sequence of measured block times (seconds)
    at block size k — see ``probe_stream_blocks`` for the predictor-backed
    probe; tests inject synthetic timings.

    Returns ``(k, report)`` where report maps each probed k to
    ``{"q_s": quantile, "budget_s": k/fps*budget_frac, "sustains": bool}``.
    Probing stops at the first sustaining k (candidates must be ascending).
    If no candidate sustains, the largest is returned (best amortisation —
    closest to real time) with every row marked ``sustains: False``.
    """
    report = {}
    for k in candidates:
        times = np.asarray(probe_fn(int(k)), np.float64)
        q_s = float(np.quantile(times, q))
        budget_s = budget_frac * k / fps
        report[int(k)] = {"q_s": q_s, "budget_s": budget_s,
                          "sustains": q_s <= budget_s}
        if q_s <= budget_s:
            return int(k), report
    return int(candidates[-1]), report


def probe_stream_blocks(model, seq_len: int, crop_size: int,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        n_probe: int = 30, device=None, **predictor_kw):
    """Real probe_fn for ``choose_block_size``: builds a StreamingPredictor
    at block size k, then times ``n_probe`` push_block steps on synthetic
    frames (host clock around work that ends in the device-to-host copy of
    the probabilities)."""
    rng = np.random.default_rng(0)

    def probe(k: int):
        sp = StreamingPredictor(model, seq_len=seq_len, crop_size=crop_size,
                                block_size=k, compute_dtype=compute_dtype,
                                device=device, **predictor_kw)
        if predictor_kw.get("modality", "video") == "0D":
            frames = rng.standard_normal(
                (k, predictor_kw.get("n_features", 18))).astype(np.float32)
        else:
            frames = rng.integers(0, 255, size=(k, crop_size, crop_size, 3),
                                  dtype=np.uint8)
        sp.push_block(frames)          # allocate + warm
        times = []
        for _ in range(n_probe):
            t0 = time.perf_counter()
            sp.push_block(frames)
            times.append(time.perf_counter() - t0)
        return times

    return probe
