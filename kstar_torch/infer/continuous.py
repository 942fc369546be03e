"""Continuous whole-shot disruption-probability sweeps (video and 0D).

Port of the video and 0D parts of ``kstar_tpu/infer/continuous.py``
(``MultiModalSweeper`` waits for the fusion models, ROADMAP.md Queue 1
item 12). A shot's frames (centre-cropped) or its 0D table are uploaded to
the device once; windows are gathered on the device (raw frames by the
window-gather kernel, ops/preprocess.py; ViViT's cls table and 0D tables
with a (B, L) index matrix); the sweep runs over fixed-size window chunks,
bucketed so that ragged shot lengths give a handful of shapes (CUDA graphs
will want them fixed).
``sweep_shots`` sweeps a shot library in groups that fit a device-memory
budget.

ViViT gets the two exact fast paths of the JAX sweep: per-frame patch
embeddings are computed once per shot, and the spatial transformer, which
depends only on (frame, in-window offset), is precomputed as the
(offset x frame) cls table by the spatial-table kernel
(ops/spatial_table.py), so each window runs only the temporal transformer.

Output alignment and startup suppression follow the reference:
  * video (generate_prob_curve, src/utils/utility.py:896-977):
    prob = [0]*(seq_len + frame_srt) + probs[1:-1]; zero any p >= 0.5 in
    the first second; time axis = arange(n)/fps;
  * 0D (generate_prob_curve_from_0D :979-1066): the scaler refit on the
    shot itself; prob = [0]*(frame_srt + seq_len) + probs[1:] + [0]*seq_len
    with frame_srt = int(t_start*fps/interval); suppression within fps*1
    samples; linear interpolation x interval to the frame rate; backward
    moving average k=12, clipped to [0, 1].
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import FPS, PIXEL_MEAN_BGR
from ..ops.preprocess import gather_normalize
from ..ops.spatial_table import (extract_spatial_weights, spatial_table,
                                 spatial_table_reference)


def moving_average(x: np.ndarray, k: int, method: str = "backward") -> np.ndarray:
    """Moving-average smoothing, clipped to [0, 1]
    (reference moving_avarage_smoothing, src/utils/utility.py:872-893).

    backward: S[t] = mean(x[:t+1]) for t < k else sum(x[t-k:t]) / k
    (excludes x[t]); center: expanding head/tail means with a [t-hw, t+hw)
    body — one float64 cumulative sum."""
    n = len(x)
    if n == 0:
        return np.zeros(0)
    c = np.concatenate([[0.0], np.cumsum(np.asarray(x, np.float64))])
    t = np.arange(n)
    head = c[t + 1] / (t + 1)                       # mean(x[:t+1])
    if method == "backward":
        lo = np.maximum(t - k, 0)
        s = np.where(t < k, head, (c[t] - c[lo]) / k)
    else:
        hw = k // 2
        lo = np.maximum(t - hw, 0)
        hi = np.minimum(t + hw, n)
        body = (c[hi] - c[lo]) / np.maximum(hi - lo, 1)  # mean(x[t-hw:t+hw])
        tail = (c[n] - c[lo]) / np.maximum(n - lo, 1)    # mean(x[t-hw:])
        s = np.where(t < hw, head, np.where(t < n - hw, body, tail))
    return np.clip(s, 0, 1)


def startup_suppression(probs: np.ndarray, n_samples: int) -> np.ndarray:
    """Zero p >= 0.5 within the first second of the shot (reference
    src/utils/utility.py:957-960): the plasma-startup flash false positive."""
    out = probs.copy()
    head = out[:n_samples]
    head[head >= 0.5] = 0.0
    out[:n_samples] = head
    return out


def bucket_len(n: int) -> int:
    """Sub-octave shape bucket: smallest of {2^k, 1.25*2^k, 1.5*2^k} >= n
    (padding waste at most 33%)."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    for b in (5 * p // 8, 3 * p // 4, p):
        if b >= n:
            return b
    return p


def chunkify_starts(starts: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad window starts to a sub-octave chunk-count bucket (bucket_len) and
    reshape to (n_buck, B)."""
    n = len(starts)
    n_chunks = max((n + batch_size - 1) // batch_size, 1)
    n_buck = bucket_len(n_chunks)
    padded = np.zeros(n_buck * batch_size, np.int64)
    padded[:n] = starts
    return padded.reshape(n_buck, batch_size)


def _make_cls_table_fn(model, seq_len: int, compute_dtype, use_kernel: bool = True):
    """``tokens (T, N-1, D) -> (L, T, D)`` spatial-cls-table closure.

    ``spatial_table`` launches the CUDA kernel for tokens on the GPU (and
    raises for a shape it does not take) and runs the plain version for
    tokens on the CPU; ``use_kernel=False`` takes the plain version on any
    device."""
    weights = extract_spatial_weights(model, seq_len, depth=model.depth,
                                      dtype=compute_dtype)
    table_fn = spatial_table if use_kernel else spatial_table_reference

    def cls_table(tokens):
        tokens_cls = torch.nn.functional.pad(tokens, (0, 0, 1, 0))  # zero cls row
        return table_fn(tokens_cls, weights, seq_len, depth=model.depth,
                        n_heads=model.n_heads, d_head=model.d_head,
                        compute_dtype=compute_dtype)

    return cls_table


class VideoSweeper:
    """Stride-1 sliding-window sweep over device-resident frames.

    The shot is cropped and uploaded once; per chunk of B windows the sweep
    gathers the windows on the device, runs the forward and takes the
    disruption probability softmax[:, 0]. ``device=None`` means the GPU
    (raising without one); the model is moved to ``device``.
    ``use_fused_table=False`` computes the spatial-cls table with the plain
    version instead of the kernel.
    """

    def __init__(self, model, seq_len: int, crop_size: int, batch_size: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_table: bool = True, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.seq_len, self.crop_size = seq_len, crop_size
        self.batch_size, self.compute_dtype = batch_size, compute_dtype
        # window s covers frames [s+1, s+L]: frame s+1+k sits at offset k
        self._offsets = torch.arange(1, seq_len + 1, device=self.device)
        # uint8 values and the integer channel means are exact in bf16, so
        # normalising directly in the compute dtype is lossless
        self._mean = torch.tensor(PIXEL_MEAN_BGR, dtype=compute_dtype,
                                  device=self.device)
        self._use_tokens = hasattr(model, "spatial_cls")
        if self._use_tokens:
            self._cls_table = _make_cls_table_fn(self.model, seq_len, compute_dtype,
                                                 use_fused_table)
        self._frames_dev = None

    def _normalize(self, frames_u8: torch.Tensor) -> torch.Tensor:
        return frames_u8.to(self.compute_dtype) - self._mean

    @torch.no_grad()
    def embed_tokens(self, frames_dev: torch.Tensor) -> torch.Tensor:
        """(T, h, w, C) uint8 on the device -> (T, N-1, D) patch embeddings."""
        return self.model.embed_frames(self._normalize(frames_dev))

    @torch.no_grad()
    def embed_all(self, frames_dev: torch.Tensor) -> torch.Tensor:
        """Per-shot preprocessing: the (L, T, D) spatial-cls table (ViViT),
        or the frames themselves for a model without the token path."""
        if not self._use_tokens:
            return frames_dev
        return self._cls_table(self.embed_tokens(frames_dev))

    @torch.no_grad()
    def chunk_probs(self, data: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """p_disrupt for the windows starting at ``starts`` (B,)."""
        if self._use_tokens:
            idx = torch.clamp(starts[:, None] + self._offsets[None, :], 0,
                              data.shape[1] - 1)
            off_idx = torch.arange(self.seq_len, device=self.device)[None, :]
            logits = self.model.forward_spatial_cls(data[off_idx, idx])  # (B, L, D)
        else:
            # raw frames: the window-gather kernel (ops/preprocess.py)
            logits = self.model(gather_normalize(data, starts, self.seq_len,
                                                 self.compute_dtype))  # (B, L, h, w, C)
        return torch.softmax(logits.float(), dim=-1)[:, 0]

    @torch.no_grad()
    def sweep_table(self, data: torch.Tensor, starts: np.ndarray) -> np.ndarray:
        """All windows over preprocessed ``data`` (``embed_all``'s output)."""
        n = len(starts)
        if n == 0:
            return np.zeros(0, np.float32)
        chunks = torch.from_numpy(chunkify_starts(starts, self.batch_size)).to(self.device)
        return self._sweep_chunks(data, chunks).cpu().numpy()[:n]

    def _sweep_chunks(self, data: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
        """(n_buck, B) window starts on the device -> (n_buck * B,) p_disrupt."""
        return torch.cat([self.chunk_probs(data, c) for c in chunks])

    def load_shot(self, frames_u8: np.ndarray) -> torch.Tensor:
        """Crop, upload once and preprocess (ViViT: embed + cls table)."""
        self._frames_dev = self.embed_all(self.upload_shot(frames_u8))
        return self._frames_dev

    def sweep(self, frames_u8: Optional[np.ndarray], starts: np.ndarray) -> np.ndarray:
        """Run all window starts; returns p_disrupt per window. Pass
        frames_u8=None to reuse the previously loaded shot."""
        if frames_u8 is not None:
            self.load_shot(frames_u8)
        return self.sweep_table(self._frames_dev, starts)

    def upload_shot(self, frames_u8: np.ndarray) -> torch.Tensor:
        """Centre-crop on the host and upload the raw uint8 frames."""
        return torch.from_numpy(self._crop(frames_u8)).to(self.device)

    def _crop(self, frames_u8: np.ndarray) -> np.ndarray:
        H, W = frames_u8.shape[1], frames_u8.shape[2]
        y0 = H // 2 - self.crop_size // 2
        x0 = W // 2 - self.crop_size // 2
        return np.ascontiguousarray(
            frames_u8[:, y0:y0 + self.crop_size, x0:x0 + self.crop_size, :])

    def sweep_device(self, frames_dev: torch.Tensor, starts: np.ndarray) -> np.ndarray:
        """Whole-shot sweep including the per-shot preprocessing (embedding
        + spatial table) over device-resident cropped frames."""
        if len(starts) == 0:
            return np.zeros(0, np.float32)
        return self.sweep_table(self.embed_all(frames_dev), starts)

    def _hbm_budget_bytes(self) -> int:
        """Bytes the library stack may occupy in device memory: half the
        free device memory, floored at 512 MB; 4 GB on the CPU (grouping
        granularity only)."""
        if self.device.type != "cuda":
            return 4 << 30
        free, _ = torch.cuda.mem_get_info(self.device)
        return max(free // 2, 512 << 20)

    @torch.no_grad()
    def _sweep_group(self, cropped_list, starts_list, s_pad: int = 0,
                     timings: Optional[dict] = None) -> list:
        """One upload and one download for a group of already-cropped shots:
        pad to the group's half-octave frame/chunk buckets (plus ``s_pad``
        repeats of the last shot so groups share one shape), stack, sweep
        the real shots one by one on the device, slice.

        ``timings``: optional dict accumulating the group's phase walls
        (``host_prep_s`` pad+stack, ``h2d_s`` host->device transfer,
        ``dispatch_s`` sweep+fetch), ``h2d_bytes`` and, per group, the
        shapes of the two stacks it uploaded (``group_shapes``)."""
        t0 = time.perf_counter()
        if s_pad:
            cropped_list = list(cropped_list) + [cropped_list[-1]] * s_pad
            starts_list = list(starts_list) + [starts_list[-1]] * s_pad
        S, n_real = len(cropped_list), len(cropped_list) - s_pad
        B = self.batch_size
        t_buck = bucket_len(max(len(f) for f in cropped_list))
        n_buck = max(bucket_len(max((len(s) + B - 1) // B, 1))
                     for s in starts_list)

        frames_stack = np.empty((S, t_buck) + cropped_list[0].shape[1:], np.uint8)
        chunks_stack = np.zeros((S, n_buck * B), np.int64)
        for i, (cropped, starts) in enumerate(zip(cropped_list, starts_list)):
            frames_stack[i, :len(cropped)] = cropped
            frames_stack[i, len(cropped):] = cropped[-1]      # repeat the last frame
            chunks_stack[i, :len(starts)] = starts
        chunks_stack = chunks_stack.reshape(S, n_buck, B)
        if timings is not None:
            t1 = time.perf_counter()
            timings["host_prep_s"] = timings.get("host_prep_s", 0.0) + t1 - t0
            timings["h2d_bytes"] = (timings.get("h2d_bytes", 0)
                                    + frames_stack.nbytes + chunks_stack.nbytes)
            timings.setdefault("group_shapes", []).append(
                (frames_stack.shape, chunks_stack.shape))
            t0 = t1
        fd = torch.from_numpy(frames_stack).to(self.device)
        cd = torch.from_numpy(chunks_stack).to(self.device)
        if timings is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            timings["h2d_s"] = timings.get("h2d_s", 0.0) + t1 - t0
            t0 = t1
        probs = torch.stack([self._sweep_chunks(self.embed_all(fd[i]), cd[i])
                             for i in range(n_real)]).cpu().numpy()
        if timings is not None:
            timings["dispatch_s"] = (timings.get("dispatch_s", 0.0)
                                     + time.perf_counter() - t0)
        return [probs[i, :len(starts_list[i])] for i in range(n_real)]

    def sweep_shots(self, frames_list, starts_list,
                    hbm_budget_bytes: Optional[int] = None,
                    timings: Optional[dict] = None) -> list:
        """Sweep a whole shot library: shots are cropped on the host, grouped
        so that a group's stacked frames fit the device-memory budget (half
        the free memory by default: stacking hundreds of full-length shots
        unconditionally runs out of memory by construction), and each group
        is uploaded in one transfer — shots padded to a common half-octave
        frame bucket (repeating the last frame) and chunk bucket — swept on
        the device, and the per-shot probability arrays sliced back out.

        Groups are a FIXED size (budget // the library's largest frame
        bucket, capped at bucket_len(S)); a partial final group repeats its
        last shot up to its own shot-count bucket. Shots are packed in
        ascending length order so a group shares a tight frame bucket, and
        the fixed shot count keeps the set of group shapes small. Results
        return in input order."""
        S = len(frames_list)
        if S == 0:
            return []
        cropped_list = [self._crop(frames_u8) for frames_u8 in frames_list]

        budget = hbm_budget_bytes or self._hbm_budget_bytes()
        itembytes = self.crop_size * self.crop_size * 3
        max_buck = max(bucket_len(len(c)) for c in cropped_list)
        s_chunk = max(min(int(budget // (max_buck * itembytes)),
                          bucket_len(S)), 1)
        order = sorted(range(S), key=lambda i: len(cropped_list[i]))
        groups = [order[i:i + s_chunk] for i in range(0, S, s_chunk)]

        out: list = [None] * S
        for g in groups:
            target = s_chunk if len(g) == s_chunk else min(
                bucket_len(len(g)), s_chunk)
            probs = self._sweep_group([cropped_list[i] for i in g],
                                      [starts_list[i] for i in g],
                                      s_pad=target - len(g), timings=timings)
            for i, p in zip(g, probs):
                out[i] = p
        return out


def predict_video_shot(
    model,
    frames_u8: np.ndarray,        # (T, H, W, C) the full shot
    frame_srt: int,
    frame_end: int,
    seq_len: int = 21,
    dist: int = 3,
    crop_size: int = 128,
    batch_size: int = 64,
    fps: float = FPS,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-shot video probability curve (reference generate_prob_curve).

    Returns (time_x, prob): prob[i] is the disruption probability at frame
    i. ``device=None`` means the GPU."""
    # reference slices paths[frame_srt : frame_end + 210]
    sub = frames_u8[frame_srt: frame_end + int(fps)]
    n_windows = max(len(sub) - seq_len - dist, 0)
    starts = np.arange(n_windows, dtype=np.int64)

    sweeper = VideoSweeper(model, seq_len, crop_size, batch_size, compute_dtype,
                           device=device)
    probs = sweeper.sweep(sub, starts)

    prob_list = np.concatenate([
        np.zeros(seq_len + frame_srt, np.float32),
        probs[1:-1] if len(probs) > 2 else probs[:0],
    ])
    prob_list = startup_suppression(prob_list, int(fps * 1))
    time_x = np.arange(len(prob_list)) / fps
    return time_x, prob_list


class TSSweeper:
    """Stride-1 sweep of a 0D model over a device-resident shot table: the
    table is uploaded once, each chunk of ``batch_size`` windows is gathered
    on the device with clipped indices (window s covers rows
    s+1 .. s+tau*(seq_len-1)+1), and the sweep returns softmax[:, 0] cut to
    the window count. The model runs in its own compute dtype.
    ``device=None`` means the GPU (raising without one)."""

    def __init__(self, model, seq_len: int, batch_size: int = 256, tau: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self._offsets = 1 + tau * torch.arange(seq_len, device=self.device)

    @torch.no_grad()
    def chunk_probs(self, data: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(starts[:, None] + self._offsets[None, :], 0, data.shape[0] - 1)
        logits = self.model(data[idx])
        return torch.softmax(logits.float(), dim=-1)[:, 0]

    def sweep(self, data: np.ndarray, starts: np.ndarray) -> np.ndarray:
        """p_disrupt of every window start over a (T, F) table."""
        n = len(starts)
        if n == 0:
            return np.zeros(0, np.float32)
        data_dev = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(self.device)
        chunks = torch.from_numpy(chunkify_starts(starts, self.batch_size)).to(self.device)
        probs = torch.cat([self.chunk_probs(data_dev, c) for c in chunks])
        return probs.cpu().numpy()[:n]


def predict_0d_shot(
    model,
    shot_values: np.ndarray,      # (T, F) raw (unscaled) shot table values
    times: np.ndarray,            # (T,) time column
    scaler,                       # Scaler; refit on this shot (reference quirk,
                                  # utility.py:499 fit_transform even when given)
    seq_len: int = 21,
    dist: int = 3,
    dt: float = 4.0 / 210.0,
    batch_size: int = 256,
    fps: float = FPS,
    smooth_k: int = 12,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-shot 0D probability curve on the frame grid (reference
    generate_prob_curve_from_0D, src/utils/utility.py:979-1066): stride-1
    windows, pad, suppress, linearly re-interpolate to the frame rate,
    backward moving average. Returns (time_x, prob); ``device=None`` means
    the GPU."""
    from ..data.splits import Scaler

    sc = Scaler(scaler.kind if scaler is not None else "Robust").fit(shot_values)
    data = sc.transform(shot_values)

    n_windows = max(len(data) - seq_len - dist, 0)
    starts = np.arange(n_windows, dtype=np.int64)
    probs = TSSweeper(model, seq_len, batch_size, device=device).sweep(data, starts)

    interval = int(round(dt * fps))
    frame_srt = int(float(times[0]) * fps / interval)
    prob_list = np.concatenate([
        np.zeros(frame_srt + seq_len, np.float32),
        probs[1:] if len(probs) > 1 else probs[:0],
        np.zeros(seq_len, np.float32),
    ])
    prob_list = startup_suppression(prob_list, int(fps * 1))

    # linear re-interpolation from the dt grid to the frame grid
    n = len(prob_list)
    prob_x = np.linspace(0, n, num=n, endpoint=True) * (interval / fps)
    fine_x = np.linspace(0, n * interval, num=n * interval, endpoint=True) / fps
    fine = moving_average(np.interp(fine_x, prob_x, prob_list), smooth_k, "backward")
    return np.arange(len(fine)) / fps, fine


# ---------------------------------------------------------------------------
# Alarm logic
# ---------------------------------------------------------------------------

def alarm_times(time_x: np.ndarray, probs: np.ndarray, threshold: float = 0.5,
                t_min: float = 1.0, min_dwell_s: float = 0.0) -> Optional[float]:
    """First time the disruption probability crosses the threshold after the
    startup window (reference utility.py:843-853).

    ``min_dwell_s > 0`` trips the alarm at the END of the first run of
    samples that stays above threshold for ``min_dwell_s`` of continuous
    armed time (``time_x >= t_min``), counted on a uniform time grid (one
    median dt). ``min_dwell_s = 0`` is the reference first-crossing rule."""
    mask = (probs > threshold) & (time_x >= t_min)
    if not mask.any():
        return None
    if min_dwell_s > 0.0:
        if len(time_x) <= 1:
            # a single sample cannot hold a positive continuous dwell
            return None
        dt = float(np.median(np.diff(time_x)))
        # ceil so the continuous armed time (k-1)*dt >= min_dwell_s; the
        # 1e-9 guard keeps exact multiples from ceiling up on float noise
        k = int(np.ceil(min_dwell_s / dt - 1e-9)) + 1 if dt > 0 else 1
        if k > 1:
            if k > len(mask):
                return None
            runs = np.convolve(mask.astype(np.int64),
                               np.ones(k, np.int64), "valid")
            hits = np.flatnonzero(runs == k)
            return float(time_x[hits[0] + k - 1]) if len(hits) else None
    return float(time_x[int(np.argmax(mask))])


def warning_time(t_alarm: Optional[float], t_current_quench: float) -> Optional[float]:
    """Warning margin: how long before the current quench the alarm fired."""
    if t_alarm is None:
        return None
    return t_current_quench - t_alarm
