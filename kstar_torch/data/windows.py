"""Pure-function sliding-window index + label generation.

The port's copy of ``kstar_tpu/data/windows.py`` (numpy only), kept so that
``kstar_torch`` imports nothing of the JAX package; ``tests/test_torch_data.py``
holds it against the original.

The three labeling algorithms are the correctness core of the disruption
prediction task (SURVEY.md "hard parts"): each reproduces the reference
semantics exactly, including inclusive-slice and off-by-one details, but as
stateless numpy functions over per-shot arrays instead of torch Datasets.

Window convention used throughout this framework
------------------------------------------------
A window with *start index* ``s`` covers element positions
``[s+1, s+seq_len]`` inclusive — i.e. ``array[s+1 : s+seq_len+1]`` — matching
the reference's ``.loc[idx+1 : idx+seq_len]`` (reference src/dataset.py:406)
and ``video_path[idx+1 : idx+seq_len+1]`` (reference src/dataset.py:88).

Labels: 0 = disruptive, 1 = normal (reference convention; the disruption
probability is ``softmax(logits)[:, 0]``, reference src/evaluate.py:56).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

LABEL_DISRUPT = 0
LABEL_NORMAL = 1


@dataclass(frozen=True)
class ShotWindows:
    """Windows for a single shot.

    starts: (N,) int64 window start indices (window = [s+1, s+seq_len]).
    labels: (N,) int64 labels, 0=disruptive / 1=normal.
    """
    shot: int
    starts: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.starts)


def video_windows(
    shot: int,
    frame_startup: int,
    frame_tipminf: int,
    seq_len: int = 21,
    dist: int = 3,
) -> ShotWindows:
    """Training windows for the video path.

    Mirrors reference src/dataset.py:80-96: windows stride backward by
    ``seq_len`` from ``frame_tipminf - dist - seq_len`` down to (exclusive)
    ``frame_startup``; emitted in ascending order. The final window (closest
    to the quench) is labeled disruptive, all others normal.
    """
    dis_frame = frame_tipminf - dist
    starts = np.array(
        sorted(range(dis_frame - seq_len, frame_startup, -seq_len)), dtype=np.int64
    )
    labels = np.full(len(starts), LABEL_NORMAL, dtype=np.int64)
    if len(labels) > 0:
        labels[-1] = LABEL_DISRUPT
    return ShotWindows(shot=shot, starts=starts, labels=labels)


def ts_windows(
    shot: int,
    times: np.ndarray,
    tftsrt: float,
    tipminf: float,
    seq_len: int = 21,
    dist: int = 3,
    dt: float = 4.0 / 210.0,
) -> ShotWindows:
    """Training windows for the 0D path with variable stride.

    Mirrors reference src/dataset.py:343-396. Walks the shot's rows in time
    with three zones relative to the disruption time ``t_disrupt = tipminf``:

      far zone   : t in [tftsrt, t_d - dt*(2L+d))      label 1, stride L//3
      mid zone   : t in [t_d - dt*(2L+d), t_d - dt*(L+d)) label 1, stride L//7
      near zone  : t in [t_d - dt*(L+d), t_d - dt*L + dt] label 0, stride 1

    ``times`` is the per-shot time column; returned starts are positional
    indices into the shot's rows.
    """
    t_disrupt = tipminf
    n = len(times)

    starts: List[int] = []
    labels: List[int] = []

    idx = int(tftsrt / dt)
    idx_last = n - seq_len - dist

    # zone strides floored at 1: the reference's seq_len//7 (dataset.py:378)
    # is 0 for seq_len < 7, looping forever — identical for seq_len >= 7
    s3, s7 = max(seq_len // 3, 1), max(seq_len // 7, 1)

    while idx < idx_last:
        t = float(times[idx])

        if tftsrt <= t < t_disrupt - dt * (2 * seq_len + dist):
            starts.append(idx)
            labels.append(LABEL_NORMAL)
            idx += s3
        elif t_disrupt - dt * (2 * seq_len + dist) <= t < t_disrupt - dt * (seq_len + dist):
            starts.append(idx)
            labels.append(LABEL_NORMAL)
            idx += s7
        elif t_disrupt - dt * (seq_len + dist) <= t <= t_disrupt - dt * seq_len + dt:
            starts.append(idx)
            labels.append(LABEL_DISRUPT)
            idx += 1
        elif t < tftsrt:
            idx += s3
        elif t > t_disrupt:
            break
        else:
            idx += s3

    return ShotWindows(
        shot=shot,
        starts=np.asarray(starts, dtype=np.int64),
        labels=np.asarray(labels, dtype=np.int64),
    )


@dataclass(frozen=True)
class MultiShotWindows:
    """Paired video/0D windows for a single shot.

    video_starts: (N,) frame-index starts; the video window covers frames
        ``start + tau*k + tau`` for k in [0, seq_len), ascending — identical
        to the reference's reversed strided slice
        ``video_path[idx + tau*seq_len + 1 : idx + 1 : -tau][::-1]``
        (reference src/dataset.py:658).
    ts_starts: (N,) positional row starts; the 0D window is rows
        ``[s+1, s + seq_len*tau]`` subsampled by ``tau``
        (reference src/dataset.py:718-721).
    """
    shot: int
    video_starts: np.ndarray
    ts_starts: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)


def multimodal_windows(
    shot: int,
    times: np.ndarray,
    tftsrt: float,
    tipminf: float,
    frame_startup: int,
    frame_tipminf: int,
    n_frames: int,
    seq_len: int = 21,
    dist: int = 3,
    dt: float = 1.0 / 210.0,
    tau: int = 1,
    pair_mode: str = "reference",
) -> Optional[MultiShotWindows]:
    """Paired video/0D windows with the 2023-06-20 variable-stride matching.

    Mirrors reference src/dataset.py:565-665: builds stride-1 index ladders
    backward from ``dis_frame + dist`` (video) / ``ts_idx_last + dist`` (0D),
    truncates to equal length, then walks forward with a three-zone stride
    (1 near the quench, ``tau*seq_len//7`` mid, ``tau*seq_len//3`` far).
    Label is disruptive iff the video start lies within one frame of
    ``dis_frame = frame_tipminf - dist - seq_len*tau``.

    ``pair_mode`` controls how the post-walk ``t <= t_disrupt`` filter
    (reference src/dataset.py:639-652) recombines the two ladders:

    * ``"reference"`` (default, golden-tested parity): filter the ts list
      alone, then truncate the video list's TAIL to match — exactly the
      reference's ``ts_indices_tmp`` logic. When the filter drops the
      near-quench head of the ts ladder (it usually drops ~seq_len*tau - dist
      entries whenever seq_len*tau > dist), every surviving pair is SHIFTED:
      video window i is paired with the ts window of entry i+n_dropped, an
      offset that compounds through the coarse-stride zones, so mid/late
      flat-top video ends up paired with EARLY-shot 0D rows. A fusion model
      trained on these pairs never sees mid-shot 0D content labeled normal
      and its 0D stream false-alarms through the flat-top of every swept
      shot (measured: demo_multimodal false_alarm_rate 1.0 at every
      threshold before the fix).
    * ``"aligned"``: drop the offending entries as PAIRS, preserving the
      video<->ts correspondence the walk established. Windows whose 0D
      anchor would cross t_disrupt are discarded together with their video
      half instead of shifting everything after them.

    Returns ``None`` when the shot is skipped (too short / 0D data ends
    before the disruptive phase).
    """
    if pair_mode not in ("reference", "aligned"):
        raise ValueError(f"pair_mode must be 'reference' or 'aligned', got {pair_mode!r}")
    t_disrupt = tipminf - dist * dt
    dis_frame = frame_tipminf - dist - seq_len * tau

    if dis_frame < seq_len * tau:
        return None
    if float(np.max(times)) < t_disrupt:
        return None

    n_rows = len(times)
    n_after = int(np.sum(times > t_disrupt))
    ts_idx_last = n_rows - n_after - seq_len * tau
    ts_idx_start = int(np.sum(times < tftsrt))

    video_orig = list(range(dis_frame + dist, frame_startup, -1))
    ts_orig = list(range(ts_idx_last + dist, ts_idx_start, -1))

    if len(ts_orig) > len(video_orig):
        ts_orig = ts_orig[: len(video_orig)]
    elif len(ts_orig) < len(video_orig):
        video_orig = video_orig[: len(ts_orig)]

    if not ts_orig:
        return None

    video_indices: List[int] = []
    ts_indices: List[int] = []

    idx = 0
    idx_last = len(ts_orig)
    head = ts_orig[0]

    while idx < idx_last:
        video_indices.append(video_orig[idx])
        ts_indices.append(ts_orig[idx])

        diff = head - ts_orig[idx]
        if diff <= dist:
            idx += 1
        elif diff > dist and abs(ts_orig[idx] - head) < seq_len * tau:
            idx += max(int(tau * seq_len) // 7, 1)   # floored: see ts_windows
        else:
            idx += max(int(tau * seq_len) // 3, 1)

    # keep only 0D windows whose anchor time is at or before t_disrupt
    if pair_mode == "aligned":
        kept_pairs = [(v, t) for v, t in zip(video_indices, ts_indices)
                      if float(times[t]) <= t_disrupt]
        video_indices = [v for v, _ in kept_pairs]
        ts_kept = [t for _, t in kept_pairs]
    else:
        ts_kept = [i for i in ts_indices if float(times[i]) <= t_disrupt]

        if len(ts_kept) > len(video_indices):
            ts_kept = ts_kept[: len(video_indices)]
        elif len(ts_kept) < len(video_indices):
            video_indices = video_indices[: len(ts_kept)]

    labels = np.array(
        [LABEL_DISRUPT if v >= dis_frame - 1 else LABEL_NORMAL for v in video_indices],
        dtype=np.int64,
    )
    return MultiShotWindows(
        shot=shot,
        video_starts=np.asarray(video_indices, dtype=np.int64),
        ts_starts=np.asarray(ts_kept, dtype=np.int64),
        labels=labels,
    )


# ---------------------------------------------------------------------------
# Negative-only windows for NON-disruptive shots (no reference counterpart:
# the reference trains on disruptive shots only, so a trained model never
# sees a normal shot's ramp-down and may false-alarm there — measured on the
# multimodal demo, PERFORMANCE.md). These walks mirror the disruptive walks'
# geometry but anchor at the shot's END instead of its quench, and every
# window is labeled normal.
# ---------------------------------------------------------------------------

def video_windows_normal(
    shot: int,
    frame_startup: int,
    frame_cutoff: int,
    seq_len: int = 21,
) -> ShotWindows:
    """Video windows for a shot with no quench: the same backward seq_len
    stride as :func:`video_windows` but anchored at ``frame_cutoff`` so the
    ramp-down is covered; all labels normal."""
    starts = np.array(
        sorted(range(frame_cutoff - seq_len, frame_startup, -seq_len)),
        dtype=np.int64)
    return ShotWindows(shot=shot, starts=starts,
                       labels=np.full(len(starts), LABEL_NORMAL, np.int64))


def ts_windows_normal(
    shot: int,
    times: np.ndarray,
    tftsrt: float,
    seq_len: int = 21,
    dt: float = 4.0 / 210.0,
) -> ShotWindows:
    """0D windows for a shot with no quench: the far-zone stride
    (``seq_len//3``, floored like :func:`ts_windows`) from ``tftsrt`` through
    the end of the table; all labels normal."""
    n = len(times)
    s3 = max(seq_len // 3, 1)
    idx = int(tftsrt / dt)
    idx_last = n - seq_len
    starts = list(range(idx, idx_last, s3))
    return ShotWindows(
        shot=shot,
        starts=np.asarray(starts, dtype=np.int64),
        labels=np.full(len(starts), LABEL_NORMAL, np.int64))


def multimodal_windows_normal(
    shot: int,
    times: np.ndarray,
    tftsrt: float,
    frame_startup: int,
    frame_cutoff: int,
    seq_len: int = 21,
    dt: float = 1.0 / 210.0,
    tau: int = 1,
) -> Optional[MultiShotWindows]:
    """Paired windows for a shot with no quench: ladders anchored at the END
    of both streams (video at ``frame_cutoff``, 0D at the last full window),
    truncated to equal length and walked with the far-zone stride
    (``tau*seq_len//3``); all labels normal. Pairing is positional like the
    aligned mode — there is no t_disrupt filter to introduce a shift."""
    last_video = frame_cutoff - seq_len * tau - 1
    last_ts = len(times) - seq_len * tau - 1
    ts_idx_start = int(np.sum(times < tftsrt))
    if last_video <= frame_startup or last_ts <= ts_idx_start:
        return None

    video_orig = list(range(last_video, frame_startup, -1))
    ts_orig = list(range(last_ts, ts_idx_start, -1))
    k = min(len(video_orig), len(ts_orig))
    video_orig, ts_orig = video_orig[:k], ts_orig[:k]

    stride = max(int(tau * seq_len) // 3, 1)
    video_indices = video_orig[::stride]
    ts_indices = ts_orig[::stride]
    return MultiShotWindows(
        shot=shot,
        video_starts=np.asarray(video_indices, dtype=np.int64),
        ts_starts=np.asarray(ts_indices, dtype=np.int64),
        labels=np.full(len(video_indices), LABEL_NORMAL, np.int64))


# ---------------------------------------------------------------------------
# Window gather helpers (vectorized, feed the batched loaders)
# ---------------------------------------------------------------------------

def gather_ts(data: np.ndarray, starts: np.ndarray, seq_len: int, tau: int = 1) -> np.ndarray:
    """Gather 0D windows: data (T, F) + starts (N,) -> (N, seq_len, F).

    Window s covers rows [s+1, s+seq_len*tau] subsampled by tau.
    """
    offs = 1 + tau * np.arange(seq_len, dtype=np.int64)  # rows s+1, s+1+tau, ...
    idx = starts[:, None] + offs[None, :]
    return data[idx]


def video_frame_indices(starts: np.ndarray, seq_len: int) -> np.ndarray:
    """Training-video frame indices per window: starts (N,) -> (N, seq_len)
    ascending, frames [s+1, s+seq_len] (reference src/dataset.py:88)."""
    offs = np.arange(1, seq_len + 1, dtype=np.int64)
    return starts[:, None] + offs[None, :]


def multimodal_video_frame_indices(starts: np.ndarray, seq_len: int, tau: int = 1) -> np.ndarray:
    """Multimodal frame indices per window: frames ``s + 1 + tau*k`` for
    k in [1, seq_len], ascending — the reference's reversed strided slice
    ``video_path[idx + tau*seq_len + 1 : idx + 1 : -tau][::-1]``
    (reference src/dataset.py:658). For tau=1 this is [s+2, s+seq_len+1]."""
    offs = 1 + tau * np.arange(1, seq_len + 1, dtype=np.int64)
    return starts[:, None] + offs[None, :]


def class_counts(labels: np.ndarray, n_classes: int = 2) -> np.ndarray:
    """Per-class sample counts (reference get_cls_num_list,
    src/dataset.py:261-273) used by LDAM margins / DRW weights."""
    return np.bincount(labels.astype(np.int64), minlength=n_classes)


def concat_windows(per_shot: List[ShotWindows]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten per-shot windows into (shot_ids, starts, labels)."""
    if not per_shot:
        z = np.zeros((0,), dtype=np.int64)
        return z, z.copy(), z.copy()
    shots = np.concatenate([np.full(len(w), w.shot, dtype=np.int64) for w in per_shot])
    starts = np.concatenate([w.starts for w in per_shot])
    labels = np.concatenate([w.labels for w in per_shot])
    return shots, starts, labels
