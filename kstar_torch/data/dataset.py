"""Windowed datasets over per-shot arrays.

The port's copy of ``kstar_tpu/data/dataset.py`` (numpy/pandas only). A
redesign of the reference torch Datasets (reference src/dataset.py:32-851):
instead of per-sample cv2.imread + python loops in DataLoader workers (the
reference's hot loop 1), shots live as contiguous numpy arrays and whole
batches are gathered with one vectorized fancy-index (data/native.py).
Augmentation/normalization runs batched on the device (data/augment.py).

Labels: 0 = disruptive, 1 = normal.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from . import windows as W
from .splits import Scaler


# ---------------------------------------------------------------------------
# shot validity filters (shared by 0D + multimodal)
# ---------------------------------------------------------------------------

def _shot_groups(ts_df: pd.DataFrame) -> Dict[int, pd.DataFrame]:
    """One groupby pass over the 0D table (row order preserved) — replaces
    the O(n_shots x n_rows) repeated boolean masks at dataset construction."""
    return {int(s): g for s, g in ts_df.groupby("shot", sort=False)}


def filter_valid_shots(ts_df: pd.DataFrame, cols: Sequence[str],
                       shot_list: Sequence[int]) -> List[int]:
    """Drop shots with >50% nulls, >50% zeros, or a constant signal
    (reference src/dataset.py:300-338 / :518-552). ``ts_df`` may be a
    DataFrame or a precomputed {shot: per-shot frame} dict (_shot_groups) —
    the dict avoids re-masking the full table once per shot."""
    groups = ts_df if isinstance(ts_df, dict) else _shot_groups(ts_df)
    keep: List[int] = []
    for shot in shot_list:
        df = groups.get(int(shot))
        if df is None or len(df) == 0:
            continue
        sub = df[list(cols)]
        if (sub.isna().sum() > 0.5 * len(df)).any():
            continue
        if ((sub == 0).sum() > 0.5 * len(df)).any():
            continue
        if ((sub.max() - sub.min()) < 1e-3).any():
            continue
        keep.append(shot)
    return keep


class _ShotTable:
    """Per-shot 0D arrays concatenated into one contiguous buffer.
    ``ts_df``: full table or a _shot_groups dict."""

    def __init__(self, ts_df, cols: Sequence[str], shots: Sequence[int],
                 scaler: Optional[Scaler]):
        self.cols = list(cols)
        self.shots = list(shots)
        self.offset: Dict[int, int] = {}
        groups = ts_df if isinstance(ts_df, dict) else _shot_groups(ts_df)
        datas, times = [], []
        off = 0
        for shot in self.shots:
            df = groups[int(shot)]
            x = df[self.cols].to_numpy(dtype=np.float32, copy=True)
            # NaN policy: fillna(0) after validity filtering (reference
            # src/dataset.py:335-338)
            x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
            if scaler is not None:
                x = scaler.transform(x)
            datas.append(x)
            times.append(df["time"].to_numpy(dtype=np.float64))
            self.offset[shot] = off
            off += len(df)
        self.data = np.concatenate(datas, axis=0) if datas else np.zeros((0, len(self.cols)), np.float32)
        self.times = {s: t for s, t in zip(self.shots, times)}

    def n_rows(self, shot: int) -> int:
        return len(self.times[shot])


def _is_normal_row(row) -> bool:
    """Non-disruptive shot per the shot log: explicit is_disrupt False, or a
    NaN quench time."""
    if hasattr(row, "is_disrupt") and not bool(row.is_disrupt):
        return True
    return not np.isfinite(float(row.tipminf))


class TSDataset:
    """0D sliding-window dataset (reference DatasetFor0D, src/dataset.py:276-431).

    Non-disruptive shots (NaN tipminf in the shot log) yield zero windows by
    default — the variable-stride walk's NaN zone comparisons never match —
    mirroring the reference, which trains on disruptive shots only.
    ``include_normal=True`` instead walks them with the negative-only
    generator (windows.ts_windows_normal, no reference counterpart) so the
    model trains on ramp-down content labeled normal; keep the false-alarm
    evaluation population disjoint from these shots (the CLIs split normals
    train/valid/test like disruptive shots)."""

    def __init__(
        self,
        ts_df: pd.DataFrame,
        disrupt_df: pd.DataFrame,
        cols: Sequence[str],
        seq_len: int = 21,
        dist: int = 3,
        dt: float = 4.0 / 210.0,
        scaler: Optional[Scaler] = None,
        include_normal: bool = False,
    ):
        self.seq_len = seq_len
        self.dist = dist
        self.dt = dt
        self.cols = list(cols)

        groups = _shot_groups(ts_df)
        shot_list = [s for s in np.unique(ts_df.shot.values).tolist()
                     if s in set(disrupt_df.shot.values.tolist())]
        shot_list = filter_valid_shots(groups, cols, shot_list)
        self.table = _ShotTable(groups, cols, shot_list, scaler)

        per_shot = []
        for shot in shot_list:
            row = disrupt_df[disrupt_df.shot == shot].iloc[0]
            if include_normal and _is_normal_row(row):
                w = W.ts_windows_normal(shot, self.table.times[shot],
                                        tftsrt=float(row.tftsrt),
                                        seq_len=seq_len, dt=dt)
            else:
                w = W.ts_windows(
                    shot, self.table.times[shot],
                    tftsrt=float(row.tftsrt), tipminf=float(row.tipminf),
                    seq_len=seq_len, dist=dist, dt=dt,
                )
            # guard the window tail against the shot boundary
            valid = w.starts + seq_len < self.table.n_rows(shot)
            per_shot.append(W.ShotWindows(shot, w.starts[valid], w.labels[valid]))

        self.shot_ids, starts, self.labels = W.concat_windows(per_shot)
        self.starts_global = starts + np.array(
            [self.table.offset[s] for s in self.shot_ids], dtype=np.int64
        ) if len(starts) else starts

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def n_features(self) -> int:
        return len(self.cols)

    def class_counts(self) -> np.ndarray:
        return W.class_counts(self.labels)

    def batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Gather a batch: (B, seq_len, F) float32 + (B,) int labels."""
        x = W.gather_ts(self.table.data, self.starts_global[idx], self.seq_len)
        return x, self.labels[idx]


class VideoStore:
    """Memory-mapped per-shot frame arrays: root/<shot>.npy of (T,H,W,3) uint8."""

    def __init__(self, root: str, shots: Sequence[int]):
        self.root = root
        self.arrays: Dict[int, np.ndarray] = {}
        for s in shots:
            path = os.path.join(root, f"{s}.npy")
            if os.path.exists(path):
                self.arrays[int(s)] = np.load(path, mmap_mode="r")

    @classmethod
    def from_arrays(cls, arrays: Dict[int, np.ndarray]) -> "VideoStore":
        obj = cls.__new__(cls)
        obj.root = ""
        obj.arrays = {int(k): v for k, v in arrays.items()}
        return obj

    def __contains__(self, shot: int) -> bool:
        return int(shot) in self.arrays

    def n_frames(self, shot: int) -> int:
        return self.arrays[int(shot)].shape[0]

    def gather(self, shot: int, frame_idx: np.ndarray) -> np.ndarray:
        """(N, T) frame indices -> (N, T, H, W, 3) uint8 via the native
        multithreaded gather (data/native.py) with numpy fallback."""
        from .native import gather_windows_u8

        arr = self.arrays[int(shot)]
        idx = np.clip(frame_idx, 0, arr.shape[0] - 1)
        return gather_windows_u8(arr, idx)


class VideoDataset:
    """Video sliding-window dataset (reference DatasetForVideo,
    src/dataset.py:32-273). Returns raw uint8 frame stacks; crop/augment/
    normalize happen batched on device.

    Non-disruptive shots (frame_tipminf = -1) yield zero windows by default —
    the backward stride range from the (nonexistent) quench is empty —
    matching the reference's disruptive-only training.
    ``include_normal=True`` walks them with windows.video_windows_normal
    (negative-only, anchored at frame_cutoff so ramp-down is covered)."""

    def __init__(
        self,
        store: VideoStore,
        disrupt_df: pd.DataFrame,
        shots: Sequence[int],
        seq_len: int = 21,
        dist: int = 3,
        include_normal: bool = False,
    ):
        self.store = store
        self.seq_len = seq_len
        self.dist = dist

        per_shot = []
        for shot in shots:
            if shot not in store:
                continue
            row = disrupt_df[disrupt_df.shot == shot].iloc[0]
            if include_normal and _is_normal_row(row):
                w = W.video_windows_normal(
                    shot,
                    frame_startup=int(row.frame_startup),
                    frame_cutoff=int(row.frame_cutoff),
                    seq_len=seq_len)
            else:
                w = W.video_windows(
                    shot,
                    frame_startup=int(row.frame_startup),
                    frame_tipminf=int(row.frame_tipminf),
                    seq_len=seq_len, dist=dist,
                )
            valid = w.starts + seq_len < store.n_frames(shot)
            per_shot.append(W.ShotWindows(shot, w.starts[valid], w.labels[valid]))

        self.shot_ids, self.starts, self.labels = W.concat_windows(per_shot)

    def __len__(self) -> int:
        return len(self.labels)

    def class_counts(self) -> np.ndarray:
        return W.class_counts(self.labels)

    def batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Gather (B, T, H, W, 3) uint8 + (B,) labels, grouping by shot so each
        shot's memmap is touched once."""
        idx = np.asarray(idx)
        shots = self.shot_ids[idx]
        frames_idx = W.video_frame_indices(self.starts[idx], self.seq_len)
        out = None
        for shot in np.unique(shots):
            m = shots == shot
            got = self.store.gather(int(shot), frames_idx[m])
            if out is None:
                out = np.empty((len(idx),) + got.shape[1:], dtype=np.uint8)
            out[m] = got
        return out, self.labels[idx]


class MultiModalDataset:
    """Paired video + 0D windows (reference MultiModalDataset,
    src/dataset.py:433-851)."""

    def __init__(
        self,
        store: VideoStore,
        ts_df: pd.DataFrame,
        disrupt_df: pd.DataFrame,
        cols: Sequence[str],
        shots: Sequence[int],
        seq_len: int = 21,
        dist: int = 3,
        dt: float = 1.0 / 210.0,
        tau: int = 1,
        scaler: Optional[Scaler] = None,
        pair_mode: str = "reference",
        include_normal: bool = False,
    ):
        self.seq_len = seq_len
        self.dist = dist
        self.dt = dt
        self.tau = tau
        self.pair_mode = pair_mode
        self.cols = list(cols)
        self.store = store

        # 0D preprocessing: linear interpolate + ffill, then scale
        # (reference src/dataset.py:493-502)
        ts_df = ts_df.copy()
        ts_df[self.cols] = ts_df[self.cols].interpolate(method="linear", limit_direction="forward")
        ts_df[self.cols] = ts_df[self.cols].ffill()

        groups = _shot_groups(ts_df)
        shot_list = [s for s in shots if s in store and int(s) in groups]
        shot_list = filter_valid_shots(groups, cols, shot_list)
        # time-coverage check (reference src/dataset.py:526-528); normal
        # shots have no quench to cover, so the gate only applies to
        # disruptive rows
        kept = []
        for shot in shot_list:
            row = disrupt_df[disrupt_df.shot == shot].iloc[0]
            if include_normal and _is_normal_row(row):
                kept.append(shot)
                continue
            tmax = float(groups[int(shot)].time.max())
            if tmax >= float(row.tipminf) - dist * dt:
                kept.append(shot)
        shot_list = kept

        self.table = _ShotTable(groups, cols, shot_list, scaler)

        vid_starts, ts_starts, labels, shot_ids = [], [], [], []
        for shot in shot_list:
            row = disrupt_df[disrupt_df.shot == shot].iloc[0]
            if include_normal and _is_normal_row(row):
                mw = W.multimodal_windows_normal(
                    shot, self.table.times[shot],
                    tftsrt=float(row.tftsrt),
                    frame_startup=int(row.frame_startup),
                    frame_cutoff=int(row.frame_cutoff),
                    seq_len=seq_len, dt=dt, tau=tau)
            else:
                mw = W.multimodal_windows(
                    shot, self.table.times[shot],
                    tftsrt=float(row.tftsrt), tipminf=float(row.tipminf),
                    frame_startup=int(row.frame_startup),
                    frame_tipminf=int(row.frame_tipminf),
                    n_frames=store.n_frames(shot),
                    seq_len=seq_len, dist=dist, dt=dt, tau=tau,
                    pair_mode=pair_mode,
                )
            if mw is None or len(mw) == 0:
                continue
            n_rows = self.table.n_rows(shot)
            n_f = store.n_frames(shot)
            valid = (
                (mw.ts_starts + seq_len * tau < n_rows)
                & (mw.video_starts + 1 + tau * seq_len < n_f)
                & (mw.video_starts >= 0)
            )
            vid_starts.append(mw.video_starts[valid])
            ts_starts.append(mw.ts_starts[valid] + self.table.offset[shot])
            labels.append(mw.labels[valid])
            shot_ids.append(np.full(int(valid.sum()), shot, dtype=np.int64))

        cat = (lambda xs: np.concatenate(xs) if xs else np.zeros((0,), np.int64))
        self.video_starts = cat(vid_starts)
        self.ts_starts_global = cat(ts_starts)
        self.labels = cat(labels)
        self.shot_ids = cat(shot_ids)

    def __len__(self) -> int:
        return len(self.labels)

    def class_counts(self) -> np.ndarray:
        return W.class_counts(self.labels)

    def batch(self, idx: np.ndarray):
        """Gather {'video': (B,T,H,W,3) uint8, '0D': (B,L,F) f32} + labels."""
        idx = np.asarray(idx)
        x_ts = W.gather_ts(self.table.data, self.ts_starts_global[idx], self.seq_len, self.tau)
        shots = self.shot_ids[idx]
        frames_idx = W.multimodal_video_frame_indices(self.video_starts[idx], self.seq_len, self.tau)
        out = None
        for shot in np.unique(shots):
            m = shots == shot
            got = self.store.gather(int(shot), frames_idx[m])
            if out is None:
                out = np.empty((len(idx),) + got.shape[1:], dtype=np.uint8)
            out[m] = got
        return {"video": out, "0D": x_ts}, self.labels[idx]
