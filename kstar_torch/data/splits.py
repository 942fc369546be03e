"""Deterministic train/valid/test splits + scaler fitting.

The port's copy of ``kstar_tpu/data/splits.py`` (numpy/pandas only).

Mirrors reference src/utils/utility.py:39-172 (``deterministic_split``,
``preparing_video_dataset``, ``preparing_0D_dataset``, ``preparing_multi_data``)
but operates on shot-id lists / dataframes instead of glob'd folders.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd


class Scaler:
    """Minimal fit/transform scalers (Robust/Standard/MinMax) with plain
    numpy state, serializable alongside checkpoints. Fit on train only
    (reference src/utils/utility.py:113-119)."""

    def __init__(self, kind: str = "Robust"):
        assert kind in ("Robust", "Standard", "MinMax")
        self.kind = kind
        self.center_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "Scaler":
        x = np.asarray(x, dtype=np.float64)
        if self.kind == "Robust":
            q1, q2, q3 = np.nanpercentile(x, [25, 50, 75], axis=0)
            self.center_ = q2
            self.scale_ = np.where(q3 - q1 == 0, 1.0, q3 - q1)
        elif self.kind == "Standard":
            self.center_ = np.nanmean(x, axis=0)
            std = np.nanstd(x, axis=0)
            self.scale_ = np.where(std == 0, 1.0, std)
        else:  # MinMax
            mn, mx = np.nanmin(x, axis=0), np.nanmax(x, axis=0)
            self.center_ = mn
            self.scale_ = np.where(mx - mn == 0, 1.0, mx - mn)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x, dtype=np.float64) - self.center_) / self.scale_).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def state_dict(self):
        return {"kind": self.kind, "center": self.center_, "scale": self.scale_}

    @classmethod
    def from_state(cls, state) -> "Scaler":
        s = cls(state["kind"])
        s.center_ = np.asarray(state["center"])
        s.scale_ = np.asarray(state["scale"])
        return s


def deterministic_split(items: Sequence, test_size: float = 0.2) -> Tuple[list, list]:
    """Every ``len//n_test``-th element goes to test
    (reference src/utils/utility.py:39-56)."""
    n = len(items)
    n_test = int(test_size * n)
    if n_test == 0:
        return list(items), []
    divided = n // n_test
    train, test = [], []
    for i, it in enumerate(items):
        (test if i % divided == 0 else train).append(it)
    return train, test


def split_shots(
    shot_list: Sequence[int],
    test_shot: Optional[int] = 21310,
) -> Tuple[List[int], List[int], List[int]]:
    """64/16/20 deterministic split excluding the held-out demo shot
    (reference preparing_video_dataset, src/utils/utility.py:59-73)."""
    shots = [s for s in shot_list if test_shot is None or int(s) != int(test_shot)]
    train, test = deterministic_split(shots, 0.2)
    train, valid = deterministic_split(train, 0.2)
    return train, valid, test


def random_split_shots(
    shot_list: Sequence[int],
    test_shot: Optional[int] = 21310,
    seed: int = 42,
) -> Tuple[List[int], List[int], List[int]]:
    """Seeded shuffled split used by the multimodal path
    (reference preparing_multi_data, src/utils/utility.py:128-129 uses sklearn
    train_test_split(test_size=0.2, random_state=42) twice)."""
    shots = [s for s in shot_list if test_shot is None or int(s) != int(test_shot)]
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(shots))
    n_test = int(np.ceil(0.2 * len(shots)))
    test = [shots[i] for i in perm[:n_test]]
    rest = [shots[i] for i in perm[n_test:]]
    n_valid = int(np.ceil(0.2 * len(rest)))
    valid = rest[:n_valid]
    train = rest[n_valid:]
    return train, valid, test


def prepare_0d_dataset(
    ts_df: pd.DataFrame,
    cols: List[str],
    scaler: str = "Robust",
    test_shot: Optional[int] = 21310,
):
    """Split the interpolated 0D table by shot and fit the scaler on train
    only (reference preparing_0D_dataset, src/utils/utility.py:76-119).

    Returns (df_train, df_valid, df_test, fitted_scaler)."""
    df = ts_df.copy()
    for c in cols:
        df[c] = df[c].astype(np.float32)

    shot_list = np.unique(df.shot.values)
    train_s, valid_s, test_s = split_shots(shot_list, test_shot)

    df_train = df[df.shot.isin(train_s)]
    df_valid = df[df.shot.isin(valid_s)]
    df_test = df[df.shot.isin(test_s)]

    sc = Scaler(scaler).fit(df_train[cols].values)
    return df_train, df_valid, df_test, sc
