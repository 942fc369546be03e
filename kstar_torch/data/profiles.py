"""Thomson radial profile interpolation (rebuild of reference src/profile.py):
cubic interpolation of the 27-point Te/Ne channels onto an n_points radial
grid, clipped to [0.1, 1e2].

The port's own copy of ``kstar_tpu/data/profiles.py`` (numpy and scipy
only), so that ``kstar_torch`` imports nothing of the JAX package."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import Schema


def get_profile(values: np.ndarray, n_points: int = 128,
                radius: Sequence[float] = Schema.RADIUS) -> np.ndarray:
    """values: (27,) or (T, 27) channel measurements -> (n_points,) or
    (T, n_points) interpolated profile (reference get_profile :20-26)."""
    from scipy.interpolate import interp1d

    r = np.asarray(radius, np.float64)
    grid = np.linspace(r.min(), r.max(), n_points)
    v = np.atleast_2d(np.asarray(values, np.float64))
    f = interp1d(r, v, kind="cubic", axis=-1, bounds_error=False,
                 fill_value="extrapolate")
    out = np.clip(f(grid), 0.1, 1e2).astype(np.float32)
    return out[0] if np.ndim(values) == 1 else out


def profile_tensor(ts_df, kind: str = "te", n_points: int = 128) -> np.ndarray:
    """Build a (T, n_points) Te or Ne radial-profile tensor from a shot's
    table (reference optional profile tensors,
    src/generate_numerical_data.py:245-272)."""
    full = (Schema.TS_TE_CORE_COLS + Schema.TS_TE_EDGE_COLS[1:]) if kind == "te" \
        else (Schema.TS_NE_CORE_COLS + Schema.TS_NE_EDGE_COLS[1:])
    # each channel keeps ITS radius when columns are missing — a prefix
    # slice of RADIUS would silently assign core radii to edge channels
    pairs = [(c, r) for c, r in zip(full, Schema.RADIUS) if c in ts_df.columns]
    cols = [c for c, _ in pairs]
    radius = [r for _, r in pairs]
    vals = ts_df[cols].to_numpy(np.float64)
    return get_profile(vals, n_points, radius)
