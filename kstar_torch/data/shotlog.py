"""Shot-log extension: plasma startup / cutoff detection from camera frames.

Rebuild of reference src/generate_modified_shot_log.py: scans each shot's
video, finds the first frame whose mean brightness exceeds eps (startup,
reference check_startup :91-96) and the first frame after which brightness
drops back below eps (cutoff, reference check_cutoff :98-103), then derives
  frame_current_quench (frame_tipminf) = frame_cutoff - 1   (reference :173)
  frame_thermal_quench (frame_tTQend)  = frame_cq - dt*fps  (reference :175)
and writes the extended shot list with columns
shot, tftsrt, tTQend, tipminf, dt, frame_startup, frame_cutoff,
frame_tTQend, frame_tipminf (reference :266-281).

Operates on frame arrays (vectorized numpy) rather than streaming cv2 reads;
.avi decoding is gated behind video_pipeline.decode_avi (needs cv2).

The port's own copy of ``kstar_tpu/data/shotlog.py`` (numpy and pandas
only); ``FPS`` comes from the port's ``config.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd

from ..config import FPS


def mean_brightness(frames: np.ndarray) -> np.ndarray:
    """Per-frame mean intensity normalized to [0, 1]; frames (T,H,W,C) uint8."""
    return frames.reshape(frames.shape[0], -1).mean(axis=1) / 255.0


def detect_startup(brightness: np.ndarray, eps: float = 0.075) -> int:
    """First frame index with brightness > eps (reference check_startup)."""
    above = brightness > eps
    return int(np.argmax(above)) if above.any() else 0


def detect_cutoff(brightness: np.ndarray, eps: float = 0.075,
                  start: int = 0) -> int:
    """First frame index after ``start`` where brightness falls back below
    eps (reference check_cutoff); defaults to the last frame if none."""
    below = brightness[start:] <= eps
    if below.any():
        return start + int(np.argmax(below))
    return len(brightness) - 1


def extend_shot_row(shot: int, frames: np.ndarray, dt_quench: float = 0.04,
                    tftsrt: Optional[float] = None,
                    tipminf: Optional[float] = None,
                    fps: float = FPS, eps: float = 0.075) -> Dict:
    """Build one extended shot-log row from the shot's frames.

    dt_quench: thermal->current quench interval (s); when the MDSplus times
    (tftsrt/tipminf) are absent they are derived from the detected frames."""
    b = mean_brightness(frames)
    frame_startup = detect_startup(b, eps)
    frame_cutoff = detect_cutoff(b, eps, start=frame_startup + 1)
    frame_tipminf = frame_cutoff - 1
    frame_tTQend = max(int(frame_tipminf - dt_quench * fps), frame_startup)

    return {
        "shot": shot,
        "tftsrt": tftsrt if tftsrt is not None else frame_startup / fps,
        "tTQend": frame_tTQend / fps,
        "tipminf": tipminf if tipminf is not None else frame_tipminf / fps,
        "dt": dt_quench,
        "frame_startup": frame_startup,
        "frame_cutoff": frame_cutoff,
        "frame_tTQend": frame_tTQend,
        "frame_tipminf": frame_tipminf,
    }


def extend_shot_log(shots: Dict[int, np.ndarray], dt_quench: float = 0.04,
                    base_log: Optional[pd.DataFrame] = None,
                    fps: float = FPS, eps: float = 0.075) -> pd.DataFrame:
    """Extend a whole shot list. ``shots`` maps shot -> frames array;
    ``base_log`` optionally carries MDSplus tftsrt/tipminf per shot."""
    rows = []
    for shot, frames in shots.items():
        tftsrt = tipminf = None
        if base_log is not None and shot in set(base_log.shot.values):
            r = base_log[base_log.shot == shot].iloc[0]
            tftsrt = float(r.tftsrt) if "tftsrt" in r else None
            tipminf = float(r.tipminf) if "tipminf" in r else None
        rows.append(extend_shot_row(shot, frames, dt_quench, tftsrt, tipminf, fps, eps))
    return pd.DataFrame(rows)
