"""ctypes binding for the native window-gather library (native/window_gather.cpp).

Port of ``kstar_tpu/data/native.py``. The host C++ source is compiled on
first use (``g++ -O3 -march=native``) into the git-ignored
``build/kstar_torch/window_gather-<hash>.so``; the hash covers the source,
the flags and the host's CPU (a ``-march=native`` library built on one
machine may fault on another), so each machine builds its own and an edited
source is rebuilt. Without a compiler the gather falls back to numpy fancy
indexing, which gives the same bytes. The native path copies each gathered
frame once with multithreaded memcpy; it replaces the reference's DataLoader
worker processes (reference train_vision_network.py:307 num_workers=4).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "native" / "window_gather.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _host_id() -> str:
    """The CPU that ``-march=native`` targets: its model and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_id().encode())
    return BUILD_DIR / f"window_gather-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    so = target()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)          # atomic: a concurrent process never loads half a file
        return so
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not SRC.exists():
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.gather_windows_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.gather_windows_u8.restype = None
        _LIB = lib
        return _LIB


def gather_windows_u8(frames: np.ndarray, frame_idx: np.ndarray,
                      n_threads: int = 0) -> np.ndarray:
    """frames (T, H, W, C) uint8 (contiguous/memmap) + frame_idx (B, L)
    -> (B, L, H, W, C) uint8, indices clipped to [0, T-1]. Uses the native
    library when available."""
    if frames.dtype != np.uint8:
        raise ValueError(f"gather_windows_u8: frames must be uint8, got {frames.dtype}")
    frames = np.ascontiguousarray(frames) if not (
        isinstance(frames, np.memmap) or frames.flags["C_CONTIGUOUS"]) else frames
    B, L = frame_idx.shape
    T = frames.shape[0]
    frame_shape = frames.shape[1:]
    frame_bytes = int(np.prod(frame_shape))

    lib = get_lib()
    if lib is None:
        idx = np.clip(frame_idx, 0, T - 1)
        return np.asarray(frames[idx])

    out = np.empty((B, L) + frame_shape, dtype=np.uint8)
    idx = np.ascontiguousarray(frame_idx.astype(np.int64))
    n_threads = n_threads or min(os.cpu_count() or 4, 16)
    lib.gather_windows_u8(
        frames.ctypes.data_as(ctypes.c_void_p), T, frame_bytes,
        idx.ctypes.data_as(ctypes.c_void_p), B, L,
        out.ctypes.data_as(ctypes.c_void_p), n_threads,
    )
    return out
