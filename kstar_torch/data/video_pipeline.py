"""Video ETL: .avi -> per-shot contiguous uint8 arrays (+ jpg-folder repack).

Redesign of reference src/generate_video_data.py: instead of one jpg per
frame (reference :110, which forces per-sample cv2.imread at train time),
each shot becomes a single (T, H, W, 3) uint8 .npy that memory-maps for
zero-copy window gathers. cv2 is only needed for .avi decode / jpg read and
is import-gated; the training path never touches it.

The port's own copy of ``kstar_tpu/data/video_pipeline.py`` (numpy and
cv2 only); its files equal the JAX package's byte for byte.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _require_cv2():
    try:
        import cv2  # type: ignore
        return cv2
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "cv2 is required only for .avi/.jpg decoding; install opencv-python "
            "or repack shots to .npy on a machine that has it") from e


def decode_avi(path: str, resize: int = 256, fallback_path: Optional[str] = None) -> np.ndarray:
    """Decode one shot's .avi to (T, resize, resize, 3) uint8 BGR, resizing
    with INTER_CUBIC (reference src/generate_video_data.py:108); falls back
    tv01 -> tv02 like the reference (:69-76)."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened() and fallback_path:
        cap = cv2.VideoCapture(fallback_path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.resize(frame, (resize, resize), interpolation=cv2.INTER_CUBIC))
    cap.release()
    return np.stack(frames).astype(np.uint8) if frames else np.zeros((0, resize, resize, 3), np.uint8)


def repack_jpg_folder(folder: str, resize: Optional[int] = None) -> np.ndarray:
    """Repack a reference-style frame folder (<shot>/NNNNNN.jpg) into one
    contiguous array."""
    cv2 = _require_cv2()
    import glob

    paths = sorted(glob.glob(os.path.join(folder, "*.jpg")))
    frames = []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise ValueError(f"unreadable jpg: {p}")
        if resize and img.shape[:2] != (resize, resize):
            img = cv2.resize(img, (resize, resize), interpolation=cv2.INTER_CUBIC)
        frames.append(img)
    if frames and any(f.shape != frames[0].shape for f in frames):
        raise ValueError(f"mixed frame shapes in {folder} "
                         f"(pass resize= to normalize)")
    return np.stack(frames).astype(np.uint8) if frames else np.zeros((0, 0, 0, 3), np.uint8)


def _convert_one(args) -> str:
    """Worker for convert_shots — module-level so mp.Pool can pickle it."""
    shot, avi_dir, out_dir, resize = args
    p1 = os.path.join(avi_dir, f"{shot:06d}tv01.avi")
    p2 = os.path.join(avi_dir, f"{shot:06d}tv02.avi")
    arr = decode_avi(p1, resize, fallback_path=p2)
    out = os.path.join(out_dir, f"{shot}.npy")
    np.save(out, arr)
    return out


def convert_shots(
    avi_dir: str,
    out_dir: str,
    shots: Sequence[int],
    resize: int = 256,
    n_workers: int = 0,
) -> Dict[int, str]:
    """Convert shots' .avi files (avi_dir/%06dtv01.avi with tv02 fallback,
    reference naming) into out_dir/<shot>.npy. Parallelized over shots with a
    process pool like the reference (:133-151) when n_workers > 0."""
    os.makedirs(out_dir, exist_ok=True)
    work = [(s, avi_dir, out_dir, resize) for s in shots]

    if n_workers > 0:
        import multiprocessing as mp

        # spawn, not fork: a forked child of a process that has initialised
        # CUDA cannot use CUDA, and fork() of a process with live threads
        # (torch's thread pools) can deadlock the children. Workers only
        # need cv2 + numpy.
        with mp.get_context("spawn").Pool(n_workers) as pool:
            outs = pool.map(_convert_one, work)
        return dict(zip(shots, outs))
    return {s: _convert_one(w) for s, w in zip(shots, work)}


def legacy_frame_calculator(time_s: float, fps: int = 210, gap: int = 0) -> int:
    """Reference src/generate_video_data_fixed.py:65-69 ``frame_calculator``:
    frame index for a time in seconds, with the constant frame-offset ``gap``
    added BEFORE rounding (Python banker's rounding, as the reference uses
    built-in round)."""
    return round(time_s * fps + gap)


def legacy_clip_segments(
    tftsrt_s: float,
    frame_tipminf: int,
    n_frames: int,
    duration: int = 21,
    distance: int = 0,
    fps: int = 210,
    gap: int = 20,
) -> List[dict]:
    """Closed-form rebuild of the legacy per-clip segmenter's partition
    (reference src/generate_video_data_fixed.py:85-176 ``make_dataset``):
    which frame ranges the reference's cv2.VideoWriter loop actually writes
    into which ``{shot}_{b}_{b+duration}.avi`` clip file, and with which
    disruption/normal label. The loop's quirks are load-bearing for parity
    and are reproduced exactly (oracle-tested against a line-by-line
    simulation of the reference control flow in
    tests/test_video_pipeline.py):

    * the very first boundary frame only OPENS the first writer and is never
      written (:149-152 takes the ``save_start`` branch, which skips the
      ``out.write`` at :173-174), so the first clip holds duration-1 frames;
    * later boundary frames are written into the NEW clip they open
      (:162-168 then :173);
    * the clip covering ``[dis_frame-duration, dis_frame)`` (with
      ``dis_frame = frame_tipminf - distance``, :106) is the single
      "disruption" clip (:155-159) and the loop breaks at the next boundary
      (:163-164) — UNLESS that window is the first segment after ``tftsrt``
      (the ``save_start`` branch wins at :149 and labels it normal, so no
      disruption clip is emitted and the loop runs to the end of the video)
      or starts before ``tftsrt`` (never reached);
    * ``start_frame = dis_frame % duration`` (:109) phase-locks all
      boundaries to the disruption frame;
    * a clip cut short by the end of the video keeps its full-width name.

    Returns a list of dicts ``{"start", "end", "written", "label"}`` where
    ``start``/``end`` are the clip-file name fields, ``written`` is the
    half-open frame range actually stored, and ``label`` is ``"disruption"``
    or ``"normal"``.
    """
    tft = legacy_frame_calculator(tftsrt_s, fps, gap)
    dis_frame = frame_tipminf - distance
    start = dis_frame % duration
    b0 = max(tft, 0) + (start - max(tft, 0)) % duration
    if b0 >= n_frames:
        return []
    segments: List[dict] = []
    b = b0
    while b < n_frames:
        is_first = b == b0
        is_dis = (not is_first) and (b + duration == dis_frame)
        if (not is_first) and segments and segments[-1]["label"] == "disruption":
            break  # reference :163-164 - boundary after the disruption clip
        w0 = b + 1 if is_first else b
        w1 = min(b + duration, n_frames)
        segments.append({
            "start": b,
            "end": b + duration,
            "written": (w0, w1),
            "label": "disruption" if is_dis else "normal",
        })
        b += duration
    return segments


def extract_legacy_clips(
    frames: np.ndarray,
    tftsrt_s: float,
    frame_tipminf: int,
    duration: int = 21,
    distance: int = 0,
    fps: int = 210,
    gap: int = 20,
    flip: bool = False,
    save_dir: Optional[str] = None,
    shot: Optional[int] = None,
) -> List[dict]:
    """Materialize the legacy clip dataset from a decoded shot array:
    the reference writes per-clip .avi files under
    ``dur{duration}_dis{distance}/{disruption,normal}/`` (reference
    src/generate_video_data_fixed.py:111-174); here each clip becomes a
    contiguous uint8 .npy with the same name stem and directory layout.
    ``flip`` mirrors frames horizontally, matching the reference's tv02
    camera handling (:117-122, :170-171 — note the non-legacy extractor
    computes ``is_flip`` but never applies it; only this path flips).
    Returns the segment dicts with a ``"clip"`` array (and ``"path"`` when
    saved) added."""
    segs = legacy_clip_segments(tftsrt_s, frame_tipminf, len(frames),
                                duration, distance, fps, gap)
    base = None
    if save_dir is not None:
        base = os.path.join(save_dir, f"dur{duration}_dis{distance}")
        os.makedirs(os.path.join(base, "disruption"), exist_ok=True)
        os.makedirs(os.path.join(base, "normal"), exist_ok=True)
    out = []
    for seg in segs:
        w0, w1 = seg["written"]
        clip = frames[w0:w1]
        if flip:
            clip = clip[:, :, ::-1]
        seg = dict(seg, clip=np.ascontiguousarray(clip))
        if base is not None:
            name = f"{shot}_{seg['start']}_{seg['end']}.npy"
            path = os.path.join(base, seg["label"], name)
            np.save(path, seg["clip"])
            seg["path"] = path
        out.append(seg)
    return out


def repack_dataset(temp_dir: str, out_dir: str, resize: Optional[int] = None) -> Dict[int, str]:
    """Repack a reference dataset/temp/<shot>/ jpg tree into per-shot .npy."""
    import glob

    os.makedirs(out_dir, exist_ok=True)
    outs = {}
    for folder in sorted(glob.glob(os.path.join(temp_dir, "*"))):
        if not os.path.isdir(folder):
            continue
        shot = int(os.path.basename(folder))
        arr = repack_jpg_folder(folder, resize)
        out = os.path.join(out_dir, f"{shot}.npy")
        np.save(out, arr)
        outs[shot] = out
    return outs
