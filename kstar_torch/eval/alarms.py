"""Shot-level alarm evaluation: sweep whole shots and score the alarms.

Port of ``kstar_tpu/eval/alarms.py`` (video and multimodal sweeps). Operationally what
matters is: did an alarm fire before the disruption, how much warning time
did it give, and does the model false-alarm during flat-top? This module
sweeps every shot with the batched engine (infer/continuous.py) and
aggregates:

  * detected     — alarm fired in [tftsrt + t_min, tipminf]
  * missed       — not detected (no alarm before the current quench, or
                   only a premature one)
  * premature    — alarm before tftsrt + t_min (too early to be a credible
                   precursor; a false alarm operationally — counts missed,
                   not detected, and is excluded from the warning stats)
  * warning time — tipminf - t_alarm (the reference's warning-time notion,
                   utility.py:843-853), with p50/p90 across detected shots
  * false alarm  — on a NON-disruptive shot (is_disrupt False / NaN
                   tipminf), any threshold crossing the alarm system would
                   act on, i.e. at or after t_min (the same startup blanking
                   alarm_times applies everywhere); summary reports the
                   per-shot false-alarm rate (FPR) and the mean fraction of
                   post-t_min time spent above threshold — both statistics
                   share the one t_min gate

**Latching semantics.** The headline ``detected`` figure latches on the
FIRST threshold crossing of the shot: if that crossing is premature, the
shot counts as missed even if a credible alarm also fires later inside
[tftsrt + t_min, tipminf]. This models an operational alarm that trips
(and would trigger mitigation) at its first firing. The non-latched
alternative — scan for the first crossing at or after tftsrt + t_min — is
reported alongside as ``detected_recoverable`` / ``detection_rate_recoverable``.

**Dwell rule.** Every scorer takes ``min_dwell_s``: the alarm trips only
after the curve stays above threshold for that much continuous armed time
(alarm_times, infer/continuous.py) — a hysteresis axis that suppresses
brief ramp-down spikes at a 1:1 cost in warning time.
``dwell_tradeoff_from_curves`` sweeps it the way
``threshold_tradeoff_from_curves`` sweeps the threshold.

The scoring itself is numpy (``score_alarm_rows``); pandas is imported only
by the functions that return a ``DataFrame``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import FPS
from ..infer.continuous import (MultiModalSweeper, VideoSweeper, alarm_times,
                                predict_multimodal_shot, startup_suppression,
                                warning_time)


def sweep_prob_curves(
    model,
    store,                        # VideoStore: `in`, and `.arrays[shot]`
    disrupt_df,                   # pandas DataFrame of the shot log
    shots: Sequence[int],
    seq_len: int = 21,
    dist: int = 3,
    crop_size: int = 128,
    batch_size: int = 128,
    compute_dtype: torch.dtype = None,
    device=None,
    mesh=None,
) -> List[Tuple[int, object, np.ndarray, np.ndarray]]:
    """Library sweep -> [(shot, disrupt_row, time_x, probs)].

    Padding/startup-suppression/alignment identical to predict_video_shot
    (reference generate_prob_curve, utility.py:896-977). ``device=None``
    means the GPU. ``mesh``: the shots are split over its data ranks
    (``VideoSweeper.sweep_shots``); every rank returns every curve."""
    compute_dtype = compute_dtype or torch.bfloat16
    have_meta = set(disrupt_df.shot)
    skipped = [s for s in shots if s in store and s not in have_meta]
    if skipped:
        print(f"[sweep_prob_curves] skipping shots without disruption "
              f"metadata: {skipped}")
    shots = [s for s in shots if s in store and s in have_meta]
    if not shots:
        return []

    sweeper = VideoSweeper(model, seq_len, crop_size, batch_size, compute_dtype,
                           device=device, mesh=mesh)
    frames_list, starts_list, metas = [], [], []
    for shot in shots:
        r = disrupt_df[disrupt_df.shot == shot].iloc[0]
        frames = np.asarray(store.arrays[int(shot)])
        sub = frames[int(r.frame_startup): int(r.frame_cutoff) + int(FPS)]
        n_windows = max(len(sub) - seq_len - dist, 0)
        frames_list.append(sub)
        starts_list.append(np.arange(n_windows, dtype=np.int64))
        metas.append(r)
    probs_list = sweeper.sweep_shots(frames_list, starts_list)

    curves = []
    for shot, r, raw in zip(shots, metas, probs_list):
        prob_full = np.concatenate([
            np.zeros(seq_len + int(r.frame_startup), np.float32),
            raw[1:-1] if len(raw) > 2 else raw[:0],
        ])
        probs = startup_suppression(prob_full, int(FPS * 1))
        time_x = np.arange(len(probs)) / FPS
        curves.append((int(shot), r, time_x, probs))
    return curves


def score_alarm_rows(curves, threshold: float = 0.5, t_min: float = 1.0,
                     min_dwell_s: float = 0.0) -> Tuple[List[Dict], Dict]:
    """Score pre-swept probability curves at one threshold; returns
    ``(rows, summary)``: one dict per shot and the aggregate (numpy only).

    Disruptive shots contribute to detection/warning statistics (first-alarm
    LATCHING — see module docstring — with ``detected_recoverable`` as the
    non-latched companion). Non-disruptive shots (``is_disrupt`` False or
    NaN tipminf in the shot-log row) contribute to the false-alarm
    statistics: a crossing at or after ``t_min`` is a false alarm, and
    ``alarm_time_frac`` is the fraction of post-``t_min`` samples above
    threshold — the same gate for both, so false_alarm_rate and
    false_alarm_time_frac describe one population.

    ``min_dwell_s`` requires the curve to stay above threshold for that much
    continuous armed time before the alarm trips (alarm_times dwell rule;
    0 = the reference first-crossing rule). ``alarm_time_frac`` stays a
    plain duty-cycle statistic, dwell-independent by design."""
    rows: List[Dict] = []
    for shot, r, time_x, probs in curves:
        t_cq = float(r.tipminf)
        tftsrt = float(r.tftsrt)
        is_disrupt = bool(getattr(r, "is_disrupt", True)) and bool(np.isfinite(t_cq))
        t_alarm = alarm_times(time_x, probs, threshold, t_min, min_dwell_s)
        if is_disrupt:
            w = warning_time(t_alarm, t_cq)
            premature = t_alarm is not None and t_alarm < tftsrt + t_min
            # a premature (pre-flat-top+t_min) alarm is operationally a
            # false alarm and LATCHES the shot as missed, so detection_rate
            # and the warning percentiles stay honest
            detected = t_alarm is not None and t_alarm <= t_cq and not premature
            # non-latched companion: first crossing AT OR AFTER tftsrt+t_min
            t_rec = alarm_times(time_x, probs, threshold,
                                t_min=tftsrt + t_min,
                                min_dwell_s=min_dwell_s)
            detected_rec = t_rec is not None and t_rec <= t_cq
            false_alarm = False
            alarm_frac = np.nan
        else:
            detected = detected_rec = premature = False
            w = None
            # same t_min gate as t_alarm/false_alarm: one operational window
            false_alarm = t_alarm is not None
            armed = time_x >= t_min
            alarm_frac = (float((probs[armed] > threshold).mean())
                          if armed.any() else 0.0)
        rows.append({
            "shot": int(shot),
            "is_disrupt": is_disrupt,
            "t_alarm": t_alarm,
            "t_cq": t_cq,
            "warning_s": w if detected else np.nan,
            "detected": detected,
            "detected_recoverable": detected_rec,
            "missed": is_disrupt and not detected,
            "premature": premature,
            "false_alarm": false_alarm,
            "alarm_time_frac": alarm_frac,
            "max_prob": float(probs.max()) if len(probs) else 0.0,
        })

    dis = [r for r in rows if r["is_disrupt"]]
    nrm = [r for r in rows if not r["is_disrupt"]]
    warns = np.array([r["warning_s"] for r in dis if not np.isnan(r["warning_s"])])
    count = lambda group, key: int(sum(r[key] for r in group))
    rate = lambda group, key: float(np.mean([r[key] for r in group]))
    summary = {
        "n_shots": len(rows),
        "n_disrupt": len(dis),
        "n_normal": len(nrm),
        "detected": count(dis, "detected"),
        "missed": count(dis, "missed"),
        "premature": count(dis, "premature"),
        "detection_rate": rate(dis, "detected") if dis else 0.0,
        "detection_rate_recoverable": (
            rate(dis, "detected_recoverable") if dis else 0.0),
        "false_alarms": count(nrm, "false_alarm"),
        "false_alarm_rate": rate(nrm, "false_alarm") if nrm else None,
        "false_alarm_time_frac": rate(nrm, "alarm_time_frac") if nrm else None,
        "warning_p50_s": float(np.percentile(warns, 50)) if len(warns) else None,
        "warning_p90_s": float(np.percentile(warns, 90)) if len(warns) else None,
        "warning_mean_s": float(warns.mean()) if len(warns) else None,
        "threshold": threshold,
        "min_dwell_s": min_dwell_s,
    }
    return rows, summary


def score_alarms(curves, threshold: float = 0.5, t_min: float = 1.0,
                 min_dwell_s: float = 0.0) -> Dict:
    """``score_alarm_rows`` with the per-shot rows as a DataFrame:
    ``{'per_shot': DataFrame, 'summary': dict}``."""
    import pandas as pd

    rows, summary = score_alarm_rows(curves, threshold, t_min, min_dwell_s)
    return {"per_shot": pd.DataFrame(rows), "summary": summary}


def evaluate_video_alarms(
    model,
    store,
    disrupt_df,
    shots: Sequence[int],
    seq_len: int = 21,
    dist: int = 3,
    crop_size: int = 128,
    batch_size: int = 128,
    threshold: float = 0.5,
    t_min: float = 1.0,
    min_dwell_s: float = 0.0,
    compute_dtype: torch.dtype = None,
    device=None,
    mesh=None,
) -> Dict:
    """Sweep the shot library, score alarms. Returns
    {'per_shot': DataFrame, 'summary': dict}. ``mesh``: as in
    ``sweep_prob_curves``."""
    curves = sweep_prob_curves(model, store, disrupt_df, shots, seq_len, dist,
                               crop_size, batch_size, compute_dtype, device=device,
                               mesh=mesh)
    return score_alarms(curves, threshold, t_min, min_dwell_s)


def sweep_multimodal_prob_curves(
    model,
    store,
    ts_df,
    disrupt_df,
    shots: Sequence[int],
    cols: Sequence[str],
    scaler,
    seq_len: int = 21,
    dist: int = 3,
    dt: float = 1.0 / 210.0,
    tau: int = 1,
    crop_size: int = 128,
    batch_size: int = 32,
    compute_dtype: torch.dtype = None,
    device=None,
) -> List[Tuple[int, object, np.ndarray, np.ndarray]]:
    """Whole-shot multimodal sweeps -> [(shot, disrupt_row, time_x, probs)].

    Each shot goes through ``predict_multimodal_shot`` (padded, startup-
    suppressed and smoothed as in reference utility.py:1136-1168), so the
    curves feed ``score_alarms`` directly. One ``MultiModalSweeper`` (its
    spatial-cls table route chosen once) serves the whole library. A non-disruptive shot has no quench time, so it is swept
    to the end of its 0D table. ``device=None`` means the GPU."""
    compute_dtype = compute_dtype or torch.bfloat16
    sweeper = MultiModalSweeper(model, seq_len, tau, crop_size, batch_size,
                                compute_dtype, device=device)
    have_meta = set(disrupt_df.shot)
    curves = []
    for shot in shots:
        if shot not in store:
            continue
        if shot not in have_meta:
            print(f"[sweep_multimodal_prob_curves] skipping shot {shot}: "
                  f"no disruption metadata")
            continue
        r = disrupt_df[disrupt_df.shot == shot].iloc[0]
        d = ts_df[ts_df.shot == shot]
        t_end = (float(r.tipminf) if np.isfinite(float(r.tipminf))
                 else float(d["time"].max()))
        time_x, probs = predict_multimodal_shot(
            model, np.asarray(store.arrays[int(shot)]),
            d[cols].to_numpy(np.float32), d["time"].to_numpy(), scaler,
            int(r.frame_startup), int(r.frame_cutoff), float(r.tftsrt), t_end,
            seq_len=seq_len, dist=dist, dt=dt, tau=tau, crop_size=crop_size,
            batch_size=batch_size, compute_dtype=compute_dtype, sweeper=sweeper)
        if len(time_x):
            curves.append((int(shot), r, time_x, probs))
    return curves


def evaluate_multimodal_alarms(
    model, store, ts_df, disrupt_df, shots, cols, scaler,
    threshold: float = 0.5,
    t_min: float = 1.0,
    min_dwell_s: float = 0.0,
    **kw,
) -> Dict:
    """Multimodal analogue of ``evaluate_video_alarms``: sweep each shot
    through the fusion model and score the alarms. Returns {'per_shot':
    DataFrame, 'summary': dict}."""
    curves = sweep_multimodal_prob_curves(model, store, ts_df, disrupt_df, shots,
                                          cols, scaler, **kw)
    return score_alarms(curves, threshold, t_min, min_dwell_s)


_TRADEOFF_COLUMNS = (
    ("detection_rate", "detection_rate"),
    ("detection_rate_recoverable", "detection_rate_recoverable"),
    ("warning_p50_s", "warning_p50_s"),
    ("warning_p90_s", "warning_p90_s"),
    ("n_detected", "detected"),
    ("n_premature", "premature"),
    ("false_alarm_rate", "false_alarm_rate"),
    ("false_alarm_time_frac", "false_alarm_time_frac"),
    ("n_false_alarms", "false_alarms"),
)


def _tradeoff_frame(curves, points, t_min: float, axes, with_p90: bool = False):
    """One row per operating point (threshold, min_dwell_s) of ``points``,
    rescored on the host from the held curves; ``axes`` names the axis
    columns the frame keeps."""
    import pandas as pd

    rows = []
    for thr, dw in points:
        _, s = score_alarm_rows(curves, thr, t_min, dw)
        axis = {"threshold": thr, "min_dwell_s": dw}
        rows.append({**{a: axis[a] for a in axes},
                     **{col: s[key] for col, key in _TRADEOFF_COLUMNS
                        if with_p90 or col != "warning_p90_s"}})
    return pd.DataFrame(rows)


def threshold_tradeoff_from_curves(
    curves,
    thresholds: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
    t_min: float = 1.0,
    min_dwell_s: float = 0.0,
):
    """Rescore pre-swept prob curves per threshold — probabilities are
    threshold-independent, so the trade-off curve needs no further device
    work."""
    return _tradeoff_frame(curves, [(thr, min_dwell_s) for thr in thresholds],
                           t_min, ("threshold",))


def dwell_tradeoff_from_curves(
    curves,
    dwells: Sequence[float] = (0.0, 0.05, 0.1, 0.2, 0.4),
    threshold: float = 0.5,
    t_min: float = 1.0,
):
    """Detection / warning / false-alarm rate vs the alarm DWELL requirement
    at a fixed threshold — the second operational axis. Dwell trades warning
    time 1:1 for false-alarm suppression: each row shows how much detection
    and p50 warning is paid for the FPR bought."""
    return _tradeoff_frame(curves, [(threshold, dw) for dw in dwells], t_min,
                           ("min_dwell_s",))


def operating_grid_from_curves(
    curves,
    thresholds: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
    dwells: Sequence[float] = (0.0, 0.05, 0.1, 0.2, 0.4),
    t_min: float = 1.0,
):
    """Full threshold x dwell operating surface: every (threshold,
    min_dwell_s) combination rescored on the held curves, so the artifact
    shows WHICH operating points — if any — reach detection 1.0 /
    false-alarm 0. Host-only, O(grid x shots) numpy."""
    return _tradeoff_frame(curves, [(thr, dw) for thr in thresholds for dw in dwells],
                           t_min, ("threshold", "min_dwell_s"), with_p90=True)


def threshold_sweep(
    model, store, disrupt_df, shots,
    thresholds: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
    **kw,
):
    """Detection rate / warning time / premature rate vs alarm threshold —
    the operational trade-off curve. The library is swept ONCE
    (sweep_prob_curves); alarms are rescored per threshold on the host."""
    t_min = kw.pop("t_min", 1.0)
    min_dwell_s = kw.pop("min_dwell_s", 0.0)
    curves = sweep_prob_curves(
        model, store, disrupt_df, shots,
        seq_len=kw.pop("seq_len", 21), dist=kw.pop("dist", 3),
        crop_size=kw.pop("crop_size", 128), batch_size=kw.pop("batch_size", 128),
        compute_dtype=kw.pop("compute_dtype", None), device=kw.pop("device", None),
        mesh=kw.pop("mesh", None))
    return threshold_tradeoff_from_curves(curves, thresholds, t_min,
                                          min_dwell_s)


def multimodal_threshold_sweep(
    model, store, ts_df, disrupt_df, shots, cols, scaler,
    thresholds: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
    t_min: float = 1.0,
    min_dwell_s: float = 0.0,
    **kw,
):
    """Operational trade-off curve of the fusion model: the shots are swept
    once and rescored per threshold on the host."""
    curves = sweep_multimodal_prob_curves(model, store, ts_df, disrupt_df, shots,
                                          cols, scaler, **kw)
    return threshold_tradeoff_from_curves(curves, thresholds, t_min, min_dwell_s)
