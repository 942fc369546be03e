"""The 0D table: cleaning, clipping, resampling, feature engineering.

Rebuild of reference src/generate_numerical_data.py (ts_interpolate): takes
the raw multi-rate MDSplus dump and emits a uniform-dt table per shot with
engineered features, value-identical to the reference. The port's own copy
of ``kstar_tpu/data/ts_pipeline.py`` (numpy, pandas and scipy only): the
same calls in the same order, so its tables equal the JAX package's exactly
(tests/test_torch_etl.py).

Steps (reference line refs in parens):

  1. global linear forward NaN interpolation, THEN inf -> nan (:19-22 — the
     order matters: infs survive interpolation), Thomson + TCI fillna(0)
  2. unit scaling: Ne/1e19, Te/1e3 (:35-40), |x|<=1e2 bound on Thomson (:42-45),
     |x|<=2 bound on BETAP_DLM03 (:48), DEFAULT_COLS |.| / clamp>=0 (:51-56),
     Ip/1e6 (:59), TCI clamp (:62-64), HA/1e18 (:67), RC03/VCM03 * -1e-6 and
     RCPPU1/RCPPL1 * 1e-6 (:70-76)
  3. per-shot validity filters (:89-129): ne_inter01 nulls/constant, < 2 s
     span, any column >50% null, DEFAULT_COLS >50% zero or constant
  4. per-shot ffill + IQR outlier clipping (q15/q85, whisker 1.25, \\ipmhd
     exempt) (:143-162)
  5. cubic resampling (fill_value='extrapolate') of every column onto the
     uniform grid arange(tftsrt - 4 dt, tipminf + 8 dt + dt, dt), with the
     reference's shot-level time-window rejections (:165-207)
  6. engineered features: Thomson core/edge averages (:212-217), Greenwald
     density nG = Ip/(pi a^2) and ne_nG_ratio = ne/nG * 0.1 (:220-221),
     vessel current Iv = VCM03 - RC03 (:224), then the final negativity
     removal pass over DEFAULT/TCI/Thomson/WTOT (:230-243)
  7. frame_idx = int(round(t * fps)) (:293-308)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from ..config import DT_0D, FPS, Schema


def _total_cols(df: pd.DataFrame) -> List[str]:
    """The reference's filter column set: all signal groups minus EXCEPT_COLS
    (reference :80-82)."""
    cols = (Schema.DEFAULT_COLS + Schema.LM + Schema.HCM + Schema.DL
            + Schema.LV + Schema.RC + Schema.TCI + Schema.HA + Schema.TS)
    return [c for c in cols if c not in Schema.EXCEPT_COLS and c in df.columns]


def _bound(s: pd.Series, value: float) -> pd.Series:
    """|x| <= value clamp preserving sign (reference _bound, :42-43)."""
    return s.where(s.abs() < value, value * np.sign(s))


def clean_signals(df: pd.DataFrame, cols: Optional[Sequence[str]] = None) -> pd.DataFrame:
    """Steps 1-2: global interpolation, unit scalings, physical bounds.

    Matches the reference exactly, including the quirks: the linear
    interpolation runs over the WHOLE concatenated frame (bleeding values
    across shot boundaries) and before the inf->nan replacement.
    """
    df = df.copy()
    df = df.interpolate(method="linear", limit_direction="forward")
    df = df.replace([np.inf, -np.inf], np.nan)

    thomson = [c for c in Schema.TS if c in df.columns]
    df[thomson] = df[thomson].fillna(0)
    tci = [c for c in Schema.TCI if c in df.columns]
    df[tci] = df[tci].fillna(0)

    for col in Schema.TS_NE_CORE_COLS + Schema.TS_NE_EDGE_COLS:
        if col in df.columns:
            df[col] = df[col] / 1e19
    for col in Schema.TS_TE_CORE_COLS + Schema.TS_TE_EDGE_COLS:
        if col in df.columns:
            df[col] = df[col] / 1e3
    for col in thomson:
        df[col] = _bound(df[col], 1e2)
    if "\\BETAP_DLM03" in df.columns:
        df["\\BETAP_DLM03"] = _bound(df["\\BETAP_DLM03"], 2.0)

    for col in Schema.DEFAULT_COLS:
        if col not in df.columns:
            continue
        if col in ("\\ipmhd", "\\bcentr"):
            df[col] = df[col].abs()
        else:
            df[col] = df[col].clip(lower=0)
    if "\\ipmhd" in df.columns:
        df["\\ipmhd"] = df["\\ipmhd"] / 1e6

    for col in tci:
        df[col] = df[col].clip(lower=0)
    ha = [c for c in Schema.HA if c in df.columns]
    if ha:
        df[ha] = df[ha] / 1e18
    for col, s in (("\\RC03", -1e-6), ("\\VCM03", -1e-6),
                   ("\\RCPPU1", 1e-6), ("\\RCPPL1", 1e-6)):
        if col in df.columns:
            df[col] = df[col] * s
    return df


def valid_shots(df: pd.DataFrame, cols: Optional[Sequence[str]] = None,
                min_duration: float = 2.0) -> List[int]:
    """Step 3: the reference's per-shot rejection filters (:89-129), in the
    reference's order and with its exact thresholds."""
    cols = list(cols) if cols is not None else _total_cols(df)
    keep = []
    for shot in np.unique(df.shot.values):
        d = df[df.shot == shot]
        if len(d) == 0:
            continue
        if "\\ne_inter01" in d.columns:
            ne = d["\\ne_inter01"]
            if ne.isnull().sum() > 0.5 * len(d) or ne.max() - ne.min() < 1e-3:
                continue
        if d.time.iloc[-1] - d.time.iloc[0] < min_duration:
            continue
        nulls = d[cols].isnull().sum()
        if (nulls > 0.5 * len(d)).any():
            continue
        bad = False
        for col in Schema.DEFAULT_COLS:
            if col not in d.columns:
                continue
            if np.sum(d[col].values == 0) > 0.5 * len(d):
                bad = True
                break
            if d[col].max() - d[col].min() < 1e-3:
                bad = True
                break
        if not bad:
            keep.append(shot)
    return keep


def iqr_clip(x: np.ndarray, q_low: float = 15, q_high: float = 85,
             whisker: float = 1.25) -> np.ndarray:
    """Per-signal IQR outlier clipping (reference :147-162)."""
    lo, hi = np.nanpercentile(x, [q_low, q_high])
    iqr = hi - lo
    return np.clip(x, lo - whisker * iqr, hi + whisker * iqr)


def resample_shot(d: pd.DataFrame, cols: Sequence[str], tftsrt: float,
                  tipminf: float, dt: float,
                  ffill_cols: Optional[Sequence[str]] = None) -> pd.DataFrame:
    """Steps 4-5 for one shot: ffill, IQR clip (\\ipmhd exempt), cubic
    resampling with extrapolation onto arange(tftsrt-4dt, tipminf+8dt+dt, dt)
    (reference :143-207). The caller applies the shot-level time-window
    rejections.

    Quirk preserved: the reference ffills only the schema's total_cols
    (minus EXCEPT_COLS) but clips/resamples every column in ``cols``.
    """
    from scipy.interpolate import interp1d

    d = d.copy()
    cols = [c for c in cols if c in d.columns]
    fc = [c for c in (ffill_cols if ffill_cols is not None else _total_cols(d))
          if c in d.columns]
    d[fc] = d[fc].ffill()
    for col in cols:
        if col == "\\ipmhd":
            continue
        d.loc[:, col] = iqr_clip(d[col].values)

    t = d.time.values.reshape(-1)
    t_start = tftsrt - dt * 4
    t_end = tipminf + dt * 8
    grid = np.arange(t_start, t_end + dt, dt)
    out = {"time": grid}
    for col in cols:
        y = d[col].values.reshape(-1)
        f = interp1d(t, y, kind="cubic" if len(t) >= 4 else "linear",
                     fill_value="extrapolate")
        out[col] = f(grid).reshape(-1)
    return pd.DataFrame(out)


def engineer_features(df: pd.DataFrame) -> pd.DataFrame:
    """Step 6: Thomson averages, Greenwald density/fraction, vessel current,
    then the final negativity-removal pass (reference :212-243)."""
    df = df.copy()
    for name, cs in (("\\TS_NE_CORE_AVG", Schema.TS_NE_CORE_COLS),
                     ("\\TS_NE_EDGE_AVG", Schema.TS_NE_EDGE_COLS),
                     ("\\TS_TE_CORE_AVG", Schema.TS_TE_CORE_COLS),
                     ("\\TS_TE_EDGE_AVG", Schema.TS_TE_EDGE_COLS)):
        cs = [c for c in cs if c in df.columns]
        if cs:
            df[name] = df[cs].mean(axis=1)

    if "\\ipmhd" in df.columns and "\\aminor" in df.columns:
        df["\\nG"] = df["\\ipmhd"] / np.pi / df["\\aminor"] ** 2
        if "\\ne_inter01" in df.columns:
            df["\\ne_nG_ratio"] = df["\\ne_inter01"] / df["\\nG"] * 0.1
    if "\\VCM03" in df.columns and "\\RC03" in df.columns:
        df["\\Iv"] = df["\\VCM03"] - df["\\RC03"]

    for col in Schema.DEFAULT_COLS:
        if col not in df.columns:
            continue
        if col == "\\ipmhd":
            df[col] = df[col].abs()
        else:
            df[col] = df[col].clip(lower=0)
    for group in (Schema.TCI, Schema.TS):
        for col in group:
            if col in df.columns:
                df[col] = df[col].clip(lower=0)
    if "\\WTOT_DLM03" in df.columns:
        df["\\WTOT_DLM03"] = df["\\WTOT_DLM03"].clip(lower=0)
    return df


def _disrupt_times(row) -> tuple:
    """(tftsrt, tipminf) from either naming convention: the raw 2022 shot
    list (t_flattop_start / t_ip_min_fault) or the extended shot log
    (tftsrt / tipminf)."""
    tftsrt = row.t_flattop_start if hasattr(row, "t_flattop_start") else row.tftsrt
    tipminf = row.t_ip_min_fault if hasattr(row, "t_ip_min_fault") else row.tipminf
    return float(tftsrt), float(tipminf)


def sync_video_0d(ts_df: pd.DataFrame, disrupt_df: pd.DataFrame,
                  fps: float = FPS) -> pd.DataFrame:
    """Video/0D synchronization table (rebuild of reference
    src/generate_sync_video_0D.py): one row per 0D sample with the matching
    camera frame index and the time distance to the quench, used for
    aligning legacy clip folders to table rows. The modern pipeline matches
    indices directly (data/windows.py:multimodal_windows); this table is
    kept for dataset auditing."""
    rows = []
    for shot in np.unique(ts_df.shot.values):
        if shot not in set(disrupt_df.shot.values.tolist()):
            continue
        r = disrupt_df[disrupt_df.shot == shot].iloc[0]
        d = ts_df[ts_df.shot == shot]
        t = d.time.values
        frame_idx = np.clip((t * fps).astype(int), 0, int(r.frame_cutoff))
        rows.append(pd.DataFrame({
            "shot": shot, "time": t, "frame_idx": frame_idx,
            "t_to_quench": float(r.tipminf) - t,
            "in_plasma": (t >= float(r.tftsrt)) & (t <= float(r.tipminf)),
        }))
    return pd.concat(rows, ignore_index=True) if rows else pd.DataFrame()


def build_0d_table(
    raw: pd.DataFrame,
    disrupt_df: pd.DataFrame,
    cols: Optional[Sequence[str]] = None,
    dt: float = DT_0D,
    fps: float = FPS,
) -> pd.DataFrame:
    """Full ETL: raw multi-rate dump -> uniform-dt engineered table
    (the reference's KSTAR_Disruption_ts_data_extend.csv at dt=4/210, or the
    5ms multimodal table at dt=1/210). Value-identical to the reference
    ts_interpolate."""
    if cols is None:
        cols = [c for c in raw.columns
                if c not in ("shot", "time", "Unnamed: 0") and raw[c].notna().any()]
    cols = [c for c in cols if c in raw.columns]

    cleaned = clean_signals(raw)
    disrupt_shots = set(disrupt_df.shot.values.tolist())
    shots = [s for s in valid_shots(cleaned, _total_cols(cleaned))
             if s in disrupt_shots]

    tables = []
    for shot in shots:
        row = disrupt_df[disrupt_df.shot == shot].iloc[0]
        tftsrt, tipminf = _disrupt_times(row)
        d = cleaned[cleaned.shot == shot]
        t = d.time.values.reshape(-1)
        t_end = float(np.max(t))
        # shot-level time-window rejections (reference :174-194)
        if t_end < tftsrt or t_end < 2:
            continue
        if int((t_end - tftsrt) / (t[1] - t[0])) < 4:
            continue
        if t_end < tipminf - dt * 8:
            continue
        res = resample_shot(d, cols, tftsrt, tipminf, dt)
        res.insert(0, "shot", int(shot))
        tables.append(res)

    if not tables:
        return pd.DataFrame()
    table = pd.concat(tables, ignore_index=True)
    table = engineer_features(table)
    # step 7: frame index column (reference :294 — round, not truncate)
    table["frame_idx"] = np.rint(table.time.values * fps).astype(int)
    return table
