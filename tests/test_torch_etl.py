"""kstar_torch's dataset ETL against kstar_tpu's, on the CPU.

The port keeps its own copies of the four ETL modules (``shotlog``,
``ts_pipeline``, ``profiles``, ``video_pipeline``): the same numpy, pandas,
scipy and cv2 calls in the same order. So every result here must be EXACTLY
equal (``check_exact=True``, ``np.array_equal``, identical files); any
difference is a fault. The fixtures are built in the tests, as
``test_etl.py``, ``test_video_pipeline.py`` and ``test_legacy_clips.py``
build theirs.
"""

import os

import numpy as np
import pandas as pd
import pytest

from kstar_torch.config import Schema
from kstar_torch.data import profiles as tprof
from kstar_torch.data import shotlog as tlog
from kstar_torch.data import ts_pipeline as tts
from kstar_tpu.data import profiles as jprof
from kstar_tpu.data import shotlog as jlog
from kstar_tpu.data import ts_pipeline as jts

TS_CHANNELS = 4        # Thomson channels per core/edge x Te/Ne group


def _raw(n_shots=3, n=400, seed=0):
    """A raw multi-rate MDSplus-style dump: the signals build_0d_table turns
    into the 18 input features, in raw units (A, m^-3, eV, negative Rogowski
    currents), with NaNs, infs and zeros to clean. Shot 100 + n_shots is
    rejected (its ne_inter01 is constant), shot 101 + n_shots lasts < 2 s."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_shots + 2):
        span = 1.5 if i == n_shots + 1 else 4.0
        t = np.sort(rng.uniform(0, span, n))
        d = {"shot": 100 + i, "time": t}
        for j, c in enumerate(Schema.DEFAULT_COLS):
            d[c] = 1.0 + 0.2 * j + 0.1 * np.sin(t * (j + 1)) + rng.normal(0, 0.02, n)
        d["\\ipmhd"] = -(0.4 + 0.05 * t) * 1e6
        d["\\aminor"] = 0.5 + 0.01 * np.cos(t)
        d["\\RC03"] = 0.6 + 0.1 * t
        d["\\VCM03"] = 0.7 + 0.1 * t
        d["\\ne_inter01"] = (2 + 0.2 * t) if i != n_shots else np.full(n, 2.0)
        d["\\BETAP_DLM03"] = 0.5 + 3 * np.sin(t)           # crosses the +-2 bound
        d["\\WTOT_DLM03"] = 1e5 * (1 + 0.1 * t)
        d["\\bcentr"] = -1.8 + rng.normal(0, 0.01, n)
        d["\\TOR_HA01"] = 1e18 * (1 + rng.random(n))
        for g, scale in ((Schema.TS_TE_CORE_COLS, 1e3), (Schema.TS_TE_EDGE_COLS, 3e2),
                         (Schema.TS_NE_CORE_COLS, 3e19), (Schema.TS_NE_EDGE_COLS, 1e19)):
            for k, c in enumerate(g[:TS_CHANNELS]):
                d[c] = scale * (1 + 0.1 * k + 0.05 * np.sin(t)) * rng.uniform(0.9, 1.1, n)
        df = pd.DataFrame(d)
        df.loc[rng.choice(n, 10, replace=False), "\\q95"] = np.nan
        df.loc[rng.choice(n, 3, replace=False), "\\li"] = np.inf
        df.loc[rng.choice(n, 5, replace=False), Schema.TS_TE_CORE_COLS[0]] = np.nan
        df.loc[rng.choice(n, 4, replace=False), "\\kappa"] = 0.0
        if i != n_shots:
            df.loc[rng.choice(n, 2, replace=False), "\\ne_inter01"] = -1.0
        rows.append(df)
    return pd.concat(rows, ignore_index=True)


def _disrupt(shots, tftsrt=0.5, tipminf=3.5):
    return pd.DataFrame({"shot": shots, "tftsrt": tftsrt, "tipminf": tipminf,
                         "frame_cutoff": int(tipminf * 210) + 1})


@pytest.fixture(scope="module")
def raw():
    return _raw()


def assert_frames(a, b):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


# ---------------------------------------------------------------------------
# shot log
# ---------------------------------------------------------------------------

def test_startup_cutoff_and_shot_log(tiny_dataset):
    shots, disrupt_df, _ = tiny_dataset
    for s in shots[:4]:
        b = jlog.mean_brightness(s.frames)
        assert np.array_equal(tlog.mean_brightness(s.frames), b)
        srt = jlog.detect_startup(b)
        assert tlog.detect_startup(b) == srt
        assert tlog.detect_cutoff(b, start=srt + 1) == jlog.detect_cutoff(b, start=srt + 1)
        assert tlog.detect_cutoff(b, eps=2.0) == jlog.detect_cutoff(b, eps=2.0)
    frames = {s.shot: s.frames for s in shots}
    assert_frames(tlog.extend_shot_log(frames), jlog.extend_shot_log(frames))
    base = disrupt_df[["shot", "tftsrt", "tipminf"]].iloc[:3]
    assert_frames(tlog.extend_shot_log(frames, dt_quench=0.05, base_log=base),
                  jlog.extend_shot_log(frames, dt_quench=0.05, base_log=base))


# ---------------------------------------------------------------------------
# the 0D table
# ---------------------------------------------------------------------------

def test_clean_signals_and_valid_shots(raw):
    cleaned = tts.clean_signals(raw)
    assert_frames(cleaned, jts.clean_signals(raw))
    assert tts._total_cols(cleaned) == jts._total_cols(cleaned)
    keep = tts.valid_shots(cleaned)
    assert keep == jts.valid_shots(cleaned) == [100, 101, 102]


def test_iqr_clip():
    x = np.r_[np.random.default_rng(1).normal(size=200), 1e6, -1e6, np.nan]
    assert np.array_equal(tts.iqr_clip(x), jts.iqr_clip(x), equal_nan=True)
    assert np.array_equal(tts.iqr_clip(x, 25, 75, 1.5), jts.iqr_clip(x, 25, 75, 1.5),
                          equal_nan=True)


@pytest.mark.parametrize("rows", [400, 3])        # cubic, and linear below 4 rows
def test_resample_shot(raw, rows):
    d = tts.clean_signals(raw)
    d = d[d.shot == 100].iloc[:rows]
    cols = ["\\q95", "\\ipmhd", "\\li", Schema.TS_TE_CORE_COLS[0]]
    got = tts.resample_shot(d, cols, tftsrt=0.5, tipminf=3.5, dt=0.02)
    assert_frames(got, jts.resample_shot(d, cols, tftsrt=0.5, tipminf=3.5, dt=0.02))


def test_engineer_features(raw):
    assert_frames(tts.engineer_features(raw), jts.engineer_features(raw))


@pytest.mark.parametrize("dt", [4 / 210, 1 / 210])
def test_build_0d_table(raw, dt):
    disrupt = _disrupt([100, 101, 102, 103, 104])
    table = tts.build_0d_table(raw, disrupt, dt=dt)
    assert_frames(table, jts.build_0d_table(raw, disrupt, dt=dt))
    assert sorted(table.shot.unique()) == [100, 101, 102]
    assert set(Schema.INPUT_FEATURES) <= set(table.columns)
    # the raw 2022 shot list's column names are accepted too
    raw_names = disrupt.rename(columns={"tftsrt": "t_flattop_start",
                                        "tipminf": "t_ip_min_fault"})
    assert_frames(tts.build_0d_table(raw, raw_names, dt=dt), table)


def test_sync_video_0d(raw):
    disrupt = _disrupt([100, 102, 999])
    table = tts.build_0d_table(raw, disrupt)
    assert_frames(tts.sync_video_0d(table, disrupt), jts.sync_video_0d(table, disrupt))
    assert_frames(tts.sync_video_0d(table, disrupt, fps=100.0),
                  jts.sync_video_0d(table, disrupt, fps=100.0))


# ---------------------------------------------------------------------------
# Thomson profiles
# ---------------------------------------------------------------------------

def test_profiles(raw):
    vals = np.random.default_rng(0).uniform(0.5, 3, (5, 27))
    assert np.array_equal(tprof.get_profile(vals, n_points=32),
                          jprof.get_profile(vals, n_points=32))
    assert np.array_equal(tprof.get_profile(vals[0]), jprof.get_profile(vals[0]))
    table = tts.clean_signals(raw)
    for kind in ("te", "ne"):
        assert np.array_equal(tprof.profile_tensor(table, kind, n_points=64),
                              jprof.profile_tensor(table, kind, n_points=64))


# ---------------------------------------------------------------------------
# video: legacy clips (no cv2), then the cv2 decode paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tftsrt_s,frame_tipminf,distance", [
    (0.1, 180, 0), (0.05, 150, 3), (0.2, 100, 10), (0.0, 25, 0)])
def test_legacy_clips(tmp_path, tftsrt_s, frame_tipminf, distance):
    from kstar_torch.data import video_pipeline as tvp
    from kstar_tpu.data import video_pipeline as jvp

    rng = np.random.default_rng(frame_tipminf)
    frames = rng.integers(0, 256, size=(200, 6, 5, 3), dtype=np.uint8)
    kw = dict(duration=21, distance=distance, fps=210, gap=20)
    assert (tvp.legacy_clip_segments(tftsrt_s, frame_tipminf, len(frames), **kw)
            == jvp.legacy_clip_segments(tftsrt_s, frame_tipminf, len(frames), **kw))
    assert tvp.legacy_frame_calculator(tftsrt_s, 210, 20) == \
        jvp.legacy_frame_calculator(tftsrt_s, 210, 20)
    got = tvp.extract_legacy_clips(frames, tftsrt_s, frame_tipminf, flip=True,
                                   save_dir=os.fspath(tmp_path / "t"), shot=7, **kw)
    want = jvp.extract_legacy_clips(frames, tftsrt_s, frame_tipminf, flip=True,
                                    save_dir=os.fspath(tmp_path / "j"), shot=7, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("clip", "path")} == \
            {k: v for k, v in w.items() if k not in ("clip", "path")}
        assert np.array_equal(g["clip"], w["clip"])
        assert np.array_equal(np.load(g["path"]), np.load(w["path"]))
        assert os.path.relpath(g["path"], tmp_path / "t") == \
            os.path.relpath(w["path"], tmp_path / "j")


H = W = 64
T = 12


def _frames(cv2, seed=0, n=T):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, size=(n, 8, 8, 3), dtype=np.uint8)
    return np.stack([cv2.resize(f, (W, H), interpolation=cv2.INTER_LINEAR)
                     for f in base])


def _write_avi(cv2, path, frames):
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 30, (W, H))
    if not wr.isOpened():
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (W, H))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()


def test_decode_avi_and_repack(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from kstar_torch.data import video_pipeline as tvp
    from kstar_tpu.data import video_pipeline as jvp

    p2 = os.fspath(tmp_path / "000002tv02.avi")
    _write_avi(cv2, p2, _frames(cv2, 1))
    missing = os.fspath(tmp_path / "000002tv01.avi")
    for resize in (H, 48):
        got = tvp.decode_avi(missing, resize=resize, fallback_path=p2)
        assert got.shape == (T, resize, resize, 3)
        assert np.array_equal(got, jvp.decode_avi(missing, resize=resize, fallback_path=p2))
    with pytest.raises(FileNotFoundError):
        tvp.decode_avi(os.fspath(tmp_path / "none.avi"), resize=H)

    shot_dir = tmp_path / "temp" / "7"
    shot_dir.mkdir(parents=True)
    for i, f in enumerate(_frames(cv2, 5)):
        cv2.imwrite(os.fspath(shot_dir / f"{i:06d}.jpg"), f, [cv2.IMWRITE_JPEG_QUALITY, 95])
    for resize in (None, 32):
        assert np.array_equal(tvp.repack_jpg_folder(os.fspath(shot_dir), resize),
                              jvp.repack_jpg_folder(os.fspath(shot_dir), resize))
    outs = tvp.repack_dataset(os.fspath(tmp_path / "temp"), os.fspath(tmp_path / "npy"))
    assert np.array_equal(np.load(outs[7]), jvp.repack_jpg_folder(os.fspath(shot_dir)))


def test_convert_shots_serial_and_spawned(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from kstar_torch.data import video_pipeline as tvp
    from kstar_tpu.data import video_pipeline as jvp

    avi_dir = tmp_path / "avi"
    avi_dir.mkdir()
    shots = [3, 4]
    _write_avi(cv2, os.fspath(avi_dir / "000003tv01.avi"), _frames(cv2, 3))
    _write_avi(cv2, os.fspath(avi_dir / "000004tv02.avi"), _frames(cv2, 4))   # tv02 only
    want = jvp.convert_shots(os.fspath(avi_dir), os.fspath(tmp_path / "j"), shots, resize=H)
    serial = tvp.convert_shots(os.fspath(avi_dir), os.fspath(tmp_path / "s"), shots, resize=H)
    spawned = tvp.convert_shots(os.fspath(avi_dir), os.fspath(tmp_path / "p"), shots,
                                resize=H, n_workers=2)
    for s in shots:
        a = np.load(want[s])
        assert a.shape == (T, H, W, 3)
        assert np.array_equal(np.load(serial[s]), a)
        assert np.array_equal(np.load(spawned[s]), a)
