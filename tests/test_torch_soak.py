"""The port's two soaks (``kstar_torch.analysis.soak_long_shot`` and
``soak_library_sweep``) on the CPU at a small size, f32, with the plain
versions of the kernels: a 300-frame shot (the sweep cold and steady, the
plain-table route, the k = 16 stream, the GIF) and a 4-shot library (both
frame ladders at the default budget, and a budget forced to a quarter of
the stack so that it is swept in several groups). Every curve is held
against the shot's own ``sweep_device`` / ``predict_video_shot`` to 1e-5."""

import numpy as np
import pytest
import torch

from kstar_torch.analysis import soak_library_sweep, soak_long_shot
from kstar_torch.config import ViViTConfig
from kstar_torch.infer import continuous

CFG = ViViTConfig(image_size=32, patch_size=16, n_frames=21, dim=32, depth=1, n_heads=2,
                  d_head=16, scale_dim=2)
F32_TOL = (1e-5, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_long_shot_soak_on_the_cpu(tmp_path):
    res = soak_long_shot.main(300, device="cpu", cfg=CFG, crop=32, batch=16,
                              compute_dtype=torch.float32, stream_frames=160,
                              out_dir=str(tmp_path))
    assert res["windows"] == 300 - 21 - 3 and res["steady_equals_cold"]
    assert res["vs_plain_table_max_abs"] == 0.0          # both are the plain table here
    assert res["stream_frames"] == 144 and res["stream_vs_sweep_max_abs"] <= F32_TOL[0]
    assert res["steady_peak_gib"] is None and res["k1_launches"] == 0


def test_make_shot_is_seeded_and_brightens_the_tail():
    a, b = soak_long_shot.make_shot(500, 16, seed=3), soak_long_shot.make_shot(500, 16, seed=3)
    assert a.shape == (500, 16, 16, 3) and a.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(a, soak_long_shot.make_shot(500, 16, seed=4))
    assert (a[-420:, 6:10, 6:10] >= 200).all() and not (a[:80, 6:10, 6:10] >= 200).all()


def test_library_soak_on_the_cpu():
    res = soak_library_sweep.main(4, device="cpu", lengths=(60, 120), cfg=CFG, crop=32,
                                  batch=16, compute_dtype=torch.float32, tol=F32_TOL,
                                  per_shot=2)
    runs = res["runs"]
    assert runs["sub-octave"]["groups"] == 1 and runs["sub-octave forced"]["groups"] >= 2
    for run in runs.values():
        assert run["vs_per_shot_max_abs"] <= F32_TOL[0]
    assert res["ladders_max_abs"] <= F32_TOL[0]
    assert runs["pow2"]["frame_padding"] >= runs["sub-octave"]["frame_padding"]
    assert continuous.bucket_len(90) == 96               # the sub-octave ladder is back


def test_library_soak_fails_on_a_wrong_curve(monkeypatch):
    """A library whose curves part from the per-shot ones raises."""
    real = continuous.VideoSweeper.sweep_shots

    def shifted(self, *args, **kw):
        return [p + 1e-3 for p in real(self, *args, **kw)]

    monkeypatch.setattr(continuous.VideoSweeper, "sweep_shots", shifted)
    with pytest.raises(RuntimeError, match="against per-shot"):
        soak_library_sweep.main(2, device="cpu", lengths=(40, 50), cfg=CFG, crop=32,
                                batch=16, compute_dtype=torch.float32, tol=F32_TOL,
                                per_shot=1)
