"""kstar_torch.analysis.campaign_dist_sweep, the port's twin of
analysis/campaign_dist_sweep.py, on the CPU.

* Its constants are JAX's, read from the JAX script with ``ast`` (importing
  it would set JAX's compilation cache directory).
* Its fixture is ``kstar_tpu.data.synthetic.make_dataset`` called with the
  JAX script's own keyword arguments (read with ``ast``), at fewer shots and
  frames: frames, shot log and leads exactly.
* ``score_member`` on a tiny f32 ViViT whose weights JAX's ``init`` made
  (carried over by ``state_dict_from_flax``) against JAX's sequence on the
  same shots (``run_eval_epoch`` -> ``evaluate_probs``, ``sweep_prob_curves``
  -> ``score_alarms``): probabilities to 1e-5, the row's metrics equal.
* ``main`` at 1 horizon, 2 seeds, 1 epoch and 64 samples writes JAX's
  top-level and row keys, and two runs give equal rows; ``--dist`` point
  files merge into the summary one run writes.
"""

import ast
import collections
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from kstar_torch.analysis import campaign_dist_sweep as camp
from kstar_torch.cli import common as cli_common
from kstar_torch.config import OptimConfig, ViViTConfig
from kstar_torch.data import VideoDataset
from kstar_torch.models.vivit import ViViT as TViViT
from kstar_torch.train import create_train_state
from kstar_torch.weights import state_dict_from_flax
from kstar_tpu.config import AugmentConfig as JAugmentConfig
from kstar_tpu.config import LossConfig as JLossConfig
from kstar_tpu.data import VideoDataset as JVideoDataset
from kstar_tpu.data import VideoStore as JVideoStore
from kstar_tpu.data import synthetic as jsynthetic
from kstar_tpu.data.device_pipe import DevicePreprocessor as JDevicePreprocessor
from kstar_tpu.eval import score_alarms as j_score_alarms
from kstar_tpu.eval import sweep_prob_curves as j_sweep_prob_curves
from kstar_tpu.eval.evaluate import evaluate_probs as j_evaluate_probs
from kstar_tpu.losses import ldam_margins as j_ldam_margins
from kstar_tpu.models.vivit import ViViT as JViViT
from kstar_tpu.train.loop import make_eval_step as j_make_eval_step
from kstar_tpu.train.loop import run_eval_epoch as j_run_eval_epoch

JAX_SCRIPT = Path(__file__).resolve().parents[1] / "analysis" / "campaign_dist_sweep.py"
CONSTANTS = ("SEEDS", "DIST_GRID", "THRESHOLD", "DWELL_S", "N_SHOTS", "N_NORMAL",
             "N_EVAL_D", "N_EVAL_N", "N_FRAMES", "LEAD_S", "SEQ_LEN", "CROP", "BATCH",
             "EPOCHS", "SAMPLES_PER_EPOCH", "STEPS_PER_DISPATCH")
SMALL = dict(n_shots=6, n_normal=1, n_eval_disrupt=1, n_eval_normal=1, n_frames=220)
VIVIT = dict(image_size=32, patch_size=16, n_frames=21, dim=32, depth=1, n_heads=2,
             d_head=16, scale_dim=2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_script():
    """(module-level constants, the make_dataset call's keywords) of the JAX
    script, by ``ast`` only."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
            if isinstance(target, ast.Name):
                pairs = [(target, value)]
            elif isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple):
                pairs = zip(target.elts, value.elts)
            else:
                continue
            for t, v in pairs:
                try:
                    consts[t.id] = ast.literal_eval(v)
                except ValueError:
                    pass
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "make_dataset")
    kwargs = {k.arg: eval(compile(ast.Expression(k.value), str(JAX_SCRIPT), "eval"),
                          dict(consts)) for k in call.keywords}
    return consts, kwargs


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_equal_jax(jax_script, name):
    assert getattr(camp, name) == jax_script[0][name]


def test_fixture_equals_jax_make_dataset(jax_script):
    kwargs = {**jax_script[1], "n_shots": 2, "n_eval_disrupt": 1, "n_eval_normal": 1,
              "n_normal": 1, "n_frames": 400}
    assert camp.fixture_kwargs(**{k: kwargs[k] for k in
                                  ("n_shots", "n_eval_disrupt", "n_eval_normal",
                                   "n_normal", "n_frames")}) == kwargs
    j_shots, j_df, _ = jsynthetic.make_dataset(**kwargs)
    store, df, leads = camp.build_fixture(n_shots=2, n_eval_disrupt=1, n_eval_normal=1,
                                          n_normal=1, n_frames=400)
    pd.testing.assert_frame_equal(df, j_df)
    assert sorted(store.arrays) == [s.shot for s in j_shots]
    for s in j_shots:
        np.testing.assert_array_equal(store.arrays[s.shot], s.frames)
    assert leads == {s.shot: s.lead_s for s in j_shots if s.is_disrupt}


@pytest.fixture(scope="module")
def member_pair():
    """The small fixture, a tiny f32 ViViT from JAX's init on both sides,
    the port's state and JAX's (params, batch_stats)."""
    store, df, _ = camp.build_fixture(**SMALL)
    jm = JViViT(dtype=jnp.float32, dropout=0.0, embedd_dropout=0.0, **VIVIT)
    key = jax.random.key(0)
    # jitted: flax's eager init takes seconds
    variables = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                          jnp.zeros((1, 21, 32, 32, 3)), train=False))(key)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm = TViViT(dropout=0.0, embedd_dropout=0.0, **VIVIT)
    tm.load_state_dict(state_dict_from_flax(params))
    state = create_train_state(tm, OptimConfig(lr=2e-4), seed=40)
    return store, df, jm, variables["params"], state


def test_score_member_matches_jax_sequence(member_pair):
    store, df, jm, params, state = member_pair
    dist = 105
    _, _, test_s, shots = camp.sweep_list(store, df)
    test_ds = VideoDataset(store, df, test_s, seq_len=camp.SEQ_LEN, dist=dist)
    probs, labels, curves = camp.member_outputs(state.model, test_ds, store, df, shots, dist,
                                                torch.device("cpu"), crop=32)
    row = camp.score_member(state, test_ds, store, df, shots, dist, torch.device("cpu"),
                            best_f1=0.5, crop=32)

    # JAX's run_point, member by member
    j_store = JVideoStore.from_arrays(store.arrays)
    j_test = JVideoDataset(j_store, df, test_s, seq_len=camp.SEQ_LEN, dist=dist)
    loss_cfg = JLossConfig(loss_type="Focal", use_weighting=True)
    EvalState = collections.namedtuple("EvalState", "params batch_stats")
    put_eval = JDevicePreprocessor(32, JAugmentConfig(), train=False, out_dtype=jnp.float32)
    _, _, _, (j_probs, j_labels) = j_run_eval_epoch(
        j_make_eval_step(jm, loss_cfg), EvalState(params, {}), j_test, camp.BATCH,
        jnp.ones(2), jnp.asarray(j_ldam_margins(j_test.class_counts(), loss_cfg.ldam_max_m)),
        jnp.zeros(3), put=put_eval, collect_probs=True)
    res = j_evaluate_probs(np.asarray(j_probs), np.asarray(j_labels), camp.THRESHOLD)
    j_curves = j_sweep_prob_curves(jm, params, {}, j_store, df, shots, seq_len=camp.SEQ_LEN,
                                   dist=dist, crop_size=32, batch_size=128,
                                   compute_dtype=jnp.float32)
    s = j_score_alarms(j_curves, camp.THRESHOLD, min_dwell_s=camp.DWELL_S)["summary"]

    assert len(probs) > 0 and len(curves) == len(shots) == len(j_curves)
    np.testing.assert_array_equal(labels, np.asarray(j_labels))
    np.testing.assert_allclose(probs, np.asarray(j_probs), **TOL)
    for (shot, _, tx, p), (j_shot, _, j_tx, j_p) in zip(curves, j_curves):
        assert shot == j_shot
        np.testing.assert_allclose(tx, j_tx, **TOL)
        np.testing.assert_allclose(p, j_p, **TOL)
    assert row == {
        "dist": dist, "horizon_s": dist / 210.0, "seed": 40,
        "test_macro_f1": round(float(res["macro_f1"]), 4),
        "test_roc_auc": round(float(res["roc_auc"]), 4), "best_valid_f1": 0.5,
        "detection_rate": s["detection_rate"], "false_alarm_rate": s["false_alarm_rate"],
        "warning_p50_s": s["warning_p50_s"], "warning_p90_s": s["warning_p90_s"],
        "n_disrupt": s["n_disrupt"], "n_normal": s["n_normal"]}


def _run(out_dir, dists):
    argv = ["--dist", *map(str, dists), "--seeds", "40", "41", "--epochs", "1",
            "--samples_per_epoch", "64", "--device", "cpu", "--out_dir", str(out_dir)]
    return camp.main(argv, cfg=ViViTConfig(**VIVIT), fixture=SMALL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two horizons in one command, and the same two one per command into
    one directory (the first of them repeats the one command's dist 21)."""
    root = tmp_path_factory.mktemp("campaign")
    both = _run(root / "both", [21, 105])
    with pytest.MonkeyPatch.context() as mp:     # the figure once is enough
        mp.setattr(cli_common, "draw_figure", lambda path, draw: None)
        first = _run(root / "split", [21])
        merged = _run(root / "split", [105])
    return {"both": both, "first": first, "merged": merged, "root": root}


JAX_TOP_KEYS = ["grid", "fixture", "protocol", "wall_clock", "trend", "rows"]
JAX_ROW_KEYS = ["dist", "horizon_s", "seed", "test_macro_f1", "test_roc_auc",
                "best_valid_f1", "detection_rate", "false_alarm_rate", "warning_p50_s",
                "warning_p90_s", "n_disrupt", "n_normal"]


def test_main_writes_jax_schema_and_repeats(runs):
    first, both = runs["first"], runs["both"]
    assert list(first) == JAX_TOP_KEYS
    assert [list(r) for r in first["rows"]] == [JAX_ROW_KEYS] * 2
    assert [r["seed"] for r in first["rows"]] == [40, 41]
    assert first["grid"] == {"dist": [21], "seeds": [40, 41]}
    assert first["protocol"]["epochs"] == 1 and first["protocol"]["samples_per_epoch"] == 64
    assert first["rows"] == [r for r in both["rows"] if r["dist"] == 21]
    on_disk = json.loads((runs["root"] / "both" / "campaign_dist_sweep.json").read_text())
    assert list(on_disk) == JAX_TOP_KEYS and on_disk["rows"] == both["rows"]
    csv = pd.read_csv(runs["root"] / "both" / "campaign_dist_sweep.csv")
    assert list(csv.columns) == JAX_ROW_KEYS and len(csv) == 4
    assert (runs["root"] / "both" / "campaign_dist_sweep.png").stat().st_size > 0


def test_point_files_merge_into_one_summary(runs):
    both, merged = runs["both"], runs["merged"]
    assert merged["grid"] == both["grid"] == {"dist": [21, 105], "seeds": [40, 41]}
    for key in ("fixture", "protocol", "trend", "rows"):
        assert json.dumps(merged[key]) == json.dumps(both[key]), key   # NaN-aware
    assert [w["dist"] for w in merged["wall_clock"]["per_point"]] == [21, 105]
    with pytest.raises(ValueError, match="differ in protocol"):
        camp.main(["--dist", "21", "--seeds", "40", "41", "--epochs", "1",
                   "--samples_per_epoch", "32", "--device", "cpu",
                   "--out_dir", str(runs["root"] / "split")],
                  cfg=ViViTConfig(**VIVIT), fixture=SMALL)
