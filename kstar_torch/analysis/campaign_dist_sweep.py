"""The horizon x seed campaign through the port: F1 and warning time against
the prediction horizon.

    python -m kstar_torch.analysis.campaign_dist_sweep [--smoke] [--dist d ...]
        [--device cpu] [--out_dir results/torch]

The port's twin of ``analysis/campaign_dist_sweep.py``, with its constants,
fixture and protocol: the hard synthetic fixture (seed 42; 12 + 4 core
shots, 14 + 13 eval-only, 1680 frames at 64 px, precursor leads of 1.0-3.5
s); per horizon ``dist`` (0.1-2.0 s at 210 fps) the four seeds 40-43 train
together as one ensemble (``train/ensemble.py``: the members step in turn
on shared batches), each member's best checkpoint gives its test macro-F1
and ROC-AUC (``run_eval_epoch`` + ``evaluate_probs``), and each member
sweeps the alarm population (test + eval-only + normal shots) through the
spatial-table kernel on the GPU (``sweep_prob_curves``), scored with
``score_alarms`` at threshold 0.5 and a 0.15 s dwell.

Where it differs from JAX's, each for a reason:

- it writes to ``results/torch/`` (``--out_dir``), not to JAX's ``results/``;
- its weight directory is a fresh temporary directory per horizon, removed
  afterwards, where JAX's is the fixed ``/tmp/campaign_w``: a stale
  ``{tag}_seed_{s}_best.ckpt`` of an earlier run would be reloaded as this
  run's best;
- ``--device`` (the GPU unless ``cpu``);
- ``--dist d ...`` runs part of the grid: each finished horizon's rows go
  to ``campaign_dist_sweep_d{dist}.json`` at once, and the summary JSON and
  CSV are rebuilt from every point file in ``--out_dir``, so the grid can
  run one horizon per command; ``--seeds``, ``--epochs`` and
  ``--samples_per_epoch`` cut a run for time (the point files record the
  protocol, and points of different protocols are not merged);
- the figure goes through ``cli/common.py draw_figure`` (a skip line where
  matplotlib is missing).

``--smoke`` keeps JAX's meaning: 2 epochs, the first 2 grid points. The
leads of 1.0-3.5 s against horizons up to 2.0 s leave some positive windows
with no precursor in them at dist 315 and 420; the run prints, per horizon,
how many swept disruptive shots have a lead no longer than the horizon.
``main(argv, cfg=..., fixture=...)`` runs the same small on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time
from typing import Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(ROOT, "results", "torch")

SEEDS = (40, 41, 42, 43)
DIST_GRID = (21, 105, 210, 315, 420)      # 0.1 .. 2.0 s at 210 fps
THRESHOLD, DWELL_S = 0.5, 0.15

# fixture: hard difficulty, 8 s shots, multi-second leads; 17 disruptive +
# 16 normal shots in the alarm population (test + eval_only)
N_SHOTS, N_NORMAL, N_EVAL_D, N_EVAL_N = 12, 4, 14, 13
N_FRAMES, LEAD_S = 1680, (1.0, 3.5)
SEQ_LEN, CROP, BATCH = 21, 64, 32
EPOCHS, SAMPLES_PER_EPOCH, STEPS_PER_DISPATCH = 10, 6144, 8
FPS = 210.0


def fixture_kwargs(**overrides) -> dict:
    """``data.synthetic.make_dataset``'s arguments for the campaign's
    fixture (JAX's ``build_fixture``), with ``overrides`` (a smaller
    fixture for the CPU)."""
    return {**dict(n_shots=N_SHOTS, n_frames=N_FRAMES, height=CROP, width=CROP,
                   seed=42, difficulty=1.0, n_normal=N_NORMAL, n_eval_disrupt=N_EVAL_D,
                   n_eval_normal=N_EVAL_N, precursor_lead_s=LEAD_S), **overrides}


def build_fixture(**overrides):
    """(store, disrupt_df, {shot: precursor lead in s}) of the fixture."""
    from ..data import VideoStore, synthetic

    shots, disrupt_df, _ = synthetic.make_dataset(**fixture_kwargs(**overrides))
    store = VideoStore.from_arrays({s.shot: s.frames for s in shots})
    return store, disrupt_df, {s.shot: s.lead_s for s in shots if s.is_disrupt}


def vivit_config(crop: int = CROP):
    """The campaign's ViViT (the demos' widths): 64 px, patch 16, dim 64,
    depth 2, 4 heads x 32, MLP 256."""
    from ..config import ViViTConfig

    return ViViTConfig(image_size=crop, patch_size=16, n_frames=SEQ_LEN, dim=64, depth=2,
                       n_heads=4, d_head=32, scale_dim=4)


def sweep_list(store, disrupt_df) -> list:
    """(train, valid, test shots, the swept shots: test + eval-only
    disruptive + normal + eval-only normal), as JAX's ``run_point``."""
    from ..cli.common import partition_shots
    from ..data import split_shots

    d_shots, n_shots, ev_d, ev_n = partition_shots(disrupt_df, sorted(store.arrays.keys()))
    train_s, valid_s, test_s = split_shots(d_shots, None)
    return train_s, valid_s, test_s, list(test_s) + ev_d + list(n_shots) + ev_n


def member_outputs(model, test_ds, store, disrupt_df, shots, dist: int, device,
                   crop: int = CROP, batch: int = BATCH):
    """One member's evaluation, JAX's sequence: the test windows through
    ``run_eval_epoch`` (weights 1, the test set's LDAM margins) -> ((N, 2)
    probabilities, labels), and ``sweep_prob_curves`` over ``shots`` in the
    model's compute dtype (batch 128) -> the curves."""
    from ..config import AugmentConfig
    from ..data import DevicePreprocessor
    from ..eval import sweep_prob_curves
    from ..losses import ldam_margins
    from ..train import make_eval_step, run_eval_epoch

    dtype = model.dtype
    loss_cfg = loss_config()
    put_eval = DevicePreprocessor(crop, AugmentConfig(), train=False, out_dtype=dtype,
                                  device=device)
    w = torch.ones(2, device=device)
    m = torch.as_tensor(ldam_margins(test_ds.class_counts(), loss_cfg.ldam_max_m)).to(device)
    _, _, _, (probs, labels) = run_eval_epoch(make_eval_step(loss_cfg), model, test_ds, batch,
                                              w, m, put=put_eval, collect_probs=True)
    curves = sweep_prob_curves(model, store, disrupt_df, shots, seq_len=SEQ_LEN, dist=dist,
                               crop_size=crop, batch_size=128, compute_dtype=dtype,
                               device=device)
    return probs, labels, curves


def loss_config():
    """JAX's: Focal loss with the class weights."""
    from ..config import LossConfig

    return LossConfig(loss_type="Focal", use_weighting=True)


def score_member(state, test_ds, store, disrupt_df, shots, dist: int, device,
                 best_f1: float = float("nan"), crop: int = CROP, batch: int = BATCH) -> dict:
    """One member's row of the campaign (JAX's keys and order), from its
    ``TrainState`` (the port's model carries its weights, so JAX's model and
    parameters are one argument here): test macro-F1 and ROC-AUC at
    ``THRESHOLD``, and the alarm summary at ``THRESHOLD`` / ``DWELL_S`` over
    the swept ``shots``. ``best_f1``: the member's best valid F1."""
    from ..eval import score_alarms
    from ..eval.evaluate import evaluate_probs

    probs, labels, curves = member_outputs(state.model, test_ds, store, disrupt_df, shots,
                                           dist, device, crop, batch)
    res = evaluate_probs(probs, labels, THRESHOLD)
    s = score_alarms(curves, THRESHOLD, min_dwell_s=DWELL_S)["summary"]
    return {
        "dist": dist, "horizon_s": dist / FPS, "seed": state.seed,
        "test_macro_f1": round(float(res["macro_f1"]), 4),
        "test_roc_auc": round(float(res["roc_auc"]), 4),
        "best_valid_f1": round(float(best_f1), 4),
        "detection_rate": s["detection_rate"],
        "false_alarm_rate": s["false_alarm_rate"],
        "warning_p50_s": s["warning_p50_s"],
        "warning_p90_s": s["warning_p90_s"],
        "n_disrupt": s["n_disrupt"], "n_normal": s["n_normal"],
    }


def protocol(epochs: int, samples: int, seeds) -> dict:
    return {"epochs": epochs, "batch": BATCH, "samples_per_epoch": samples,
            "threshold": THRESHOLD, "min_dwell_s": DWELL_S,
            "ensemble": f"{len(seeds)} seeds, members stepped in turn (train/ensemble.py)"}


def run_point(dist: int, store, disrupt_df, device, seeds=SEEDS, epochs: int = EPOCHS,
              samples: int = SAMPLES_PER_EPOCH, cfg=None, crop: int = CROP):
    """Train the seed ensemble at one horizon; per-seed test F1 and alarm
    metrics over the swept population. Returns (rows, train s, eval s)."""
    from ..config import AugmentConfig, OptimConfig, TrainConfig
    from ..data import ImbalancedSampler, VideoDataset, to_device
    from ..data.augment import make_pre_fns
    from ..models import build_video_model
    from ..train import create_ensemble_state, fit_ensemble, load_checkpoint, unstack_ensemble

    train_s, valid_s, test_s, shots = sweep_list(store, disrupt_df)
    mk = lambda ss: VideoDataset(store, disrupt_df, ss, seq_len=SEQ_LEN, dist=dist)
    train_ds, valid_ds, test_ds = mk(train_s), mk(valid_s), mk(test_s)

    cfg = cfg or vivit_config(crop)
    dtype = torch.bfloat16
    pre_train, pre_eval = make_pre_fns(crop, AugmentConfig(), out_dtype=dtype)
    steps = max(samples // BATCH, 1)
    states = create_ensemble_state(
        lambda gen: build_video_model("ViViT", cfg, dtype=dtype, generator=gen),
        seeds, OptimConfig(lr=2e-4), steps_per_epoch=steps, device=device)
    sampler = ImbalancedSampler(train_ds.labels, num_samples=samples)
    tag = f"campaign_d{dist}"
    with tempfile.TemporaryDirectory(prefix="campaign_w-") as weight_dir:
        train_cfg = TrainConfig(batch_size=BATCH, num_epoch=epochs, use_sampling=True,
                                verbose=0, weight_dir=weight_dir, save_dir=weight_dir,
                                steps_per_dispatch=STEPS_PER_DISPATCH, early_stopping=False)
        t0 = time.perf_counter()
        states, hists = fit_ensemble(states, seeds, train_ds, valid_ds, train_cfg,
                                     loss_config(), tag=tag, sampler=sampler,
                                     put=lambda bl: to_device(bl, states[0].device),
                                     pre_fn=pre_train, pre_fn_eval=pre_eval)
        t_train = time.perf_counter() - t0

        rows = []
        t0 = time.perf_counter()
        for i, seed in enumerate(seeds):
            st = unstack_ensemble(states, i)
            best = os.path.join(weight_dir, f"{tag}_seed_{seed}_best.ckpt")
            if os.path.exists(best):
                st = load_checkpoint(st, best)
            rows.append(score_member(st, test_ds, store, disrupt_df, shots, dist,
                                     st.device, hists[i].best_f1, crop))
            print(json.dumps(rows[-1]), flush=True)
        t_eval = time.perf_counter() - t0
    return rows, t_train, t_eval


def summarize(out_dir: str) -> dict:
    """The summary (JAX's schema: grid, fixture, protocol, wall_clock,
    trend, rows) of every point file in ``out_dir``, written as
    ``campaign_dist_sweep.json`` and ``.csv``; the figure through
    ``draw_figure``. Points of different fixtures or protocols raise."""
    import pandas as pd

    points = []
    for path in glob.glob(os.path.join(out_dir, "campaign_dist_sweep_d*.json")):
        with open(path) as f:
            points.append(json.load(f))
    if not points:
        raise FileNotFoundError(f"no campaign_dist_sweep_d*.json in {out_dir}")
    points.sort(key=lambda p: p["dist"])
    for key in ("fixture", "protocol", "seeds"):
        if any(p[key] != points[0][key] for p in points):
            raise ValueError(f"campaign point files in {out_dir} differ in {key}: "
                             f"{[p[key] for p in points]}")
    rows = [r for p in points for r in p["rows"]]
    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(out_dir, "campaign_dist_sweep.csv"), index=False)
    trend = df.groupby("dist").agg(
        f1_mean=("test_macro_f1", "mean"), f1_std=("test_macro_f1", "std"),
        det_mean=("detection_rate", "mean"),
        fpr_mean=("false_alarm_rate", "mean"),
        warn_p50_mean=("warning_p50_s", "mean")).reset_index()
    walls = [{"dist": p["dist"], "train_s": p["train_s"], "eval_s": p["eval_s"]}
             for p in points]
    summary = {
        "grid": {"dist": [p["dist"] for p in points], "seeds": points[0]["seeds"]},
        "fixture": points[0]["fixture"],
        "protocol": points[0]["protocol"],
        "wall_clock": {"total_s": round(sum(p["wall_s"] for p in points), 1),
                       "per_point": walls},
        "trend": trend.to_dict("records"),
        "rows": rows,
    }
    with open(os.path.join(out_dir, "campaign_dist_sweep.json"), "w") as f:
        json.dump(summary, f, indent=2)

    from ..cli.common import draw_figure

    png = os.path.join(out_dir, "campaign_dist_sweep.png")
    draw_figure(png, lambda: trend_figure(df, summary["wall_clock"]["total_s"], png))
    return summary


def trend_figure(df, wall_s: float, path: str):
    """Test macro-F1, warning p50 and detection / false-alarm rate against
    the horizon, per seed and their mean (JAX's figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    h = df.horizon_s
    for ax, col, label in [(axes[0], "test_macro_f1", "test macro-F1"),
                           (axes[1], "warning_p50_s", "warning p50 (s)"),
                           (axes[2], "detection_rate", "detection rate")]:
        ax.scatter(h, df[col], s=18, alpha=0.6, label="seeds 40-43")
        g = df.groupby("horizon_s")[col].mean()
        ax.plot(g.index, g.values, "-o", ms=4, label="mean")
        ax.set_xlabel("prediction horizon (s)")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    axes[2].scatter(h, df.false_alarm_rate, s=18, alpha=0.6, marker="x",
                    color="tab:red", label="false-alarm rate")
    axes[2].legend(fontsize=8)
    axes[0].legend(fontsize=8)
    fig.suptitle("ViViT campaign through the port: metric vs horizon "
                 f"(4-seed ensembles, wall {wall_s / 60:.1f} min)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return fig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs, 2 grid points (CI wiring check)")
    p.add_argument("--dist", type=int, nargs="+", default=None,
                   help="the horizons to run (default: the whole grid)")
    p.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    p.add_argument("--epochs", type=int, default=None,
                   help=f"default {EPOCHS} (2 with --smoke)")
    p.add_argument("--samples_per_epoch", type=int, default=SAMPLES_PER_EPOCH)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out_dir", type=str, default=RESULTS)
    return p


def main(argv=None, cfg=None, fixture: Optional[dict] = None) -> dict:
    """Run the grid (or ``--dist``'s part of it), write each horizon's point
    file, rebuild the summary from every point file in ``--out_dir`` and
    return it. ``cfg`` (a ``ViViTConfig``) and ``fixture`` (overrides of
    ``fixture_kwargs``) shrink the run for the CPU."""
    from .. import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    grid = args.dist or (DIST_GRID[:2] if args.smoke else DIST_GRID)
    epochs = args.epochs or (2 if args.smoke else EPOCHS)
    seeds = tuple(args.seeds)
    kw = fixture_kwargs(**(fixture or {}))
    crop = cfg.image_size if cfg is not None else CROP
    store, disrupt_df, leads = build_fixture(**(fixture or {}))
    print(f"fixture: {len(disrupt_df)} shots ({kw['n_shots']} train-split disruptive + "
          f"{kw['n_normal']} normal + {kw['n_eval_disrupt']}+{kw['n_eval_normal']} "
          f"eval-only), {kw['n_frames']} frames ({kw['n_frames'] / FPS:.0f} s), "
          f"leads {kw['precursor_lead_s']} s", flush=True)
    swept = sweep_list(store, disrupt_df)[3]
    swept_leads = [leads[s] for s in swept if s in leads]
    print(json.dumps({"swept_disruptive_shots": len(swept_leads),
                      "lead_s_at_most_horizon": {
                          str(d): sum(lead <= d / FPS for lead in swept_leads)
                          for d in DIST_GRID}}), flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    fixture_rec = {"n_shots": kw["n_shots"], "n_normal": kw["n_normal"],
                   "n_eval_disrupt": kw["n_eval_disrupt"],
                   "n_eval_normal": kw["n_eval_normal"], "n_frames": kw["n_frames"],
                   "lead_s": list(kw["precursor_lead_s"]), "difficulty": kw["difficulty"]}
    for dist in grid:
        print(f"=== horizon dist={dist} ({dist / FPS:.2f} s) x {len(seeds)} seeds ===",
              flush=True)
        t0 = time.perf_counter()
        rows, t_train, t_eval = run_point(dist, store, disrupt_df, device, seeds, epochs,
                                          args.samples_per_epoch, cfg, crop)
        point = {"dist": dist, "seeds": list(seeds), "fixture": fixture_rec,
                 "protocol": protocol(epochs, args.samples_per_epoch, seeds),
                 "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu",
                 "train_s": round(t_train, 1), "eval_s": round(t_eval, 1),
                 "wall_s": round(time.perf_counter() - t0, 1), "rows": rows}
        with open(os.path.join(args.out_dir, f"campaign_dist_sweep_d{dist}.json"), "w") as f:
            json.dump(point, f, indent=2)
    summary = summarize(args.out_dir)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}, indent=2))
    print(f"wrote {os.path.join(args.out_dir, 'campaign_dist_sweep.json')} "
          f"(points {summary['grid']['dist']}, {summary['wall_clock']['total_s'] / 60:.1f} "
          f"min of points)", flush=True)
    return summary


if __name__ == "__main__":
    main()
