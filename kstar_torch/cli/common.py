"""Shared CLI plumbing: data-root resolution, config construction from args,
shot partitioning, and the synthetic-data fallback used for smoke runs
without KSTAR data.

Port of ``kstar_tpu/cli/common.py``.

``--dp N`` (the train CLIs) trains data-parallel over N ranks of
``torch.distributed``, the reference's ``mp.spawn`` + DDP
(src/distributed.py): ``start_dp`` spawns N processes with
``torch.multiprocessing`` (a ``file://`` rendezvous in a temporary
directory), each rank runs the CLI on ``cuda:<rank>`` (NCCL) or, with
``--device cpu``, on the CPU (gloo), and the parent returns rank 0's
result. Under a launcher (``torchrun``: ``RANK``/``WORLD_SIZE`` set), or in
a process that has already joined a group, the process is one rank itself.
``--dp N`` with fewer than N visible GPUs raises before any work: there is
no fallback to fewer ranks or to the CPU. ``make_dp_mesh`` and
``setup_dp`` keep JAX's names; JAX's ``make_raw_puts`` is
``train.loop.default_puts`` here, which ``fit`` applies itself.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import pandas as pd
import torch

from ..config import LossConfig, MeshConfig, OptimConfig, TrainConfig, tag_for
from ..data import VideoStore


def draw_figure(path: str, draw):
    """Run ``draw()``, a call of a figure function that writes ``path``,
    and close the figure it returns. Where matplotlib cannot be imported
    (the GPU machine has none), print one line naming ``path`` and go on:
    the model work and every report, CSV and JSON file do not depend on the
    figures. Touches no device, kernel or number."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"figure skipped: matplotlib is not installed ({path})")
        return None
    fig = draw()
    if hasattr(fig, "savefig"):
        import matplotlib.pyplot as plt
        plt.close(fig)
    return fig


def save_figure(fig, path: str):
    """Write a figure function's result to ``path`` (for ``draw_figure``)
    and return it."""
    fig.savefig(path)
    return fig


def check_dp(args) -> None:
    """SystemExit, before any work, where ``--dp N`` cannot run: N below 0,
    a batch the N ranks do not split, or fewer than N visible GPUs for a
    CUDA run (JAX's ``make_mesh`` assertion; no fallback)."""
    n = args.dp
    if not n:
        return
    if n < 0:
        raise SystemExit(f"--dp {n}: the rank count must be positive")
    if args.batch_size % n:
        raise SystemExit(f"--batch_size {args.batch_size} is not divisible by --dp {n}")
    if torch.device(args.device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise SystemExit(f"--dp {n} needs {n} CUDA devices, {have} visible; "
                             "pass --device cpu to run the ranks on the CPU (gloo)")


def join_dp(args) -> bool:
    """True where this process is already one rank of ``--dp``'s group (it
    joined one, or a launcher's environment makes it one now); False where
    the ranks are still to be started (``start_dp``)."""
    import torch.distributed as dist

    from ..parallel import init_multihost

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return False
        init_multihost(device=args.device)
    if dist.get_world_size() != args.dp:
        raise SystemExit(f"--dp {args.dp} in a group of {dist.get_world_size()} ranks")
    return True


def _dp_rank(rank: int, module: str, argv: list, world: int, store: str,
             device: str, out: str, threads: int) -> None:
    import importlib
    import pickle

    import torch.distributed as dist

    from ..parallel import init_multihost

    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)      # the CPU ranks share the caller's threads
    init_multihost(f"file://{store}", world, rank, device=device)
    try:
        result = importlib.import_module(module).main(argv)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def start_dp(module: str, argv, args):
    """Run ``module.main(argv)`` on ``--dp`` ranks, one spawned process each,
    and return rank 0's result. A rank that fails fails the run (and its
    collectives time out the others within ``parallel.multihost.TIMEOUT``)."""
    import pickle
    import sys
    import tempfile

    import torch.multiprocessing as mp

    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory(prefix="kstar-dp-") as tmp:
        out = os.path.join(tmp, "result.pkl")
        threads = max(1, torch.get_num_threads() // args.dp)
        mp.spawn(_dp_rank, args=(module, argv, args.dp, os.path.join(tmp, "store"),
                                 args.device, out, threads), nprocs=args.dp, join=True)
        with open(out, "rb") as f:
            return pickle.load(f)


def make_dp_mesh(args):
    """--dp N -> this rank's (data=N, model=1) mesh, or None."""
    if not getattr(args, "dp", 0):
        return None
    from ..parallel import make_mesh

    return make_mesh(MeshConfig(data=args.dp, model=1), device=args.device)


def setup_dp(args, state, mesh=None):
    """(state, mesh, put): with --dp N, the state replicated from rank 0
    over the mesh (the run's ``mesh``, else a new ``make_dp_mesh``) and
    ``put`` uploading this rank's rows; else (state, None, None)."""
    mesh = mesh or make_dp_mesh(args)
    if mesh is None:
        return state, None, None
    from ..parallel import replicate_state
    from ..train.loop import default_puts

    return replicate_state(state, mesh), mesh, default_puts(mesh.device, mesh)[0]


def best_member(seeds, hists, mesh=None):
    """(index into ``seeds``, its History) of the best valid F1 over the
    whole ensemble: on a mesh each data rank holds its block of members
    (``train.ensemble.local_seeds``) and the histories are all-gathered
    first. Rank 0 prints the table."""
    from ..parallel.comm import all_gather_objects

    if mesh is not None:
        parts = all_gather_objects(list(hists), mesh.data_group, mesh.shape["data"])
        hists = [h for part in parts for h in part]
    if mesh is None or mesh.is_main:
        best_i = report_ensemble(seeds, hists)
    else:
        best_i = int(np.argmax([h.best_f1 for h in hists]))
    return best_i, hists[best_i]


def ensemble_tag(tag: str, args) -> str:
    """The tag the members' ``{tag}_seed_{s}`` names extend: the CLI's tag
    without its own ``_seed_N`` suffix (an explicit ``--tag`` as given), as
    the JAX CLIs name the reference's per-seed sweep checkpoints."""
    return tag.rsplit("_seed_", 1)[0] if args.tag is None else tag


def report_ensemble(seeds, hists) -> int:
    """Print each seed's best valid F1 and the seed the CLI continues with
    (the argmax); returns its index."""
    for s, h in zip(seeds, hists):
        print(f"seed {s}: best valid f1 {h.best_f1:.4f} @ epoch {h.best_epoch + 1}")
    best_i = int(np.argmax([h.best_f1 for h in hists]))
    print(f"continuing with best seed {seeds[best_i]}")
    return best_i


def add_common_args(p: argparse.ArgumentParser, batch_size: int = 64) -> None:
    p.add_argument("--data_root", type=str, default="./dataset",
                   help="root with video/<shot>.npy, shot_list.csv, ts_data.csv")
    p.add_argument("--synthetic", action="store_true",
                   help="run on generated synthetic shots (smoke test)")
    p.add_argument("--synthetic_difficulty", type=float, default=0.0,
                   help="0 = trivially separable fixture; >0 adds gradual "
                        "seconds-scale precursors, distractor flashes and "
                        "noise (data/synthetic.py)")
    p.add_argument("--synthetic_shots", type=int, default=10)
    p.add_argument("--synthetic_normal", type=int, default=0,
                   help="additional NON-disruptive synthetic shots (ramp-"
                        "down, no quench): excluded from train/valid/test "
                        "windows, swept by the alarm metrics as the "
                        "false-alarm population (eval/alarms.py)")
    p.add_argument("--synthetic_frames", type=int, default=256)
    p.add_argument("--synthetic_eval_disrupt", type=int, default=0,
                   help="additional DISRUPTIVE synthetic shots marked "
                        "eval_only: held out of every train/valid/test "
                        "split, swept only by the alarm metrics")
    p.add_argument("--synthetic_eval_normal", type=int, default=0,
                   help="additional NON-disruptive eval_only shots: the "
                        "false-alarm analogue of --synthetic_eval_disrupt")
    p.add_argument("--synthetic_lead_s", type=float, nargs=2, default=None,
                   metavar=("MIN", "MAX"),
                   help="per-shot precursor lead window in seconds "
                        "(default 0.5 2.5)")
    p.add_argument("--train_with_normal", action="store_true",
                   help="include NON-disruptive shots in training as "
                        "negative-only windows (no reference counterpart): "
                        "normals are split train/valid/test like disruptive "
                        "shots, and ONLY the held-out test normals feed the "
                        "false-alarm metrics")
    p.add_argument("--alarm_dwell_s", type=float, default=0.0,
                   help="alarm dwell (hysteresis) in seconds: the alarm "
                        "trips only after the probability stays above "
                        "--threshold for this much continuous armed time "
                        "(0 = the reference first-crossing rule)")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--save_dir", type=str, default="./results")
    p.add_argument("--weight_dir", type=str, default="./weights")
    p.add_argument("--test_shot_num", type=int, default=21310)
    p.add_argument("--batch_size", type=int, default=batch_size)
    p.add_argument("--num_epoch", type=int, default=128)
    p.add_argument("--seq_len", type=int, default=21)
    p.add_argument("--dist", type=int, default=3)
    p.add_argument("--use_sampling", action="store_true")
    p.add_argument("--use_weighting", action="store_true")
    p.add_argument("--use_DRW", action="store_true")
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--loss_type", type=str, default="Focal",
                   choices=["CE", "Focal", "LDAM"])
    p.add_argument("--max_m", type=float, default=0.5)
    p.add_argument("--s", type=float, default=1.0)
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--optimizer", type=str, default="AdamW",
                   choices=["SGD", "RMSProp", "Adam", "AdamW"])
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--use_scheduler", action="store_true", default=True)
    p.add_argument("--no_scheduler", dest="use_scheduler", action="store_false")
    p.add_argument("--step_size", type=int, default=4)
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--early_stopping_patience", type=int, default=32)
    p.add_argument("--early_stopping_delta", type=float, default=1e-3)
    p.add_argument("--max_norm_grad", type=float, default=1.0)
    p.add_argument("--verbose", type=int, default=4)
    p.add_argument("--scaler", type=str, default="Robust",
                   choices=["Robust", "Standard", "MinMax"])
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="run K train steps per call over a stacked upload of "
                        "K batches (train/loop.py make_scan_steps; the same "
                        "trajectory as K single steps)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel over N ranks (0 = one process): N spawned "
                        "processes, one per GPU (NCCL), or on the CPU with "
                        "--device cpu (gloo); under torchrun, this process is "
                        "one rank; replaces the reference's DDP "
                        "(src/distributed.py)")
    p.add_argument("--resume", action="store_true",
                   help="resume exactly from <tag>_last.ckpt (full state: "
                        "params+optimizer+step+seed; the reference only "
                        "reloads weights, src/train.py:249-264)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the GPU; the tests "
                        "pass cpu)")


def configs_from_args(args) -> Tuple[TrainConfig, LossConfig, OptimConfig]:
    train_cfg = TrainConfig(
        batch_size=args.batch_size, num_epoch=args.num_epoch, seed=args.random_seed,
        use_sampling=args.use_sampling,
        early_stopping_patience=args.early_stopping_patience,
        early_stopping_delta=args.early_stopping_delta,
        verbose=args.verbose, save_dir=args.save_dir, weight_dir=args.weight_dir,
        compute_dtype=args.compute_dtype,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    loss_cfg = LossConfig(
        loss_type=args.loss_type, focal_gamma=args.focal_gamma,
        ldam_max_m=args.max_m, ldam_s=args.s,
        use_weighting=args.use_weighting, use_drw=args.use_DRW, drw_beta=args.beta,
    )
    optim_cfg = OptimConfig(
        optimizer=args.optimizer, lr=args.lr, use_scheduler=args.use_scheduler,
        step_size=args.step_size, gamma=args.gamma,
        max_norm_grad=args.max_norm_grad,
    )
    return train_cfg, loss_cfg, optim_cfg


def load_data(args, need_video: bool = False, dt: float = 4.0 / 210.0):
    """Load (disrupt_df, ts_df, store) from --data_root, or generate
    synthetic shots under --synthetic."""
    if args.synthetic:
        from ..data import synthetic

        lead = getattr(args, "synthetic_lead_s", None)
        shots, disrupt_df, ts_df = synthetic.make_dataset(
            n_shots=getattr(args, "synthetic_shots", 10),
            n_frames=getattr(args, "synthetic_frames", 256),
            height=64, width=64, dt=dt,
            seed=args.random_seed,
            difficulty=getattr(args, "synthetic_difficulty", 0.0),
            n_normal=getattr(args, "synthetic_normal", 0),
            n_eval_disrupt=getattr(args, "synthetic_eval_disrupt", 0),
            n_eval_normal=getattr(args, "synthetic_eval_normal", 0),
            precursor_lead_s=tuple(lead) if lead else (0.5, 2.5))
        store = VideoStore.from_arrays({s.shot: s.frames for s in shots})
        return disrupt_df, ts_df, store

    root = args.data_root

    def read_csv_compat(path):
        """Read either this framework's csvs or the reference's artifacts
        (KSTAR shot list is euc-kr encoded, reference utility.py:910)."""
        try:
            return pd.read_csv(path)
        except UnicodeDecodeError:
            return pd.read_csv(path, encoding="euc-kr")

    # accept the reference's file names as drop-in fallbacks
    shot_list_path = os.path.join(root, "shot_list.csv")
    if not os.path.exists(shot_list_path):
        alt = os.path.join(root, "KSTAR_Disruption_Shot_List_extend.csv")
        shot_list_path = alt if os.path.exists(alt) else shot_list_path
    disrupt_df = read_csv_compat(shot_list_path)

    ts_path = os.path.join(root, "ts_data.csv")
    if not os.path.exists(ts_path):
        for alt in ("KSTAR_Disruption_ts_data_extend.csv",
                    "KSTAR_Disruption_ts_data_5ms.csv"):
            cand = os.path.join(root, alt)
            if os.path.exists(cand):
                ts_path = cand
                break
    ts_df = read_csv_compat(ts_path) if os.path.exists(ts_path) else None
    store = None
    if need_video:
        vdir = os.path.join(root, "video")
        shots = [int(os.path.splitext(f)[0]) for f in os.listdir(vdir)
                 if f.endswith(".npy")] if os.path.isdir(vdir) else []
        store = VideoStore(vdir, shots)
    return disrupt_df, ts_df, store


def split_normal_shots(disrupt_df, shots):
    """Partition a shot list into (disruptive, normal) per the shot log's
    is_disrupt flag (or NaN tipminf). Normal shots stay out of the
    train/valid/test window splits — they would contribute zero windows —
    and are swept by the alarm metrics as the false-alarm population."""
    if "is_disrupt" in disrupt_df.columns:
        normal = set(disrupt_df.shot[~disrupt_df.is_disrupt.astype(bool)].tolist())
    else:
        normal = set(disrupt_df.shot[~np.isfinite(disrupt_df.tipminf)].tolist())
    return ([s for s in shots if s not in normal],
            [s for s in shots if s in normal])


def split_eval_only_shots(disrupt_df, shots):
    """Partition a shot list into (splittable, eval_only) per the shot log's
    eval_only flag (absent = all splittable). Eval-only shots never enter a
    train/valid/test window split; they exist purely to grow the alarm
    sweeps' detection/false-alarm populations."""
    if "eval_only" not in disrupt_df.columns:
        return list(shots), []
    ev = set(disrupt_df.shot[disrupt_df.eval_only.astype(bool)].tolist())
    return ([s for s in shots if s not in ev], [s for s in shots if s in ev])


def partition_shots(disrupt_df, shots):
    """One-stop split for the train/eval CLIs:
    ``(disrupt_splittable, normal_splittable, eval_disrupt, eval_normal)``.
    Eval-only shots (either class) are carved off FIRST so they can never
    leak into a train/valid/test split — including the normal-shot split
    under --train_with_normal."""
    core, ev = split_eval_only_shots(disrupt_df, shots)
    d, n = split_normal_shots(disrupt_df, core)
    ev_d, ev_n = split_normal_shots(disrupt_df, ev)
    return d, n, ev_d, ev_n


def make_tag(model: str, args, loss_cfg, train_cfg) -> str:
    return tag_for(model, args.seq_len, args.dist, loss_cfg, train_cfg,
                   use_sampling=args.use_sampling)


def write_alarm_artifacts(curves, threshold, save_dir, tag,
                          min_dwell_s: float = 0.0):
    """Score pre-swept shot curves and write ``{tag}_alarms.json``/``.csv``,
    ``{tag}_threshold_tradeoff.csv``, ``{tag}_dwell_tradeoff.csv`` and
    ``{tag}_operating_grid.csv`` (eval/alarms.py metric definitions)."""
    from ..eval import (dwell_tradeoff_from_curves, operating_grid_from_curves,
                        score_alarms, threshold_tradeoff_from_curves)

    res = score_alarms(curves, threshold, min_dwell_s=min_dwell_s)
    print(f"alarm summary: {res['summary']}")
    with open(os.path.join(save_dir, f"{tag}_alarms.json"), "w") as f:
        json.dump(res["summary"], f, indent=2)
    res["per_shot"].to_csv(
        os.path.join(save_dir, f"{tag}_alarms.csv"), index=False)

    # operational trade-off curves: detection / warning / premature rate vs
    # threshold (at the configured dwell) and vs dwell (at the configured
    # threshold) — the library is swept ONCE by the caller; the trade-offs
    # just rescore the held curves on the host
    tradeoff = threshold_tradeoff_from_curves(curves, min_dwell_s=min_dwell_s)
    tradeoff.to_csv(
        os.path.join(save_dir, f"{tag}_threshold_tradeoff.csv"), index=False)
    print(tradeoff.to_string(index=False))
    dwell = dwell_tradeoff_from_curves(curves, threshold=threshold)
    dwell.to_csv(
        os.path.join(save_dir, f"{tag}_dwell_tradeoff.csv"), index=False)
    print(dwell.to_string(index=False))

    grid = operating_grid_from_curves(curves)
    grid.to_csv(
        os.path.join(save_dir, f"{tag}_operating_grid.csv"), index=False)
    best = grid[(grid.detection_rate >= 1.0)
                & (grid.false_alarm_rate.fillna(0) <= 0.0)]
    if len(best):
        b = best.sort_values("warning_p50_s", ascending=False).iloc[0]
        print(f"operating points with detection 1.0 / FPR 0: {len(best)} "
              f"(best warning_p50 {b.warning_p50_s:.2f}s at threshold "
              f"{b.threshold}, dwell {b.min_dwell_s}s)")
    else:
        print("no operating point reaches detection 1.0 / FPR 0 "
              f"({tag}_operating_grid.csv records the full surface)")
    return res


def emit_alarm_artifacts(model, store, disrupt_df, sweep_shot_list,
                         seq_len, dist, crop, batch_size, dtype, threshold,
                         save_dir, tag, min_dwell_s: float = 0.0, device=None,
                         mesh=None):
    """Vision path: sweep whole shots (test + normal populations) with the
    batched engine (the spatial-table kernel on a GPU), then score + write
    via write_alarm_artifacts. Returns the swept curves for reuse. ``mesh``:
    the shots are split over its data ranks, every rank gets every curve,
    and rank 0 alone scores and writes."""
    from ..eval import sweep_prob_curves

    curves = sweep_prob_curves(
        model, store, disrupt_df, sweep_shot_list, seq_len=seq_len, dist=dist,
        crop_size=crop, batch_size=batch_size, compute_dtype=dtype,
        device=device, mesh=mesh)
    if mesh is None or mesh.is_main:
        write_alarm_artifacts(curves, threshold, save_dir, tag,
                              min_dwell_s=min_dwell_s)
    return curves


def resolve_normal_splits(args, normal_s, splitter):
    """--train_with_normal plumbing shared by the train CLIs: split the
    normal shots with the SAME splitter as the disruptive shots, and keep
    the false-alarm population disjoint from anything trained on.

    Returns (train_n, valid_n, test_n, sweep_normals, include_normal):
    without the flag every normal shot stays eval-only; with it, only the
    held-out test normals are swept."""
    if getattr(args, "train_with_normal", False) and normal_s:
        train_n, valid_n, test_n = splitter(normal_s)
        return train_n, valid_n, test_n, test_n, True
    return [], [], [], list(normal_s), False
