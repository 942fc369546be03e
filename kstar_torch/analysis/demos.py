"""The repository's two demos through the port.

    python -m kstar_torch.analysis.demos {vivit,multimodal,multimodal_aligned,
                                          multimodal_aligned_normal} [extra flags]

The port's twin of ``exp/demo_vivit.sh`` and ``exp/demo_multimodal.sh``:
each demo's argument list below is the shell script's, flag for flag (the
multimodal variants add the flags its header lists), and ``main`` hands it
to ``kstar_torch.cli.train_vision.main`` or ``train_multimodal.main``. The
run trains on the hard synthetic fixture, reloads the best checkpoint,
evaluates the test windows and sweeps the alarm population (17 disruptive +
16 normal shots) through the spatial-table kernel on the GPU.

The shell scripts write into ``./results`` and ``./weights``, where the
JAX package's artifacts of the same tags live. ``main`` appends
``--save_dir`` (default ``results/torch``) and ``--weight_dir`` (default
``weights/torch``) after the list, then the caller's extra flags, which
override as argparse does; a save or weight directory that resolves to
``./results`` or ``./weights`` themselves is refused. After the run it
prints the port's alarm summary beside the JAX file of the same tag
(``results/{tag}_alarms.json``), when there is one. The two are different
random streams and machines: the line reports both, it checks nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# exp/demo_vivit.sh
VIVIT = [
    "--model", "ViViT",
    "--synthetic", "--synthetic_difficulty", "1.0", "--synthetic_shots", "20",
    "--synthetic_normal", "4", "--synthetic_eval_disrupt", "13",
    "--synthetic_eval_normal", "12", "--synthetic_frames", "2520",
    "--synthetic_lead_s", "2.5", "4.0",
    "--seq_len", "21", "--dist", "315", "--alarm_dwell_s", "0.15",
    "--num_epoch", "26", "--batch_size", "32", "--use_sampling", "--steps_per_dispatch", "8",
    "--image_size", "64", "--dim", "64", "--depth", "2", "--n_heads", "4", "--d_head", "32",
    "--scale_dim", "4",
    "--tag", "demo_vivit", "--weight_dir", "./weights", "--save_dir", "./results",
]

# exp/demo_multimodal.sh
MULTIMODAL = [
    "--model_type", "concat", "--use_GB", "--gb_dynamic",
    "--synthetic", "--synthetic_difficulty", "1.0", "--synthetic_shots", "20",
    "--synthetic_normal", "4", "--synthetic_eval_disrupt", "13",
    "--synthetic_eval_normal", "12",
    "--synthetic_frames", "2520", "--synthetic_dt", "0.004761904761904762",
    "--synthetic_lead_s", "2.5", "4.0",
    "--seq_len", "21", "--tau", "4", "--dist", "315", "--alarm_dwell_s", "0.15",
    "--num_epoch", "16", "--batch_size", "32", "--use_sampling", "--steps_per_dispatch", "8",
    "--epoch_per_GB_estimate", "8", "--n_epochs_GB_estimate", "2",
    "--image_size", "64", "--dim", "64", "--depth", "2", "--n_heads", "4", "--d_head", "32",
    "--scale_dim", "4",
    "--feature_dims", "64", "--ts_layers", "2", "--ts_heads", "4", "--dim_feedforward", "256",
    "--tag", "demo_multimodal", "--weight_dir", "./weights", "--save_dir", "./results",
]

# name -> (the train CLI, its argument list); the multimodal variants are
# the ones exp/demo_multimodal.sh's header lists
DEMOS = {
    "vivit": ("train_vision", VIVIT),
    "multimodal": ("train_multimodal", MULTIMODAL),
    "multimodal_aligned": ("train_multimodal", MULTIMODAL + [
        "--pair_mode", "aligned", "--tag", "demo_multimodal_aligned"]),
    "multimodal_aligned_normal": ("train_multimodal", MULTIMODAL + [
        "--pair_mode", "aligned", "--train_with_normal", "--synthetic_normal", "12",
        "--tag", "demo_multimodal_aligned_normal"]),
}


def last_value(argv, flag: str):
    """The value argparse keeps for ``flag``: its last occurrence's."""
    at = [i for i, a in enumerate(argv) if a == flag]
    return argv[at[-1] + 1] if at else None


def demo_argv(name: str, extra_argv=(), save_dir: str = "results/torch",
              weight_dir: str = "weights/torch", device=None) -> list:
    """The full argument list of demo ``name``: the script's list, then
    ``--save_dir``/``--weight_dir`` (and ``--device``), then ``extra_argv``.
    SystemExit where the directories argparse would keep are the JAX
    package's own ``./results`` or ``./weights``."""
    if name not in DEMOS:
        raise SystemExit(f"unknown demo {name!r}; one of {sorted(DEMOS)}")
    argv = list(DEMOS[name][1]) + ["--save_dir", save_dir, "--weight_dir", weight_dir]
    if device is not None:
        argv += ["--device", str(device)]
    argv += list(extra_argv)
    for flag, jax_dir in (("--save_dir", "results"), ("--weight_dir", "weights")):
        if os.path.abspath(last_value(argv, flag)) in (os.path.abspath(jax_dir),
                                                       os.path.join(ROOT, jax_dir)):
            raise SystemExit(f"demos: {flag} {last_value(argv, flag)} is where the JAX "
                             f"package's demo artifacts live; pick another directory")
    return argv


def _summary(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(name: str, extra_argv=(), save_dir: str = "results/torch",
         weight_dir: str = "weights/torch", device=None) -> dict:
    """Run demo ``name`` through the port's train CLI. Returns
    ``{"tag", "results": the CLI's test results, "wall_s": the CLI's wall
    seconds (the fixture's generation included), "alarms": the port's alarm
    summary (None if the sweep wrote none), "jax_alarms": JAX's of the same
    tag or None}``."""
    import importlib

    argv = demo_argv(name, extra_argv, save_dir, weight_dir, device)
    cli = importlib.import_module(f"kstar_torch.cli.{DEMOS[name][0]}")
    t0 = time.perf_counter()
    results = cli.main(argv)
    tag = last_value(argv, "--tag")
    out = {"tag": tag, "results": results, "wall_s": time.perf_counter() - t0,
           "alarms": _summary(os.path.join(last_value(argv, "--save_dir"),
                                           f"{tag}_alarms.json")),
           "jax_alarms": _summary(os.path.join(ROOT, "results", f"{tag}_alarms.json"))}
    keys = ("detection_rate", "false_alarm_rate", "warning_p50_s", "n_disrupt", "n_normal")
    pick = lambda s: None if s is None else {k: s.get(k) for k in keys}
    print(json.dumps({"demo": name, "tag": tag, "wall_s": out["wall_s"],
                      "test_macro_f1": float(results["macro_f1"]), "port": pick(out["alarms"]),
                      "jax (results/)": pick(out["jax_alarms"])}), flush=True)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("name", choices=sorted(DEMOS))
    args, extra = p.parse_known_args()
    main(args.name, extra)
