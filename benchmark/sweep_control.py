"""The limits' readings (``control.py``'s) for a cell whose driver sweeps
under another name than ``sweep`` (``multimodal_sweep``): ``control.py``
takes every driver not named ``sweep`` for a train step's.

    python3 -m benchmark.sweep_control --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--control-prec fp8|bf16] [--seconds 3]

For each of ``--seeds`` the program's set-up and a short window at the
cell's load (the longest shot first), then its numbers against the f32
reference; for each of ``--control-seeds`` also the control: the reference
in ``--control-prec`` put in the program's place, on the same windows. One
JSON line per reading, on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark.core.spec import Bench
from benchmark.core.trace import Tracer
from benchmark.run import cache_env, make_context


def _reading(ctx, driver, seed, kind, seconds, prec_in_place=None):
    st = driver.setup(ctx)
    driver.window(ctx, st, seconds, longest_first=True)
    driver.free_program(st)
    r = driver.readings(ctx, st, prec_in_place)
    del st
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"seed": seed, "kind": kind, **r}


def main(argv=None, *, bench=None, device=None) -> int:
    """``bench`` and ``device`` replace the benchmark directory and the
    card, for tests on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-prec", default="fp8", choices=("fp8", "bf16"))
    args = ap.parse_args(argv)
    cache_env()
    if device is None:
        if not torch.cuda.is_available():
            print("sweep_control: needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    bench = bench or Bench()
    cell = bench.workload(args.workload)
    driver = bench.driver(cell["driver"])
    jobs = ([(s, "program", None) for s in args.seeds]
            + [(s, f"control_{args.control_prec}", args.control_prec)
               for s in args.control_seeds])
    for seed, kind, prec in jobs:
        ctx = make_context(bench, cell, seed, device, Tracer(False))
        print(json.dumps(_reading(ctx, driver, seed, kind, args.seconds, prec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
