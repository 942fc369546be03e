"""Readings that the limits of a cell's compared numbers are set from, at
the cell's own size on the card (not run by the benchmark's runs).

    python3 -m benchmark.control --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--control-prec fp8|bf16] [--faults <name> ...] [--seconds 3]

For each of ``--seeds`` the program's set-up and a short window at the
cell's load (the longest shot first), then its numbers against the f32
reference; for each of ``--control-seeds`` also the control: the reference
in fp8 put in the program's place, on the same windows or steps; for each
fault of ``faults.py`` named, the program with that fault planted, on the
control seeds. One JSON line per reading, on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import faults
from benchmark.core.spec import Bench
from benchmark.core.trace import Tracer
from benchmark.run import cache_env, make_context


def _reading(ctx, driver, seed, kind, seconds, prec_in_place=None):
    st = driver.setup(ctx)
    if ctx.cell["driver"] == "sweep":
        driver.window(ctx, st, seconds, longest_first=True)
        driver.free_program(st)
        r = driver.readings(ctx, st, prec_in_place)
    else:
        got = driver.program_steps(st)
        driver.free_program(st)
        if prec_in_place is not None:
            ref = ctx.reference.train(st.weights, driver.compared_batches(st), ctx.cfg,
                                      ctx.cell, prec_in_place)
            got = {"logits1": ref["logits1"], "losses": ref["losses"],
                   "grads1": {k: v.double().cpu() for k, v in ref["grads1"].items()},
                   "params": {k: v.double().cpu() for k, v in ref["params"].items()}}
        r = driver.readings(ctx, st, got)
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
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-prec", default="fp8", choices=("fp8", "bf16"),
                    help="the reference's precision in the program's place: fp8 is the "
                         "control; bf16 is a witness of what the program's own precision reads")
    args = ap.parse_args(argv)
    cache_env()
    if device is None:
        if not torch.cuda.is_available():
            print("control: needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    bench = bench or Bench()
    cell = bench.workload(args.workload)
    driver = bench.driver(cell["driver"])
    jobs = ([(s, "program", None, None) for s in args.seeds]
            + [(s, f"control_{args.control_prec}", args.control_prec, None)
               for s in args.control_seeds]
            + [(s, f"fault_{f}", None, f) for f in args.faults for s in args.control_seeds])
    for seed, kind, prec, fault in jobs:
        ctx = make_context(bench, cell, seed, device, Tracer(False))
        if fault is None:
            out = _reading(ctx, driver, seed, kind, args.seconds, prec)
        else:
            with faults.FAULTS[fault]():
                out = _reading(ctx, driver, seed, kind, args.seconds)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
