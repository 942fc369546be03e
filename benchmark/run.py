"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds kstar_torch. Set-up (imports, the
kernels' build or load, the library and weights made on the device from the
seed, the model, a warm-up on the cell's shapes) is timed as ``setup_s``;
then the cell's driver runs its closed loop for ``--seconds``. With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under the profiler and the result holds the
per-layer metrics, read from the trace by ``metrics/<name>.py``. Either way
the outputs of the timed path are then compared with the plain reference,
and each number compared is printed beside its limit on standard error and
under ``checks``, the result's last key.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "kstar_tpu")
CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "bench_cache"


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernel builds already go to build/kstar_torch there), and the
    run's environment: no flax behind any library, one OpenMP thread."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"     # one host thread for the program's CPU work


@dataclass
class Context:
    bench: object
    cell: dict
    cfg: dict
    seed: int
    device: object
    tracer: object
    reference: object
    counts: object
    seq_len: int


def make_context(bench, cell: dict, seed: int, device, tracer) -> Context:
    cfg = bench.config(cell["config"])
    return Context(bench=bench, cell=cell, cfg=cfg, seed=seed, device=device, tracer=tracer,
                   reference=bench.reference(cell["config"]), counts=bench.counts(cell["config"]),
                   seq_len=cfg["program_config"]["n_frames"])


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def jax_modules() -> list:
    """Modules loaded in this process whose top-level name is the JAX
    package's or one of JAX's own."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_MODULES))


def device_info(torch, device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def per_layer(ctx, rec: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something to
    read for."""
    from benchmark.core import peaks

    run = Reading(trace=ctx.tracer.data, host=ctx.tracer.host, counters=rec["counters"],
                  cfg=ctx.cfg, counts=ctx.counts, peaks=peaks)
    out = {}
    for m in ctx.bench.metrics_for(ctx.cell["name"], "per_layer"):
        value = ctx.bench.metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


@dataclass
class Reading:
    """What a per-layer reader reads: the trace, the host spans, the
    driver's counters, and the yardstick (counts, peaks)."""
    trace: object
    host: dict
    counters: dict
    cfg: dict
    counts: object
    peaks: object


def main(argv=None, *, bench=None, device=None) -> int:
    """Run the cell. ``bench`` (a ``core.spec.Bench``) and ``device`` replace
    the benchmark directory and the card, for tests on the CPU."""
    args = parse(argv)
    cache_env()
    import numpy as np
    import torch

    from benchmark.core.spec import Bench
    from benchmark.core.trace import WINDOW, Tracer

    bench = bench or Bench()
    cell = bench.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    ctx = make_context(bench, cell, args.seed, device, Tracer(bool(args.trace)))
    driver = bench.driver(cell["driver"])
    if device.type == "cuda":
        torch.zeros(1, device=device)          # the CUDA context, before the peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - PROCESS_START

    seconds = args.seconds
    if args.trace:
        seconds = min(seconds, cell["trace_seconds"])
    with ctx.tracer.profiling(), ctx.tracer.span(WINDOW):
        rec = driver.window(ctx, state, seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    readings = driver.check(ctx, state, rec)
    checks = {k: (readings[k], lim) for k, lim in cell["limits"].items()}
    if "route_launches" in rec and device.type == "cuda":
        got, expected = rec["route_launches"]
        checks["route_launches_missing"] = (float(expected - got), 0.0)
    correct = (rec["failed"] == 0 and all(np.isfinite(v) and v <= lim
                                          for v, lim in checks.values()))
    if args.trace:
        metrics = per_layer(ctx, rec)
    else:
        units = {m["name"]: m["unit"] for m in bench.manifest["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in rec["end_to_end"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    dev = device_info(torch, device, peak)
    result = {"correct": bool(correct), "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": dev}
    if args.trace:
        data = ctx.tracer.data
        dev["busy_s"], dev["window_s"] = data.busy_s, data.window_s
        result["breakdown"] = data.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    # last, once every reader has run: what any of them loaded counts too
    loaded = jax_modules()
    if loaded:
        print(f"benchmark: JAX modules loaded in the measuring process: {loaded}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
