"""Shared fixtures of the benchmark's tests: the repository on ``sys.path``,
a copy of the benchmark directory with cells cut to a size the CPU runs in
seconds, and the card for the tests marked ``cuda``."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_LIBRARY = {"n_shots": 3, "min_frames": 40, "max_frames": 80, "frame_size": 64,
                "noise_std": 3.0, "disrupt_share": 0.5}
# each cell over three short 64 px shots, at the configurations' widths: the
# ViViT cells at 32 px, R(2+1)D at 64 px (at 32 px its deepest stage sees one
# position a frame, and its bf16 gaps are no longer those of the cell)
TINY = {
    "vivit-sweep-256px": dict(image_size=32, batch=8, check={"windows": 24, "block": 8}),
    "r2plus1d-sweep-128px": dict(image_size=64, batch=4, warmup_windows=8,
                                 calibration_windows=16, check={"windows": 12, "block": 4}),
    "vivit-train-128px": dict(image_size=32, batch=32, pool_batches=6, warmup_steps=3),
}


def tiny_bench(root: Path, extra: dict | None = None):
    """A copy of the benchmark under ``root`` whose cells ``tiny-<cell>`` are
    the cells cut to TINY, with manifest entries to match; ``extra`` adds
    workload files as they are given (name -> dict)."""
    from benchmark.core.spec import Bench

    bench_dir = root / "benchmark"
    shutil.copytree(REPO / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cut in TINY.items():
        cell = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
        cell.update(copy.deepcopy(cut), library=dict(TINY_LIBRARY))
        (bench_dir / "workloads" / f"tiny-{name}.json").write_text(json.dumps(cell))
        for metric in manifest["end_to_end"] + manifest["per_layer"]:
            if name in metric.get("workloads", []):
                metric["workloads"].append(f"tiny-{name}")
    for name, cell in (extra or {}).items():
        (bench_dir / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return Bench(bench_dir, manifest)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, not at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the GPU machine)")
    return torch.device("cuda", 0)
