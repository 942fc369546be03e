"""BENCHMARK.json and the files it names, found by name.

A cell is ``workloads/<cell>.json``; its configuration ``configs/<config>.json``;
its driver ``drivers/<driver>.py``; a per-layer metric ``metrics/<metric>.py``
(or ``metrics/<first part>.py``, shared by ``<first part>.<cells>``);
a configuration's operation counts ``counts/<config>.py`` and its plain
reference ``reference/<config>.py``. Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str):
    """Import a file by path under a private module name (file names may hold
    '-' and '.', which an import statement cannot)."""
    mod_name = f"_bench_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


class Bench:
    """The benchmark directory ``root`` and its manifest (BENCHMARK.json one
    level up, or the dict given)."""

    def __init__(self, root: Path = BENCH_DIR, manifest: dict | None = None):
        self.root = Path(root)
        if manifest is None:
            manifest = json.loads((self.root.parent / "BENCHMARK.json").read_text())
        self.manifest = manifest

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{name}.json"
        if not path.exists():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        cell = self._json("workloads", name)
        cell["name"] = name
        return cell

    def config(self, name: str) -> dict:
        cfg = self._json("configs", name)
        cfg["name"] = name
        return cfg

    def _module(self, kind: str, name: str):
        return load_module(self.root / kind / f"{name}.py", f"{kind}_{name}".replace("-", "_").replace(".", "_"))

    def driver(self, name: str):
        return self._module("drivers", name)

    def metric(self, name: str):
        """``metrics/<name>.py``, or else the reader that the metrics sharing
        the name's first part share (``device_idle_share.train`` reads with
        ``metrics/device_idle_share.py``)."""
        if not (self.root / "metrics" / f"{name}.py").exists():
            name = name.split(".")[0]
        return self._module("metrics", name)

    def counts(self, config: str):
        return self._module("counts", config)

    def reference(self, config: str):
        return self._module("reference", config)

    def metrics_for(self, cell: str, kind: str) -> list:
        """The manifest's ``end_to_end`` or ``per_layer`` entries that apply to
        ``cell``: those without a ``workloads`` key, and those that list it."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or cell in m["workloads"]]
