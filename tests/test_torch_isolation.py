"""kstar_torch and chip_smoke.py stand alone: no JAX, flax, optax, msgpack or
kstar_tpu import anywhere, every port module imports with those blocked,
and chip_smoke.py refuses to run without CUDA."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "msgpack", "kstar_tpu"}
PORT_FILES = sorted((ROOT / "kstar_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_imports(path):
    assert not _imported_roots(path) & BANNED


def _run(code_or_args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180, **kw)


def test_every_module_imports_with_jax_blocked():
    code = f"""
import sys
banned = {sorted(BANNED)!r}
for name in list(sys.modules):
    if name.split('.')[0] in banned:
        del sys.modules[name]
for name in banned:
    sys.modules[name] = None
import importlib, pkgutil, kstar_torch
mods = [m.name for m in pkgutil.walk_packages(kstar_torch.__path__, 'kstar_torch.')]
for name in mods:
    importlib.import_module(name)
import chip_smoke
print(len(mods))
"""
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "CUDA is not available" in out.stderr
