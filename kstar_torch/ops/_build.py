"""Build and load the hand-written CUDA kernels under ``kstar_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/kstar_torch/<name>-<hash>.so``
at the repository root (git-ignored), and loaded with ``ctypes``. The hash
covers the source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Sources are compiled in
parallel, one ``nvcc`` each.

Nothing here runs at import time: the first kernel launch builds. Every C
entry point returns ``cudaGetLastError()`` after its launch, and
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kstar_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels of kstar_torch need "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    """Names of the kernel sources (``csrc/*.cu`` without the suffix)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names=None) -> dict:
    """Compile the named sources (all by default) that are not built yet,
    all at once; raise with the compiler's output if one fails. Returns
    ``{name: ptxas report}`` for the sources compiled by this call."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
        target.with_suffix(".ptxas").write_text(out)
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def build_variant(name: str, tag: str, extra_flags=(), source_text: str = None) -> Path:
    """Compile a throw-away variant of ``csrc/<name>.cu`` into
    ``build/kstar_torch/<name>-<tag>.so`` and return its path: the same
    flags plus ``extra_flags`` (a ``-D`` switch, say), from ``source_text``
    if given (an edited copy of the source) or else the source as it is.
    For measurement scripts; the package never loads a variant."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = CSRC / f"{name}.cu"
    if source_text is not None:
        source = BUILD_DIR / f"{name}-{tag}.cu"
        source.write_text(source_text)
    target = BUILD_DIR / f"{name}-{tag}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o", str(target), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({tag}):\n{proc.stdout}")
    return target


def ptxas_report(name: str) -> str:
    """The ptxas lines of the build of ``csrc/<name>.cu`` that ``load``
    takes (registers, stack, spills per kernel), built first if needed."""
    build([name])
    return _target(name).with_suffix(".ptxas").read_text()


def spills(report: str, entry: str) -> tuple:
    """(spill store bytes, spill load bytes) ptxas reports for the one
    kernel whose mangled name contains every string of ``entry``."""
    blocks = report.split("Compiling entry function")[1:]
    found = [b for b in blocks if all(part in b.split("\n")[0] for part in entry)]
    if len(found) != 1:
        raise ValueError(f"{len(found)} kernels match {entry}")
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", found[0])
    return int(m.group(1)), int(m.group(2))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.kstar_error_string.argtypes = [ctypes.c_int]
            lib.kstar_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu``'s library with its C signature set
    (``c_void_p`` for pointers and the stream); built and loaded on first
    use."""
    key = (name, symbol)
    with _lock:
        fn = _loaded.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, restype
        with _lock:
            _loaded[key] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` reported a CUDA error."""
    if err != 0:
        msg = load(name).kstar_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
