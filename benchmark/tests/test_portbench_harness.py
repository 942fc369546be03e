"""The benchmark on the CPU at tiny sizes: the manifest against its rules,
each cell through its driver on the plain paths, the yardstick's counts, the
references against the port and by hand, the planted faults, and no JAX.

    python -m pytest benchmark/tests -q            # the CPU tests
    python -m pytest benchmark/tests -q -m cuda    # on the GPU machine
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import re
import sys

import pytest
import torch

from conftest import REPO, TINY, tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = list(TINY)


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def run_cell(bench, name, trace=0, seed=2147483659, seconds=0.5):
    """``benchmark.run.main`` on the CPU: (exit code, result line, stderr)."""
    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], bench=bench, device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


# --- the manifest -------------------------------------------------------------

def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert m["paths"] == ["benchmark"] and len(m["command"]) <= 32
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.add(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in m[group]:
            assert set(e) - {"workloads"} == keys
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert 0.01 <= min(e["bound"] for e in e2e.values()) and e2e["setup_s"]["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["moves"] in e2e and e["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        if e["unit"] == "%" and "roofline" in e["name"]:
            assert e["name"].endswith("_roofline")
    every = [x for g in ("configs", "workloads", "end_to_end", "per_layer") for x in m[g]]
    assert len({x["name"] for x in every}) == len(every)
    lines = [x[k] for x in every for k in ("why", "layer") if k in x]
    lines += [c["source"] for c in m["configs"]] + m["command"]
    for x in every:
        assert NAME.match(x["name"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in lines)
    assert len(json.dumps(m)) <= 64 * 1024


def test_every_named_file_exists():
    m = manifest()
    root = REPO / "benchmark"
    for c in m["configs"]:
        assert (REPO / c["file"]).exists()
        assert (root / "counts" / f"{c['name']}.py").exists()
        assert (root / "reference" / f"{c['name']}.py").exists()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in m["workloads"]:
        cell = json.loads((root / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert (root / "drivers" / f"{cell['driver']}.py").exists()
    for e in m["per_layer"]:
        assert any((root / "metrics" / f"{n}.py").exists()
                   for n in (e["name"], e["name"].split(".")[0]))


def test_every_cell_reports_what_it_must():
    m = manifest()
    for w in m["workloads"]:
        e2e = [e for e in m["end_to_end"] if "workloads" not in e or w["name"] in e["workloads"]]
        per = [e for e in m["per_layer"] if "workloads" not in e or w["name"] in e["workloads"]]
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2 and per
        moves = {e["name"] for e in e2e}
        assert all(e["moves"] in moves for e in per)


# --- the yardstick --------------------------------------------------------------

def _counts(name):
    from benchmark.core.spec import Bench

    return Bench().counts(name), Bench().config(name)


def test_table_work_matches_the_kernel_tables_bound():
    """K1 at (21, 4096, 257, 128): 26.47 ms at the bf16 tensor peak (PERF.md's
    kernel table)."""
    from benchmark.core import peaks

    counts, cfg = _counts("vivit-flagship")
    ops, nbytes = counts.table_ops(cfg, 256, 4096)
    assert peaks.bound_s(ops, nbytes) * 1e3 == pytest.approx(26.47, abs=0.005)
    assert counts.table_ops(cfg, 128, 4096)[0] / peaks.BF16_TENSOR_OPS_PER_S * 1e3 == \
        pytest.approx(5.63, abs=0.005)


def test_r2plus1d_clip_ops_from_the_shapes():
    """22.75 GFLOP a 128 px clip, and at 32 px what a flop counter reads
    from the reference's own forward."""
    from torch.utils.flop_counter import FlopCounterMode

    counts, cfg = _counts("r2plus1d")
    assert counts.clip_ops(cfg, 128) / 1e9 == pytest.approx(22.748, abs=1e-3)
    ref, w = _reference("r2plus1d", 32)
    x = torch.randn(1, 21, 32, 32, 3)
    stats = ref.calibrate(w, torch.randint(0, 255, (2, 21, 32, 32, 3), dtype=torch.uint8), cfg)
    with FlopCounterMode(display=False) as fc:
        ref.logits(w, stats, x, cfg)
    assert counts.clip_ops(cfg, 32) == fc.get_total_flops()


def test_vivit_forward_ops_from_the_shapes():
    from torch.utils.flop_counter import FlopCounterMode

    counts, cfg = _counts("vivit-flagship")
    ref, w = _reference("vivit-flagship", 64)
    with FlopCounterMode(display=False) as fc:
        ref.logits(w, torch.randn(1, 21, 64, 64, 3), cfg)
    assert counts.forward_ops(cfg, 64) == fc.get_total_flops()
    # a sweep's windows are the temporal transformer and the head of one forward
    assert counts.window_ops(cfg, 64, 1) < counts.forward_ops(cfg, 64)


# --- the references ----------------------------------------------------------------

def _reference(name, image_size, seed=3):
    from benchmark.core import weights
    from benchmark.core.spec import Bench

    bench = Bench()
    ref, cfg = bench.reference(name), bench.config(name)
    return ref, weights.make(ref.param_spec(cfg, image_size), seed, torch.device("cpu"))


@pytest.mark.parametrize("name,image_size", [("vivit-flagship", 32), ("r2plus1d", 32)])
def test_reference_names_every_leaf_of_the_port(name, image_size):
    from benchmark.core import program
    from benchmark.core.spec import Bench

    ref, w = _reference(name, image_size)
    cfg = Bench().config(name)
    model = program.build_model(cfg, image_size, w, torch.device("cpu"))
    sd = model.state_dict()
    assert set(sd) == set(w) and all(sd[k].shape == w[k].shape for k in w)


@pytest.mark.parametrize("name", ["vivit-flagship", "r2plus1d"])
def test_reference_matches_the_ports_f32_forward(name):
    """Same weights and clips, both in f32 on the CPU: the reference's
    probabilities and the port's f32 model's agree to rounding."""
    from benchmark.core import program
    from benchmark.core.spec import Bench

    ref, w = _reference(name, 32)
    cfg = dict(Bench().config(name), compute_dtype="float32")
    model = program.build_model(cfg, 32, w, torch.device("cpu")).eval()
    frames = torch.randint(0, 255, (60, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    idx = torch.arange(21)[None, :] + torch.tensor([0, 7, 30])[:, None]
    calib = frames[idx[:2]]
    if cfg.get("calibrate_bn"):
        program.calibrate_bn(model, program.normalise(calib, cfg))
    with torch.no_grad():
        want = torch.softmax(model(program.normalise(frames[idx], cfg)).float(), -1)[:, 0]
    got = ref.probs(w, frames, idx, cfg, "f32", 2, calib)
    assert torch.allclose(got, want, atol=2e-5), (got - want).abs().max()


def test_focal_and_adamw_by_hand():
    from benchmark.reference import _plain as P

    logits = torch.tensor([[2.0, 0.0]])
    ce = math.log(1 + math.exp(-2.0))
    assert P.focal_loss(logits, torch.tensor([0]), 2.0).item() == pytest.approx(
        (1 - math.exp(-ce)) ** 2 * ce, rel=1e-5)     # f32 arithmetic
    adam = P.AdamW(lr=0.1, max_norm=1.0, transition=1, gamma=0.5)
    p, g = {"w": torch.tensor([1.0, -2.0])}, {"w": torch.tensor([3.0, 4.0])}
    clipped = adam.step(p, g)                       # |g| = 5: clipped to 1
    assert torch.allclose(clipped["w"], torch.tensor([0.6, 0.8]))
    # first step: mu_hat = g, nu_hat = g^2, so u = sign(g) + 1e-4 w
    assert torch.allclose(p["w"], torch.tensor([1.0 - 0.1 * (1 + 1e-4), -2.0 - 0.1 * (1 - 2e-4)]),
                          atol=1e-6)
    adam.step(p, g)                                 # the rate halves after one update
    assert adam.count == 2


def test_fp8_operand_rounds_and_passes_the_gradient():
    from benchmark.reference import _plain as P

    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = P.fp8(x)
    assert 0 < (q - x).abs().max() < 0.07 * 3
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


# --- the cells on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tmp_path, cell, trace):
    bench = tiny_bench(tmp_path)
    rc, res, err = run_cell(bench, f"tiny-{cell}", trace)
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0, err
    assert list(res)[-1] == "checks" and all(f"check {k} " in err for k in res["checks"])
    m = manifest()
    kinds = "per_layer" if trace else "end_to_end"
    allowed = {e["name"] for e in m[kinds] if "workloads" not in e or cell in e["workloads"]}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    else:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


def test_same_seed_same_inputs():
    from benchmark.core import library

    a = library.make(dict(conftest_library()), 2 ** 31 + 5, torch.device("cpu"), crop=32)
    b = library.make(dict(conftest_library()), 2 ** 31 + 5, torch.device("cpu"), crop=32)
    c = library.make(dict(conftest_library()), 2 ** 31 + 6, torch.device("cpu"), crop=32)
    assert torch.equal(a.frames, b.frames) and not torch.equal(a.frames, c.frames)
    # every seed the same work: the same lengths, arriving in the same pattern
    first = lambda lib: [int(lib.lengths[i]) for i, _ in zip(library.order(lib), range(7))]
    assert first(a) == first(c) and list(a.lengths) != list(c.lengths)


def conftest_library():
    from conftest import TINY_LIBRARY

    return TINY_LIBRARY


def test_a_cell_added_as_a_file_runs(tmp_path):
    """A new cell is one workload file and its manifest entries: no file of
    the benchmark is edited."""
    cell = json.loads((REPO / "benchmark" / "workloads" / "vivit-sweep-256px.json").read_text())
    cell.update(TINY["vivit-sweep-256px"], image_size=64, why="a new cell")
    bench = tiny_bench(tmp_path, {"new-vivit-sweep-64px": dict(cell, library=conftest_library())})
    for e in bench.manifest["end_to_end"] + bench.manifest["per_layer"]:
        if "vivit-sweep-256px" in e.get("workloads", []):
            e["workloads"].append("new-vivit-sweep-64px")
    rc, res, err = run_cell(bench, "new-vivit-sweep-64px", trace=1)
    assert rc == 0 and res["correct"], err
    assert "sweep_mfu" in res["metrics"]


# --- faults and the control -------------------------------------------------------------

@pytest.mark.parametrize("cell,fault", [("vivit-sweep-256px", "answer_altered"),
                                        ("r2plus1d-sweep-128px", "answer_altered"),
                                        ("vivit-train-128px", "state_unchanged"),
                                        ("vivit-train-128px", "half_batch")])
def test_a_planted_fault_reads_not_correct(tmp_path, cell, fault):
    from benchmark import faults

    bench = tiny_bench(tmp_path)
    with faults.FAULTS[fault]():
        rc, res, err = run_cell(bench, f"tiny-{cell}")
    assert rc == 0 and res["correct"] is False, err


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_reads_not_correct(tmp_path, cell):
    """The reference in fp8 in the program's place fails one of the cell's
    limits; the program, on the same seed, passes them all."""
    from benchmark import control

    bench = tiny_bench(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        control.main(["--workload", f"tiny-{cell}", "--seeds", "13", "--control-seeds", "13",
                      "--seconds", "0.5"], bench=bench, device=torch.device("cpu"))
    program, ctl = (json.loads(x) for x in out.getvalue().strip().splitlines())
    limits = bench.workload(f"tiny-{cell}")["limits"]
    assert all(program[k] <= v for k, v in limits.items())
    assert any(ctl[k] > v for k, v in limits.items())


# --- no JAX -----------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_in_the_benchmark_and_no_program_in_the_reference():
    from benchmark.run import JAX_MODULES

    for path in (REPO / "benchmark").rglob("*.py"):
        assert not set(_imports(path)) & set(JAX_MODULES), path
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert "kstar_torch" not in set(_imports(path)), path


def test_no_jax_module_after_a_run(tmp_path):
    from benchmark.run import jax_modules

    before = set(sys.modules)
    rc, res, _ = run_cell(tiny_bench(tmp_path), "tiny-vivit-train-128px")
    loaded = {m.split(".")[0] for m in set(sys.modules) - before}
    assert rc == 0 and not loaded & {"jax", "jaxlib", "flax", "optax", "kstar_tpu"}
    assert jax_modules() == [] or "jax" in {m.split(".")[0] for m in before}


def test_a_reader_that_loads_jax_withholds_the_result(tmp_path, monkeypatch):
    """The look for JAX comes after the per-layer readers: one that imports
    a module named ``jax`` leaves the run with no result."""
    from benchmark.run import JAX_MODULES

    for m in [m for m in sys.modules if m.split(".")[0] in JAX_MODULES]:
        monkeypatch.delitem(sys.modules, m)
    fake = tmp_path / "fake" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "fake"))
    bench = tiny_bench(tmp_path)
    (bench.root / "metrics" / "train_mfu.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    try:
        rc, res, err = run_cell(bench, "tiny-vivit-train-128px", trace=1)
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0 and res is None and "['jax']" in err


def test_the_difference_sees_a_leaf_pointing_the_wrong_way():
    """A leaf of the right size but the wrong sign passes the gap of norms
    and fails the norm of the difference."""
    from benchmark.core.spec import Bench

    train = Bench().driver("train")
    want = {"a": torch.ones(4, dtype=torch.float64), "b": torch.full((4,), 2.0, dtype=torch.float64)}
    got = {"a": -want["a"], "b": want["b"].clone()}
    assert train._leaf_gaps(got, want, ["a", "b"]).max() == 0
    assert train._leaf_gaps(got, want, ["a", "b"], diff=True).max() == pytest.approx(4 / 3)


def test_run_refuses_without_a_card(monkeypatch):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "vivit-sweep-256px", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


# --- on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    """Each cell as committed, for a few seconds, on the H100."""
    from benchmark import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds", "3"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["device"]["platform"] == "gpu"
