"""TFN-GB on ``MultiModalSweeper``'s normal path: ``sweep_device`` against
the benchmark's plain reference, the sweep's spans and counters, the window
graph on the GPU, and the ``tfngb-sweep-128px`` cell cut to a CPU's size.

* on the CPU the sweep launches eagerly (``graphed`` 0, the counters 0) and
  matches ``benchmark/reference/tfngb.py`` on seeded random weights;
* on a GPU each chunk is one replay of the shared window graph, equal to
  the eager chunks to the bit in bf16 and f32, for TFN-GB and the concat
  model, following a weight changed in place and recapturing new storage;
* the cell runs through ``benchmark.run`` traced and untraced and is
  ``correct``, the fp8 control fails one of its limits, the bf16 control
  and a program whose head runs in bf16 fail the head's own limit, and the
  fusion head's readers pick the head's kernels by name.

    python -m pytest tests/test_torch_tfngb_sweep.py -q
    python3 -m pytest --noconftest -m cuda tests/test_torch_tfngb_sweep.py -q   # on the GPU machine
"""

import contextlib
import io
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kstar_torch.infer.continuous import (MultiModalSweeper, chunkify_starts, gather_windows,
                                          multimodal_ladders, table_rows, window_rows)
from kstar_torch.models import TFNGB, MultiModalConcat
from kstar_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
L, CROP, BATCH, F = 5, 32, 8, 18
VIVIT_KW = dict(image_size=CROP, patch_size=8, n_frames=L, dim=32, depth=1, n_heads=2,
                d_head=16, scale_dim=2, dropout=0.0, embedd_dropout=0.0)
TS_KW = dict(n_features=F, kernel_size=5, feature_dims=32, max_len=L, n_layers=1, n_heads=4,
             dim_feedforward=64, dropout=0.0, cls_dims=16, noise_std=0.0)
# 12, 30 and 70 paired windows: 2, 4 and 9 chunks of 8 in chunk buckets 2, 4
# and 10, each with a padded final chunk
WINDOWS = (12, 30, 70)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bench():
    from benchmark.core.spec import Bench

    return Bench()


def _tiny_cfg() -> dict:
    """The ``tfngb`` configuration at the test's widths."""
    cfg = _bench().config("tfngb")
    pc = cfg["program_config"]
    pc.update(n_frames=L)
    pc["vivit_kwargs"] = dict(VIVIT_KW)
    pc["ts_kwargs"] = dict(TS_KW)
    return cfg


def _weights(cfg, seed=3, device="cpu"):
    from benchmark.core import weights

    ref = _bench().reference("tfngb")
    return ref, weights.make(ref.param_spec(cfg, CROP), seed, torch.device(device))


def _shots(dev, windows=WINDOWS, seed=0):
    """(frames, rows, video ladder, 0D ladder) on ``dev`` per shot, the
    ladders ``multimodal_ladders`` keeps over the whole shot."""
    rng = np.random.default_rng(seed)
    out = []
    for n in windows:
        t = n + L + 2
        frames = torch.from_numpy(rng.integers(0, 256, (t, CROP, CROP, 3), dtype=np.uint8))
        rows = torch.from_numpy(rng.normal(size=(t, F)).astype(np.float32))
        times = np.arange(t) / 210.0
        vk, tk = multimodal_ladders(times, 0, t - 2, 0.0, float(times[-1]), L, 1 / 210.0, 1)
        assert len(vk) == n
        out.append((frames.to(dev), rows.to(dev), np.asarray(vk), np.asarray(tk)))
    return out


def _model(name="TFNGB", dtype=torch.float32, seed=0):
    cls = {"TFNGB": TFNGB, "concat": MultiModalConcat}[name]
    return cls(dict(VIVIT_KW), dict(TS_KW), dtype=dtype,
               generator=torch.Generator().manual_seed(seed))


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _n_chunks(shots):
    return sum(len(chunkify_starts(vk, BATCH)) for _, _, vk, _ in shots)


# ---------------------------------------------------------------------------
# CPU: the plain reference, the spans
# ---------------------------------------------------------------------------

def test_sweep_device_matches_the_plain_reference():
    """The port's f32 sweep (the plain spatial-cls table, the window loop)
    against the reference's whole windows from raw frames and rows, on the
    reference's random weights with both sides' BatchNorms calibrated on
    the same windows. atol 2e-5 in probability: the f32 sums run in
    another order (the table's and the batched windows' against one
    window at a time) and each side calibrates its own statistics."""
    from benchmark.core import program
    from benchmark.core.spec import load_module

    mm = load_module(REPO / "benchmark" / "drivers" / "multimodal_sweep.py", "test_mm_driver")
    cfg = dict(_tiny_cfg(), compute_dtype="float32")
    ref, w = _weights(cfg)
    model = mm.build_model(cfg, CROP, w, torch.device("cpu"))
    shots = _shots("cpu")
    frames, rows, vk, tk = shots[2]
    back = np.arange(L - 1, -1, -1)
    pick = np.arange(0, len(vk), 3)
    fidx = torch.as_tensor(vk[pick][:, None] + 1 - back)
    ridx = torch.as_tensor(tk[pick][:, None] - back)
    calib = (frames[fidx[:16]], rows[ridx[:16]])
    mm.calibrate_bn(model, program.normalise(calib[0], cfg), calib[1])
    sw = MultiModalSweeper(model, L, 1, CROP, BATCH, torch.float32, device="cpu")
    got = sw.sweep_device(frames, rows, vk, tk)
    want = ref.probs(w, frames, fidx, rows, ridx, cfg, "f32", 4, calib).numpy()
    assert got.shape == (len(vk),)
    np.testing.assert_allclose(got[pick], want, atol=2e-5, rtol=0)
    # the host entry uploads and goes through the same two halves
    np.testing.assert_array_equal(sw.sweep(frames.numpy(), rows.numpy(), vk, tk), got)


def test_cpu_sweep_is_eager_and_its_spans_add_up():
    """On the CPU: no capture, no replayed chunk, ``graphed`` 0 in every
    ``sweep.windows`` span; per shot the embed and table spans, one
    ``sweep.chunk`` a chunk under its ``sweep.windows``, whose attributes
    add up to the windows and chunks swept."""
    sw = MultiModalSweeper(_model(), L, 1, CROP, BATCH, torch.float32, device="cpu")
    shots = _shots("cpu")
    with profiling.recording() as rec:
        for frames, rows, vk, tk in shots:
            assert sw.sweep_device(frames, rows, vk, tk).shape == (len(vk),)
    assert sw.graph_captures == 0 and sw.graphed_chunks == 0
    for shot, (frames, _, vk, _) in enumerate(shots, start=1):
        mine = [r for r in rec if r.attrs.get("shot") == shot]
        chunks = chunkify_starts(vk, BATCH)
        assert [r.name for r in mine] == (["sweep.embed", "sweep.table"]
                                          + ["sweep.chunk"] * len(chunks) + ["sweep.windows"])
        assert mine[0].attrs == {"shot": shot, "frames": len(frames)}
        assert mine[1].attrs == {"shot": shot, "fused": sw.fused_table_active}
        assert mine[-1].attrs == {"shot": shot, "windows": len(vk), "dispatched": chunks.size,
                                  "chunks": len(chunks), "graphed": 0}
        assert all(r.parent == "sweep.windows" for r in mine if r.name == "sweep.chunk")
    windows = [r for r in rec if r.name == "sweep.windows"]
    assert sum(r.attrs["windows"] for r in windows) == sum(WINDOWS)
    assert sum(r.attrs["chunks"] for r in windows) == _n_chunks(shots)
    assert sum(1 for r in rec if r.name == "sweep.chunk") == _n_chunks(shots)


def test_window_rows_of_both_inputs_read_what_a_clamped_advanced_index_reads():
    """The one gather (``window_rows`` of the flattened table and of the 0D
    rows, read with one ``index_select`` each in the graphed loop and in
    ``chunk_probs``) reads the paired windows that a clamp and advanced
    indexing of the (L, T, D) table and the (R, F) rows read, the clamps at
    the tables' ends and the bucket padding included."""
    sw = MultiModalSweeper(_model(), L, 1, CROP, BATCH, torch.float32, device="cpu")
    T, R, D = 23, 21, 32
    video, rows = torch.randn(L, T, D), torch.randn(R, F)
    vk = np.arange(3, T + 2)                # the last windows run past both tables
    v, t = (torch.from_numpy(chunkify_starts(k, BATCH)) for k in (vk, vk - 1))
    v_rows, t_rows = window_rows(video, v, sw._offsets), window_rows(rows, t, sw._t_offsets)
    assert v_rows.shape == t_rows.shape == (len(v), BATCH * L)
    off = torch.arange(L)[None, :]
    for c in range(len(v)):
        vi = torch.clamp(v[c][:, None] + sw._offsets[None, :], 0, T - 1)
        ti = torch.clamp(t[c][:, None] + sw._t_offsets[None, :], 0, R - 1)
        want_v, want_t = video[off, vi], rows[ti]
        got_v = torch.index_select(table_rows(video), 0, v_rows[c]).view(BATCH, L, D)
        assert torch.equal(got_v, want_v)
        assert torch.equal(torch.index_select(table_rows(rows), 0, t_rows[c]).view(BATCH, L, F),
                           want_t)
        assert torch.equal(gather_windows(video, v[c], sw._offsets), want_v)
        assert torch.equal(gather_windows(rows, t[c], sw._t_offsets), want_t)
        assert torch.equal(sw.chunk_probs(video, rows, v[c], t[c]),
                           sw._window_probs(want_v, want_t))


def test_untraced_sweep_reads_no_clock(monkeypatch):
    def refuse():
        raise AssertionError("a span read the clock with recording off")

    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    sw = MultiModalSweeper(_model(), L, 1, CROP, BATCH, torch.float32, device="cpu")
    frames, rows, vk, tk = _shots("cpu", windows=(12,))[0]
    assert sw.sweep_device(frames, rows, vk, tk).shape == (12,)
    assert profiling.spans() == []


# ---------------------------------------------------------------------------
# the yardstick and the readers
# ---------------------------------------------------------------------------

def test_window_ops_from_the_shapes():
    """One window's whole forward as the reference computes it, counted from
    the shapes, equals what a flop counter reads from the reference; at the
    published widths a window is ~24 MFLOP of temporal stack, ~38 of 0D
    encoder and ~277 of head."""
    from torch.utils.flop_counter import FlopCounterMode

    bench = _bench()
    counts, full = bench.counts("tfngb"), bench.config("tfngb")
    cfg = _tiny_cfg()
    ref, w = _weights(cfg)
    stats = ref.calibrate(w, torch.randint(0, 255, (2, L, CROP, CROP, 3), dtype=torch.uint8),
                          torch.randn(2, L, F), cfg)
    with FlopCounterMode(display=False) as fc:
        ref.logits(w, stats, torch.randn(1, L, CROP, CROP, 3), torch.randn(1, L, F), cfg)
    assert counts.forward_ops(cfg, CROP) == fc.get_total_flops()
    assert counts.ts_ops(full) / 1e6 == pytest.approx(37.89, abs=0.01)
    head = counts.head_ops(full, 1, 1)[0]
    assert head / 1e6 == pytest.approx(276.94, abs=0.01)
    assert (counts.window_ops(full, 128, 1) - head - counts.ts_ops(full)) / 1e6 == \
        pytest.approx(24.06, abs=0.01)
    # a chunk's bound is its 554 MB of f32 weights and 17 MB of inputs and
    # outputs at HBM bandwidth
    from benchmark.core import peaks

    assert peaks.bound_s(*counts.head_ops(full, 1, 128)) * 1e3 == pytest.approx(0.1704, abs=1e-3)


# kernel names of an H100 traced run of the cell (torch 2.11, CUDA 12.8), and
# of other cuBLAS and CUTLASS builds
HEAD = ["sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_"
        "aligna4_alignc4_execute_kernel__5x_cublas",
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_"
        "aligna4_alignc4_execute_split_k_kernel__5x_cublas",
        "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, "
        "float, float, float, true, false, false, false>(cublasLt::cublasSplitKParams<float>)",
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_tn_align1>("
        "cutlass_80_simt_sgemm_64x64_8x5_tn_align1::Params)",
        "ampere_sgemm_128x64_tn",
        "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false>"]
NOT_HEAD = ["void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_tt_align1>("
            "cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_tt_align1::Params)",
            "nvjet_tst_64x64_64x13_2x4_h_bz_TNT", "nvjet_tst_128x128_64x6_2x1_v_bz_TNT",
            "void cutlass::Kernel2<cutlass_75_wmma_tensorop_bf16_s161616gemm_bf16_32x32_32x1_nn_"
            "align1>(cutlass_75_wmma_tensorop_bf16_s161616gemm_bf16_32x32_32x1_nn_align1::Params)",
            "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_64x64"
            "_64x5_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_64x64_64x5_nhwc_"
            "align8::Params)",
            "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x128x64_warpgroupsize1x1x1",
            "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, "
            "__nv_bfloat16, false, float, float, float, true, false, false, false>",
            "void (anonymous namespace)::fast::spatial_table_fast_kernel<(anonymous namespace)::"
            "fast::Shape<128, 64, 128, 2, 16, 80, 1> >((anonymous namespace)::fast::Params)",
            "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::"
            "MeanOps<float, float, float, float>, unsigned int, float, 4, 4> >"]


def test_the_head_kernels_are_the_f32_gemms():
    from benchmark.metrics import fusion_head_roofline as roof

    assert all(roof.head_kernel(n) for n in HEAD)
    assert not any(roof.head_kernel(n) for n in NOT_HEAD)


def _run(kernels, chunks=10, batch=128, window_ns=10_000_000):
    from benchmark.core import peaks
    from benchmark.core.trace import TraceData

    counts = _bench().counts("tfngb")
    trace = TraceData(kernels=kernels, window=(0, window_ns))
    return SimpleNamespace(trace=trace, host={}, counters={"chunks": chunks, "batch": batch},
                           cfg=_bench().config("tfngb"), counts=counts, peaks=peaks)


def test_fusion_head_readers():
    """The head's f32 GEMMs in ``sweep_table`` are read, the rest is not;
    the roofline is the bound over their time, the share their time over
    the window; nothing to read gives None."""
    from benchmark.metrics import fusion_head_roofline as roof
    from benchmark.metrics import fusion_head_window_share as share

    ms = 1_000_000
    kernels = [(0, 2 * ms, HEAD[0], "sweep_table"), (2 * ms, 3 * ms, HEAD[3], "sweep_table"),
               (3 * ms, 5 * ms, NOT_HEAD[0], "sweep_table"), (5 * ms, 6 * ms, HEAD[0], "embed_all")]
    run = _run(kernels)
    ops, nbytes = run.counts.head_ops(run.cfg, 10, 128)
    bound = ops / roof.FP32_OPS_PER_S           # above the f32 roof's ridge at B 128
    assert bound > nbytes / run.peaks.HBM_BYTES_PER_S
    assert roof.read(run) == pytest.approx(100.0 * bound / 3e-3)
    assert share.read(run) == pytest.approx(30.0)
    assert roof.read(_run(kernels[2:])) is None and share.read(_run(kernels[2:])) is None
    vivit = _run(kernels)
    del vivit.counters["batch"]                # a ViViT cell's counters
    assert roof.read(vivit) is None and share.read(vivit) is None


# ---------------------------------------------------------------------------
# the cell at a CPU's size
# ---------------------------------------------------------------------------

def _tiny_bench(root: Path):
    """A copy of the benchmark whose cell ``tiny-tfngb`` is
    ``tfngb-sweep-128px`` over three short shots at the test's widths."""
    from benchmark.core.spec import Bench

    bd = root / "benchmark"
    shutil.copytree(REPO / "benchmark", bd, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = _tiny_cfg()
    (bd / "configs" / "tiny-tfngb.json").write_text(json.dumps(cfg))
    for kind in ("counts", "reference"):
        shutil.copy(bd / kind / "tfngb.py", bd / kind / "tiny-tfngb.py")
    cell = json.loads((bd / "workloads" / "tfngb-sweep-128px.json").read_text())
    cell.update(config="tiny-tfngb", image_size=CROP, batch=BATCH, calibration_windows=16,
                check={"windows": 24, "block": 8},
                library={"n_shots": 3, "min_frames": 40, "max_frames": 80, "frame_size": 64,
                         "noise_std": 3.0, "disrupt_share": 0.5})
    (bd / "workloads" / "tiny-tfngb.json").write_text(json.dumps(cell))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        if "tfngb-sweep-128px" in e.get("workloads", []):
            e["workloads"].append("tiny-tfngb")
    return Bench(bd, manifest)


@pytest.fixture
def no_jax_check(monkeypatch):
    """This suite's conftest loads JAX for the package comparisons; the
    benchmark's own tests (``benchmark/tests``) hold its runs to having
    loaded none, so here the look for JAX is left out."""
    from benchmark import run

    monkeypatch.setattr(run, "jax_modules", lambda: [])


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(tmp_path, trace, no_jax_check):
    from benchmark import run

    bench = _tiny_bench(tmp_path)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "tiny-tfngb", "--seed", "2147483659", "--seconds", "0.5",
                       "--trace", str(trace)], bench=bench, device=torch.device("cpu"))
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0, \
        err.getvalue()
    kinds = "per_layer" if trace else "end_to_end"
    allowed = {e["name"] for e in bench.manifest[kinds]
               if "tfngb-sweep-128px" in e.get("workloads", [])}
    allowed |= {e["name"] for e in bench.manifest[kinds] if "workloads" not in e}
    assert set(res["metrics"]) <= allowed
    if trace:
        assert {"window_useful_share.sweep", "window_loop_dispatch_ms_per_chunk"} <= \
            set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"sweep_clips_per_s", "setup_s"}


def test_the_fp8_control_reads_not_correct(tmp_path):
    """The reference in fp8 in the program's place fails one of the cell's
    limits; the program, on the same seed, passes them all."""
    from benchmark import sweep_control

    bench = _tiny_bench(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sweep_control.main(["--workload", "tiny-tfngb", "--seeds", "13", "--control-seeds", "13",
                            "--seconds", "0.5"], bench=bench, device=torch.device("cpu"))
    program, ctl = (json.loads(x) for x in out.getvalue().strip().splitlines())
    limits = bench.workload("tiny-tfngb")["limits"]
    assert program["windows_compared"] == ctl["windows_compared"] > 0
    assert all(program[k] <= v for k, v in limits.items())
    assert any(ctl[k] > v for k, v in limits.items())


def _control(bench, *args) -> list:
    from benchmark import sweep_control

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sweep_control.main(["--workload", "tiny-tfngb", "--seconds", "0.5", *args], bench=bench,
                           device=torch.device("cpu"))
    return [json.loads(x) for x in out.getvalue().strip().splitlines()]


def test_the_bf16_control_fails_on_the_head(tmp_path):
    """The reference with bf16 operands in the program's place stays within
    the whole window's limits, which the bf16 encoders set, but its fusion
    head run alone on the f32 reference's features fails
    ``head_logit_gap_max``: the head's stated f32 is held; the program's
    f32 head, on the same seed, passes it."""
    bench = _tiny_bench(tmp_path)
    program, ctl = _control(bench, "--seeds", "13", "--control-seeds", "13",
                            "--control-prec", "bf16")
    limits = bench.workload("tiny-tfngb")["limits"]
    assert program["head_logit_gap_max"] <= limits["head_logit_gap_max"]
    assert ctl["head_logit_gap_max"] > limits["head_logit_gap_max"]
    assert ctl["logit_gap_max"] <= limits["logit_gap_max"]


def test_a_program_with_a_bf16_head_reads_not_correct(tmp_path, monkeypatch):
    """A program that runs ``cls_fc1`` with bf16 operands (the rest of the
    head as it is) fails ``head_logit_gap_max``."""
    import torch.nn.functional as F

    def bf16_head(self, fused, train):
        fc1 = self.cls_fc1
        h = F.linear(fused.bfloat16(), fc1.weight.bfloat16()).float() + fc1.bias
        return self.cls_fc2(F.relu(self.cls_bn(h, train)))

    monkeypatch.setattr(TFNGB, "_head", bf16_head)
    bench = _tiny_bench(tmp_path)
    (program,) = _control(bench, "--seeds", "13")
    limit = bench.workload("tiny-tfngb")["limits"]["head_logit_gap_max"]
    assert program["head_logit_gap_max"] > limit


def test_parent_without_sweep_device_fails_at_once(tmp_path, monkeypatch, no_jax_check):
    """A program whose ``MultiModalSweeper`` has no ``sweep_device`` (the
    port before it) makes the cell exit with an error at the start of
    set-up, before the library is made, and not hang or sweep another
    way."""
    from benchmark import run

    monkeypatch.delattr(MultiModalSweeper, "sweep_device")
    bench = _tiny_bench(tmp_path)
    with pytest.raises(SystemExit, match="sweep_device"), \
            contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        run.main(["--workload", "tiny-tfngb", "--seed", "1", "--seconds", "0.5"],
                 bench=bench, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# GPU
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _eager(sw, video, rows, vk, tk):
    """The chunks of the ladders through ``chunk_probs``, launched eagerly."""
    v = torch.from_numpy(chunkify_starts(vk, BATCH)).to(sw.device)
    t = torch.from_numpy(chunkify_starts(tk, BATCH)).to(sw.device)
    return torch.cat([sw.chunk_probs(video, rows, a, b)
                      for a, b in zip(v, t)]).cpu().numpy()[:len(vk)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["TFNGB", "concat"])
def test_graphed_sweep_matches_eager(dev, name, dtype):
    """Three shots in three chunk buckets, each ending in a padded chunk:
    one capture, then replays, and the probabilities of the eager path to
    the bit; every chunk replayed and counted in its span."""
    dt = DTYPES[dtype]
    sw = MultiModalSweeper(_model(name, dt), L, 1, CROP, BATCH, dt, device=dev)
    shots = _shots(dev)
    with profiling.recording() as rec:
        for frames, rows, vk, tk in shots:
            video = sw.embed_all(frames)
            got = sw.sweep_table(video, rows, vk, tk)
            np.testing.assert_array_equal(got, _eager(sw, video, rows, vk, tk))
    assert sw.graph_captures == 1
    assert sw.graphed_chunks == _n_chunks(shots)
    windows = [r for r in rec if r.name == "sweep.windows"]
    assert [w.attrs["graphed"] for w in windows] == [w.attrs["chunks"] for w in windows]


@pytest.mark.cuda
def test_graph_follows_a_weight_changed_in_place(dev):
    """A weight and a BatchNorm statistic updated in place between two
    sweeps are read by the next replay, without a second capture."""
    model = _model()
    sw = MultiModalSweeper(model, L, 1, CROP, BATCH, torch.float32, device=dev)
    frames, rows, vk, tk = _shots(dev, windows=(30,))[0]
    before = sw.sweep_device(frames, rows, vk, tk)
    with torch.no_grad():
        model.cls_fc2.bias.add_(torch.tensor([2.0, -2.0], device=dev))
        model.cls_bn.running_var.mul_(4.0)
    video = sw.embed_all(frames)
    after = sw.sweep_table(video, rows, vk, tk)
    np.testing.assert_array_equal(after, _eager(sw, video, rows, vk, tk))
    assert not np.array_equal(after, before)
    assert sw.graph_captures == 1


@pytest.mark.cuda
def test_new_parameter_storage_recaptures(dev):
    """A parameter given new storage is captured again, and the replays
    read it."""
    model = _model()
    sw = MultiModalSweeper(model, L, 1, CROP, BATCH, torch.float32, device=dev)
    frames, rows, vk, tk = _shots(dev, windows=(30,))[0]
    sw.sweep_device(frames, rows, vk, tk)
    model.cls_fc1.weight.data = model.cls_fc1.weight.data * 1.5
    video = sw.embed_all(frames)
    np.testing.assert_array_equal(sw.sweep_table(video, rows, vk, tk),
                                  _eager(sw, video, rows, vk, tk))
    assert sw.graph_captures == 2
    assert sw.graphed_chunks == 2 * len(chunkify_starts(vk, BATCH))
