"""Fusion head: its share of its roofline. The bound is the least time the
H100 could compute the head of the chunks dispatched in the traced window
(``counts head_ops``: ``cls_fc1``'s and ``cls_fc2``'s operations at the
f32 peak of the CUDA cores, or their f32 weights read once a chunk and their
inputs and outputs at HBM bandwidth, the larger; ``core/peaks.py
bound_s``), over the device time of the head's kernels (%). The head runs
in f32 with TF32 off, so its products are FFMA on the CUDA cores, whose
peak (``FP32_OPS_PER_S``) is the roof, not the tensor cores' bf16 one; at
B 128 ``cls_fc1`` does ~64 operations a byte, above that roof's ridge
(~20), so the bound is the operations'.

The head's kernels (``head_kernel``): the f32 GEMM kernels launched in the
benchmark's ``sweep_table`` spans, known by name: cuBLAS's and CUTLASS's
f32 GEMMs (``sgemm``, ``gemm_f32f32``) and the split-K reductions and
GEMVs whose template types hold ``float`` and no narrower type. With TF32 off no f32 product runs on
the tensor cores (``nvjet`` is theirs); every other product of the window
runs in the compute dtype (bf16 or f16 in the kernel's name), K1 runs in
``embed_all``; the head's BatchNorm and ReLU passes are not counted."""

import re

F32_GEMM = re.compile(r"sgemm|gemm_f32f32|(splitKreduce|gemv|gemmSN)\w*<[^<]*\bfloat\b")
FP32_OPS_PER_S = 67e12    # H100 SXM, FP32 on the CUDA cores (NVIDIA H100 data sheet)
LOW = re.compile(r"bf16|bfloat16|f16|fp16|half|__nv_fp8|e4m3|e5m2|tf32|nvjet", re.I)


def head_kernel(name: str) -> bool:
    return bool(F32_GEMM.search(name)) and not LOW.search(name)


def read(run):
    if run.trace is None or not run.counters.get("chunks") or "batch" not in run.counters:
        return None
    s = run.trace.kernel_seconds(head_kernel, span="sweep_table")
    if s <= 0:
        return None
    bound = run.peaks.bound_s(*run.counts.head_ops(run.cfg, run.counters["chunks"],
                                                   run.counters["batch"]), FP32_OPS_PER_S)
    return 100.0 * bound / s
