"""Fused small-sequence attention: the CUDA kernel and its plain versions.

Port of ``kstar_tpu/ops/attention.py``. ViViT's factorized attention runs
over many short sequences (65 spatial tokens per frame, 22 temporal tokens
per clip). ``fused_attention`` runs QK^T -> f32 softmax -> AV for each
(b, h) row in one kernel (``csrc/attention.cu``) on a CUDA tensor, and the
plain ``fused_attention_reference`` on a CPU tensor. ``MHSA`` calls it when
built with ``use_pallas=True`` (models/vivit.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_D = 256
# q, k, v, out, rows (B*H), N, D, scale, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def reference_attention(q, k, v, scale: float):
    """The model's own attention: q, k, v (B, H, N, D) -> (B, H, N, D), the
    logits rounded to q's dtype before the f32 softmax (models/vivit.py)."""
    logits = (q @ k.transpose(-1, -2)).float() * scale
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return attn @ v


def fused_attention_reference(q, k, v, scale: float):
    """Plain version of the kernel: everything in f32, cast to q's dtype at
    the end (``_attn_kernel`` semantics)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def fused_attention(q, k, v, scale: float):
    """Fused attention for (B, H, N, D) inputs: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor. Raises ``ValueError`` for a
    shape or dtype the kernel does not take (D > 256)."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q, k, v must share one (B, H, N, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16, the same for q, k, v)")
    B, H, N, D = q.shape
    if D > MAX_D or N == 0 or B * H == 0:
        raise ValueError(f"fused_attention: shape {tuple(q.shape)} not supported "
                         f"(D <= {MAX_D}, N >= 1)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("fused_attention: q, k, v must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.function("attention", f"fused_attention_{_DTYPES[q.dtype]}", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("attention", err, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
