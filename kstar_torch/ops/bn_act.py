"""A conv output's BatchNorm (evaluation), LeakyReLU and cast in one pass:
the CUDA kernel and its plain version.

No TPU counterpart: XLA fuses this chain of the JAX package's conv models
itself. Eager PyTorch runs R(2+1)D's ``Conv3dBN`` epilogue as six f32 passes
over every conv output, and the residual blocks' join as two more;
``bn_act`` does both in one bf16 pass (``csrc/bn_act.cu``) on a CUDA tensor.
``bn_act_reference`` is the plain version, and ``act_join`` the activation
and join that it and the models' eager chain (``models/common.py
bn_leaky_relu``) share.

Every operation rounds where the eager chain's own kernels round, so the
kernel and the plain version agree bit for bit.

Two counters: ``bn_act.fused`` counts epilogues the kernel ran (one a call),
``bn_act.eager`` those the models' eager chain ran.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import _build

# x, residual, out, mean, mul, bias, n, C, alpha, stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_void_p])


def act_join(y: torch.Tensor, act: Callable, out_dtype: torch.dtype,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What follows the BatchNorm: ``act(y)`` cast to ``out_dtype``; with
    ``residual``, then a residual block's join, ``act(residual + that)`` in
    ``out_dtype``."""
    out = act(y).to(out_dtype)
    return out if residual is None else act(residual + out).to(out_dtype)


def bn_act_reference(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                     bias: torch.Tensor, alpha: float, out_dtype: torch.dtype,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``LeakyReLU((x - mean) * mul + bias)`` in f32 over the
    last axis's channels, cast to ``out_dtype``; with ``residual``, then
    ``LeakyReLU(residual + that)`` in ``out_dtype``."""
    return act_join((x.float() - mean) * mul + bias, partial(F.leaky_relu, negative_slope=alpha),
                    out_dtype, residual)


def takes(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
          out_dtype: torch.dtype = torch.bfloat16, params=()) -> bool:
    """Whether the kernel computes this epilogue: bf16 in (``x`` and
    ``residual``) and out on a CUDA device, and no gradient to record, grad
    mode being off or none of them and of ``params`` requiring one. The
    layout (contiguous, 16-byte aligned, the residual of ``x``'s shape) is
    ``bn_act``'s to demand."""
    tensors = (x, *params) if residual is None else (x, residual, *params)
    return (out_dtype == torch.bfloat16 and x.device.type == "cuda"
            and x.dtype == torch.bfloat16
            and (residual is None or (residual.dtype == torch.bfloat16
                                      and residual.device == x.device))
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)))


def _fits(t: torch.Tensor) -> bool:
    return t.dim() >= 1 and t.is_contiguous() and t.data_ptr() % 16 == 0


def _launch(x, residual, out, vecs, alpha: float) -> None:
    fn = _build.function("bn_act", "bn_act_bf16", _ARGTYPES)
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
             *(v.data_ptr() for v in vecs), x.numel(), x.shape[-1], alpha,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("bn_act", err, "bn_act")


def bn_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
           alpha: float, out_dtype: torch.dtype,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of ``bn_act_reference`` in one kernel pass. ``mean``,
    ``mul`` and ``bias`` are the (C,) per-channel f32 vectors. Raises
    ``ValueError`` for what the kernel does not take (``takes``, and ``x``
    and ``residual`` contiguous, 16-byte aligned and of one shape): it
    records no gradient and has no CPU version."""
    if not (takes(x, residual, out_dtype, (mean, mul, bias)) and _fits(x)
            and x.shape[-1] < 1 << 31
            and (residual is None or (_fits(residual) and residual.shape == x.shape))):
        raise ValueError(
            f"bn_act: {tuple(x.shape)} {x.dtype} on {x.device} to {out_dtype} with residual "
            f"{None if residual is None else (tuple(residual.shape), residual.dtype)} not "
            f"supported by the CUDA kernel (bf16 in and out, contiguous, 16-byte aligned, "
            f"no gradient)")
    C = x.shape[-1]
    vecs = [t.to(device=x.device, dtype=torch.float32).contiguous()
            for t in (mean, mul, bias)]
    if any(v.shape != (C,) for v in vecs):
        raise ValueError(f"bn_act: mean, mul and bias must be ({C},)")
    out = torch.empty_like(x)
    if x.numel():
        _launch(x, residual, out, vecs, alpha)
    bn_act.fused += 1
    return out


bn_act.fused = 0
bn_act.eager = 0
