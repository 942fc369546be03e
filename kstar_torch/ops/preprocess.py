"""Sliding-window gather + normalise: the CUDA kernel and its plain version.

Port of ``kstar_tpu/ops/preprocess.py``. Streaming and the raw-pixel sweep
gather (B, L) frame windows from device-resident uint8 frames, subtract the
BGR channel mean and cast to the compute dtype. ``gather_normalize`` does
that in one pass (``csrc/preprocess.cu``) on a CUDA tensor, without the
gathered uint8 copy and the cast intermediate that index -> cast ->
subtract leave in memory; on a CPU tensor it runs the plain
``gather_normalize_reference``.

uint8 values, the integer channel means and their differences are exact in
bf16 and f32, so the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import PIXEL_MEAN_BGR
from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_FRAME_BYTES = 1 << 25     # the kernel walks a frame with blockIdx.y
# frames, starts, out, T, B, L, frame bytes, three channel means, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def supports_shape(h: int, w: int, c: int = 3) -> bool:
    """Whether the CUDA kernel takes (T, h, w, c) frames: three channels (the
    mean of a pixel byte is chosen by its flat index % 3) and a frame of at
    most ``MAX_FRAME_BYTES``. No alignment is asked for: a frame size or a
    pointer that the 16-byte vector path cannot take runs the kernel's
    one-byte-per-thread path."""
    return c == 3 and h > 0 and w > 0 and h * w * c <= MAX_FRAME_BYTES


def gather_normalize_reference(frames_u8: torch.Tensor, starts: torch.Tensor,
                               seq_len: int,
                               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: frames (T, H, W, C) uint8 + starts (B,) ->
    (B, L, H, W, C) normalised ``out_dtype``; window s covers frames
    [s+1, s+L], indices clipped to the shot."""
    offsets = torch.arange(1, seq_len + 1, device=frames_u8.device)
    idx = torch.clamp(starts.to(frames_u8.device)[:, None] + offsets[None, :],
                      0, frames_u8.shape[0] - 1)
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=frames_u8.device)
    return (frames_u8[idx].float() - mean).to(out_dtype)


def gather_normalize(frames_u8: torch.Tensor, starts: torch.Tensor, seq_len: int,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Window gather + normalise: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. Raises ``ValueError`` for what the kernel does
    not take (``supports_shape``, uint8 frames, integer starts, bf16 or f32
    output)."""
    if frames_u8.dim() != 4 or frames_u8.dtype != torch.uint8 or frames_u8.shape[0] == 0:
        raise ValueError(f"gather_normalize: frames must be a non-empty (T, H, W, C) "
                         f"uint8 tensor, got {tuple(frames_u8.shape)} {frames_u8.dtype}")
    if starts.dim() != 1 or starts.is_floating_point() or seq_len < 1:
        raise ValueError(f"gather_normalize: starts must be (B,) integers and seq_len "
                         f">= 1, got {tuple(starts.shape)} {starts.dtype}, {seq_len}")
    T, H, W, C = frames_u8.shape
    if C != len(PIXEL_MEAN_BGR):
        raise ValueError(f"gather_normalize: frames must have {len(PIXEL_MEAN_BGR)} "
                         f"channels (BGR), got {C}")
    if frames_u8.device.type == "cpu":
        return gather_normalize_reference(frames_u8, starts, seq_len, out_dtype)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"gather_normalize: unsupported device {frames_u8.device}")
    B = starts.shape[0]
    if (not supports_shape(H, W, C) or out_dtype not in _DTYPES
            or B * seq_len >= 1 << 31):
        raise ValueError(f"gather_normalize: frames {tuple(frames_u8.shape)}, {B} "
                         f"windows of {seq_len} to {out_dtype} not supported by the "
                         f"CUDA kernel (frames of at most {MAX_FRAME_BYTES} bytes, "
                         f"float32 or bfloat16 output)")
    out = torch.empty((B, seq_len, H, W, C), dtype=out_dtype, device=frames_u8.device)
    if B == 0:
        return out
    frames_u8 = frames_u8.contiguous()
    starts = starts.to(device=frames_u8.device, dtype=torch.int64).contiguous()
    fn = _build.function("preprocess", f"gather_normalize_{_DTYPES[out_dtype]}", _ARGTYPES)
    err = fn(frames_u8.data_ptr(), starts.data_ptr(), out.data_ptr(), T, B, seq_len,
             H * W * C, *map(float, PIXEL_MEAN_BGR),
             torch.cuda.current_stream(frames_u8.device).cuda_stream)
    _build.check("preprocess", err, "gather_normalize")
    gather_normalize.launches += 1
    # the C launcher's choice: 16-byte stores where sizes and pointers allow
    chunk = 16 // out.element_size()
    vector = ((H * W * C) % chunk == 0 and frames_u8.data_ptr() % chunk == 0
              and out.data_ptr() % 16 == 0)
    gather_normalize.instance = "vector" if vector else "scalar"
    return out


gather_normalize.launches = 0
gather_normalize.instance = None
