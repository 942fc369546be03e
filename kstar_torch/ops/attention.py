"""Fused small-sequence attention: the CUDA kernel and its plain versions.

Port of ``kstar_tpu/ops/attention.py``. ViViT's factorized attention runs
over many short sequences (65 spatial tokens per frame, 22 temporal tokens
per clip). ``fused_attention`` runs QK^T -> f32 softmax -> AV for each
(b, h) row in one kernel (``csrc/attention.cu``) on a CUDA tensor, and the
plain ``fused_attention_reference`` on a CPU tensor. ``MHSA`` calls it when
built with ``use_pallas=True`` (models/vivit.py).

The source holds three hand-written instances, chosen by its C launcher:
two tensor-core ones for D in {16, 32, 64, 128} and 16-byte-aligned tensors
(bf16, ``mma_keys<block>``; f32 in split TF32 up to 80 keys,
``tf32x3_keys<block>``) and a scalar one for everything else;
``fused_attention.instance`` names the one the last launch took.
``strip_attention_emulation`` repeats the tensor-core instances'
arithmetic in plain PyTorch (``tf32_round`` and ``split_tf32_matmul`` the
f32 one's products), so that their tolerances can be checked without a
GPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_D = 256
KEY_BLOCKS = (32, 80, 128)      # the tensor-core instance's compiled key blocks
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("fused_attention: the kernel has no backward; call it "
                           "under torch.no_grad() (train with use_pallas=False)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.function("attention", f"fused_attention_{_DTYPES[q.dtype]}", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("attention", err, "fused_attention")
    fused_attention.launches += 1
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    block = _build.function("attention", "fused_attention_plan", [ctypes.c_int] * 4)(
        N, D, q.element_size(), int(aligned))
    kind = "mma" if q.dtype == torch.bfloat16 else "tf32x3"
    fused_attention.instance = f"{kind}_keys{block}" if block else "scalar"
    return out


fused_attention.launches = 0
fused_attention.instance = None


def _bf16(x):
    return x.to(torch.bfloat16).float()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 as ``cvt.rna.tf32.f32`` rounds them: to
    nearest on the bit pattern, ties away from zero (half of the 13 dropped
    bits is added to the magnitude, which may carry into the exponent),
    the 13 low bits of the result zero. NaN stays NaN."""
    x = x.float()
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    out = sign | ((mag + 0x1000) & ~0x1FFF)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), as the kernels split an
    operand (x - hi is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernels' tensor-core products compute it: each
    operand split into a TF32 pair, then lo_a hi_b + hi_a lo_b + hi_a hi_b,
    three TF32 products (each exact in f32) summed in f32 (lo_a lo_b,
    ~2^-22 of a product, is dropped)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def strip_attention_emulation(q, k, v, scale: float, p_mode: str = "hi_lo",
                              key_block: int = None):
    """The tensor-core instances' arithmetic in plain PyTorch, for (B, H,
    N, D) inputs: strips of 16 queries, keys in blocks of ``key_block``
    (the compiled block the launcher would pick by default) padded to a
    multiple of 16 with keys >= N masked, running max and sum across
    blocks. bf16 inputs (the bf16 instance): the probabilities enter P V as
    bf16 fragments, ``"hi_lo"`` (the kernel: p = hi + lo, two products),
    ``"bf16"`` (one rounded fragment) or ``"f32"`` (no rounding).
    ``"split_tf32"`` (the f32 instance, f32 inputs): both products in split
    TF32 (``split_tf32_matmul``), P unnormalised. Products accumulate in
    f32 as the MMA does, up to summation order."""
    B, H, N, D = q.shape
    if key_block is None:
        key_block = next((kb for kb in KEY_BLOCKS if N <= kb), KEY_BLOCKS[-1])
    split = p_mode == "split_tf32"
    mm = split_tf32_matmul if split else torch.matmul
    qf, kf, vf = (t.float() if split else _bf16(t) for t in (q, k, v))
    out = torch.empty(B, H, N, D)
    for q0 in range(0, N, 16):
        qs = F.pad(qf[:, :, q0:q0 + 16], (0, 0, 0, max(0, q0 + 16 - N)))   # (B, H, 16, D)
        m = torch.full((B, H, 16, 1), float("-inf"))
        l = torch.zeros(B, H, 16, 1)
        o = torch.zeros(B, H, 16, D)
        for k0 in range(0, N, key_block):
            nk = min(N - k0, key_block)
            pad = -nk % 16
            kb = F.pad(kf[:, :, k0:k0 + nk], (0, 0, 0, pad))
            vb = F.pad(vf[:, :, k0:k0 + nk], (0, 0, 0, pad))
            s = mm(qs, kb.transpose(-1, -2)) * scale
            s[..., nk:] = float("-inf")
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            if split:
                pv = mm(p, vb)
            elif p_mode == "hi_lo":
                hi = _bf16(p)
                pv = hi @ vb + _bf16(p - hi) @ vb
            else:
                pv = (_bf16(p) if p_mode == "bf16" else p) @ vb
            o, m = o * corr + pv, m_new
        out[:, :, q0:q0 + 16] = (o / l)[:, :, :min(16, N - q0)]
    return out.to(q.dtype)
