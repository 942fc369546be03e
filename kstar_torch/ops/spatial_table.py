"""Spatial-cls table: the sweep's main kernel and its plain version.

Port of ``kstar_tpu/ops/spatial_table.py``. The continuous sweep needs, per
shot, the ViViT spatial transformer's cls embedding for every (in-window
offset, frame) pair (models/vivit.py ``spatial_cls``). ``spatial_table``
computes the whole depth-L pre-norm spatial transformer for all offsets at
once: the CUDA kernel ``csrc/spatial_table.cu`` on a CUDA tensor, the plain
``spatial_table_reference`` on a CPU tensor.

Both follow the JAX kernel's ``attn_mode="batched"`` numerics: LayerNorm
and softmax in f32, every product accumulated in f32 and rounded to the
compute dtype, biases and residuals added in the compute dtype. The JAX
kernel's TPU-only switches (the ``paired``/``packedN``/``global-masked``
layouts, the inexact ``none`` and ``debug_skip`` profiling modes,
``block_f``, ``pad_d_head`` and ``interpret``) have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_N, MAX_D, MAX_D_HEAD = 128, 256, 128
# tokens, base, matrices, LayerNorm vectors, out, T, n_off, N, D, depth,
# heads, d_head, mlp, scale, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


class SpatialWeights(NamedTuple):
    """Weight bundle of the spatial transformer, in ``torch.nn.Linear``
    layout (out, in). Per layer d: ln_a scale/bias (D,), w_qkv (3*inner, D),
    ln_f scale/bias, w_out (D, inner), b_out (D,), w_ff1 (M, D), b_ff1 (M,),
    w_ff2 (D, M), b_ff2 (D,); then the final LayerNorm scale/bias. LayerNorm
    parameters are f32, the rest in the compute dtype.

    ``base`` (n_off, N, D) holds row 0 = space_token + pos[o, 0] and rows
    1..N-1 = pos[o, 1:]; added to zero-cls-padded tokens it reproduces
    concat([cls, tokens]) + pos exactly.
    """
    base: torch.Tensor
    ln_a_s: tuple
    ln_a_b: tuple
    w_qkv: tuple
    ln_f_s: tuple
    ln_f_b: tuple
    w_out: tuple
    b_out: tuple
    w_ff1: tuple
    b_ff1: tuple
    w_ff2: tuple
    b_ff2: tuple
    ln_fin_s: torch.Tensor
    ln_fin_b: torch.Tensor


def _nest(state_dict: Mapping) -> dict:
    """Flat ``a.b.c`` state-dict keys -> nested dicts."""
    tree: dict = {}
    for key, value in state_dict.items():
        node = tree
        *path, leaf = key.split(".")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def find_spatial_params(params):
    """Locate the ViViT-encoder subtree (the dict holding space_transformer
    + pos_embedding) anywhere in a params tree (bare ViViT or nested)."""
    if isinstance(params, Mapping):
        if "space_transformer" in params and "pos_embedding" in params:
            return params
        for v in params.values():
            found = find_spatial_params(v)
            if found is not None:
                return found
    return None


def as_f32_tensor(x) -> torch.Tensor:
    """A tensor (detached, on its device) or an array as f32; arrays go
    through f32 numpy, since bf16 arrays arrive as ml_dtypes, which torch
    cannot read."""
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.array(x, np.float32))


def extract_spatial_weights(params, n_offsets: int, depth: int = 2,
                            dtype: torch.dtype = torch.bfloat16) -> SpatialWeights:
    """Pull the spatial-transformer weights into the bundle. ``params`` is a
    flax params tree (Dense ``kernel`` (in, out), LayerNorm ``scale``), a
    port tree (``weight`` in Linear layout) as nested dicts of numpy arrays
    or tensors, or a port module. Tensors stay on their device."""
    if isinstance(params, nn.Module):
        params = _nest(params.state_dict())
    enc = find_spatial_params(params)
    if enc is None:
        raise KeyError("no ViViT spatial transformer found in params tree")
    st = enc["space_transformer"]
    pos = as_f32_tensor(enc["pos_embedding"])[0]             # (T_win, N, D)
    tok = as_f32_tensor(enc["space_token"]).reshape(-1)      # (D,)
    if pos.shape[0] < n_offsets:
        raise ValueError(
            f"n_offsets={n_offsets} exceeds the checkpoint's positional-"
            f"embedding rows ({pos.shape[0]}): the sweep's seq_len must not "
            f"exceed the model's n_frames")
    base = pos[:n_offsets].clone()
    base[:, 0, :] += tok
    base = base.to(dtype)

    def dense(d):
        return (as_f32_tensor(d["kernel"]).T if "kernel" in d
                else as_f32_tensor(d["weight"])).contiguous().to(dtype)

    def bias(d):
        return as_f32_tensor(d["bias"]).to(dtype)

    def ln(d):
        scale = d["scale"] if "scale" in d else d["weight"]
        return as_f32_tensor(scale), as_f32_tensor(d["bias"])

    layers = range(depth)
    ln_a = [ln(st[f"attn_norm_{d}"]) for d in layers]
    ln_f = [ln(st[f"ff_norm_{d}"]) for d in layers]
    fin_s, fin_b = ln(st["final_norm"])
    return SpatialWeights(
        base=base,
        ln_a_s=tuple(s for s, _ in ln_a), ln_a_b=tuple(b for _, b in ln_a),
        w_qkv=tuple(dense(st[f"attn_{d}"]["to_qkv"]) for d in layers),
        ln_f_s=tuple(s for s, _ in ln_f), ln_f_b=tuple(b for _, b in ln_f),
        w_out=tuple(dense(st[f"attn_{d}"]["to_out"]) for d in layers),
        b_out=tuple(bias(st[f"attn_{d}"]["to_out"]) for d in layers),
        w_ff1=tuple(dense(st[f"ff1_{d}"]) for d in layers),
        b_ff1=tuple(bias(st[f"ff1_{d}"]) for d in layers),
        w_ff2=tuple(dense(st[f"ff2_{d}"]) for d in layers),
        b_ff2=tuple(bias(st[f"ff2_{d}"]) for d in layers),
        ln_fin_s=fin_s, ln_fin_b=fin_b,
    )


def _layer_norm(x32, scale, bias, eps: float = 1e-6):
    """flax LayerNorm semantics in f32 (mean-of-squares variance)."""
    mean = x32.mean(-1, keepdim=True)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def spatial_table_reference(tokens: torch.Tensor, weights: SpatialWeights,
                            n_offsets: int, depth: int = 2, n_heads: int = 4,
                            d_head: int = 64,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            scale: float = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (T, N, D) zero-cls-padded
    tokens -> (n_offsets, T, D) cls table in ``compute_dtype``, with the
    JAX kernel's cast points (``_kernel``, attn_mode="batched"). Tokens,
    ``base``, matrices and biases are taken in the compute dtype; every
    product is accumulated in f32."""
    cd = compute_dtype
    N = tokens.shape[1]
    scale = d_head ** -0.5 if scale is None else scale
    inner = n_heads * d_head
    rnd = lambda t: t.to(cd).float()          # round to the compute dtype
    w = weights
    mm = lambda a, m: a @ rnd(m).T           # a @ m.T, m in Linear layout
    tokens, base = rnd(tokens), rnd(w.base[:, :N])
    out = []
    for off in range(n_offsets):
        x = rnd(tokens + base[off][None])                       # (T, N, D)
        for d in range(depth):
            h = rnd(_layer_norm(x, w.ln_a_s[d], w.ln_a_b[d]))
            qkv = rnd(mm(h, w.w_qkv[d]))                         # (T, N, 3*inner)
            heads = []
            for hh in range(n_heads):
                q, k, v = (qkv[..., p * inner + hh * d_head:
                               p * inner + (hh + 1) * d_head] for p in range(3))
                s = (q @ k.transpose(-1, -2)) * scale
                e = torch.exp(s - s.amax(-1, keepdim=True))
                heads.append(rnd(rnd(e / e.sum(-1, keepdim=True)) @ v))
            proj = rnd(mm(torch.cat(heads, -1), w.w_out[d]))
            x = rnd(x + rnd(proj + rnd(w.b_out[d])))
            f = rnd(_layer_norm(x, w.ln_f_s[d], w.ln_f_b[d]))
            mid = rnd(rnd(mm(f, w.w_ff1[d])) + rnd(w.b_ff1[d]))
            mid = rnd(F.gelu(mid, approximate="tanh"))
            out2 = rnd(mm(mid, w.w_ff2[d]))
            x = rnd(x + rnd(out2 + rnd(w.b_ff2[d])))
        out.append(_layer_norm(x[:, 0], w.ln_fin_s, w.ln_fin_b).to(cd))
    return torch.stack(out)


def spatial_table(tokens: torch.Tensor, weights: SpatialWeights,
                  n_offsets: int, depth: int = 2, n_heads: int = 4,
                  d_head: int = 64, compute_dtype: torch.dtype = torch.bfloat16,
                  scale: float = None) -> torch.Tensor:
    """(T, N, D) zero-cls-padded patch tokens -> (n_offsets, T, D) cls table.

    ``tokens[:, 0]`` must be zeros (the cls slot: its content comes from
    ``weights.base``). A smaller crop than the positional embedding was
    trained for uses a prefix of ``base``, as the model does. Runs the CUDA
    kernel on a CUDA tensor and the plain version on a CPU tensor; raises
    ``ValueError`` for a shape the kernel does not take.
    """
    if tokens.dim() != 3:
        raise ValueError(f"spatial_table: tokens must be (T, N, D), got "
                         f"{tuple(tokens.shape)}")
    T, N, D = tokens.shape
    if weights.base.shape[0] < n_offsets or weights.base.shape[1] < N:
        raise ValueError(f"spatial_table: base {tuple(weights.base.shape)} "
                         f"does not cover {n_offsets} offsets x {N} tokens")
    if tokens.device.type == "cpu":
        return spatial_table_reference(tokens, weights, n_offsets, depth,
                                       n_heads, d_head, compute_dtype, scale)
    if tokens.device.type != "cuda":
        raise ValueError(f"spatial_table: unsupported device {tokens.device}")
    return _launch(tokens, weights, n_offsets, depth, n_heads, d_head,
                   compute_dtype, d_head ** -0.5 if scale is None else scale)


def _launch(tokens, w: SpatialWeights, n_offsets, depth, n_heads, d_head,
            cd, scale):
    T, N, D = tokens.shape
    inner = n_heads * d_head
    M = w.w_ff1[0].shape[0]
    shape = (f"tokens {tuple(tokens.shape)}, depth {depth}, {n_heads} heads x "
             f"{d_head}, mlp {M}, {cd}")
    if cd not in _DTYPES:
        raise ValueError(f"spatial_table: compute dtype {cd} not supported "
                         f"(float32 or bfloat16)")
    if not (0 < N <= MAX_N and 0 < D <= MAX_D and 0 < d_head <= MAX_D_HEAD
            and T > 0 and n_offsets > 0 and depth > 0 and M > 0
            and D % 16 == 0 and d_head % 16 == 0 and M % 16 == 0):
        raise ValueError(
            f"spatial_table: shape not supported by the CUDA kernel ({shape}); "
            f"it takes N <= {MAX_N}, D <= {MAX_D}, d_head <= {MAX_D_HEAD}, "
            f"with D, d_head and the MLP width multiples of 16")
    expect = {"w_qkv": (3 * inner, D), "w_out": (D, inner), "w_ff1": (M, D),
              "w_ff2": (D, M), "b_out": (D,), "b_ff1": (M,), "b_ff2": (D,),
              "ln_a_s": (D,), "ln_a_b": (D,), "ln_f_s": (D,), "ln_f_b": (D,)}
    for name, want in expect.items():
        got = getattr(w, name)
        if len(got) < depth or any(tuple(t.shape) != want for t in got[:depth]):
            raise ValueError(f"spatial_table: {name} shapes "
                             f"{[tuple(t.shape) for t in got]} do not match "
                             f"{want} for {shape}")

    dev = tokens.device
    elem = torch.finfo(cd).bits // 8
    smem = _build.function("spatial_table", "spatial_table_smem_bytes",
                           [ctypes.c_int] * 6, ctypes.c_longlong)(
        N, D, n_heads, d_head, M, elem)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"spatial_table: shape not supported by the CUDA kernel "
                         f"({shape}): needs {smem} bytes of shared memory per "
                         f"block, the device allows {limit}")

    on = lambda t, dt: t.to(device=dev, dtype=dt).reshape(-1)
    wmat = torch.cat([on(getattr(w, name)[d], cd) for d in range(depth)
                      for name in ("w_qkv", "w_out", "b_out", "w_ff1", "b_ff1",
                                   "w_ff2", "b_ff2")])
    wln = torch.cat([on(getattr(w, name)[d], torch.float32) for d in range(depth)
                     for name in ("ln_a_s", "ln_a_b", "ln_f_s", "ln_f_b")]
                    + [on(w.ln_fin_s, torch.float32), on(w.ln_fin_b, torch.float32)])
    tok = tokens.to(cd).contiguous()
    base = w.base[:n_offsets, :N].to(device=dev, dtype=cd).contiguous()
    out = torch.empty((n_offsets, T, D), device=dev, dtype=cd)

    fn = _build.function("spatial_table", f"spatial_table_{_DTYPES[cd]}", _ARGTYPES)
    err = fn(tok.data_ptr(), base.data_ptr(), wmat.data_ptr(), wln.data_ptr(),
             out.data_ptr(), T, n_offsets, N, D, depth, n_heads, d_head, M,
             float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("spatial_table", err, "spatial_table")
    spatial_table.launches += 1
    return out


spatial_table.launches = 0
