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

The source holds three hand-written instances, chosen by shape and dtype
in its C launcher (``spatial_table.instance`` names the one the last launch
took): the fast one (bf16: ``wgmma`` products, register-resident attention,
the last layer for the cls rows only), one design compiled for each entry
of ``FAST_INSTANCES`` (the flagship ViViT's D 128 / d_head 64 with several
frames per block up to N 80, one frame per block up to N 144 and one frame
per two-block cluster up to N 257, the full 256 px frame at patch 16; the
demo ViViT's D 64 / d_head 32 up to N 80); its f32 sibling, the entries of
``FAST_F32_INSTANCES`` (the flagship widths, products on the tensor cores
in split TF32: frames packed into a block up to N 80, one frame over a
cluster of ceil(N / 80) blocks up to N 257); and the general one (f32 and
bf16 at any other accepted width, N <= 128). The wrapper packs the weights
for the instance (``pack_fast``: the kernel's panel stream, in the
instance's MLP chunks and panel layout; ``pack_general``) once per weights
bundle, dtype and chunk. ``packed_walk_reference`` walks the fast and f32
instances' streams in plain PyTorch (past N 80 with the attention over
blocks of keys: two passes in bf16, the f32 cluster's online softmax over
its blocks' rows; in f32 with the split-TF32 products), so that the packing
and the kernels' order of work are tested without a GPU.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _build
from .attention import split_tf32

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


def kernel_refusal(T: int, N: int, D: int, depth: int, n_heads: int, d_head: int,
                   M: int, compute_dtype: torch.dtype, device=None,
                   weights: SpatialWeights = None):
    """Why the CUDA kernel would not take a call at these widths, or None
    when it would. Nothing is launched: the limits are checked here, and on
    a CUDA ``device`` the kernel library is built to ask its plan for the
    shared memory a block needs, against the device's opt-in limit.
    ``_launch`` raises with this reason, so the two cannot disagree."""
    if compute_dtype not in _DTYPES:
        return f"compute dtype {compute_dtype} not supported (float32 or bfloat16)"
    # N <= MAX_N is the general instance's limit; a fast instance sets its own
    fast = fast_applies(N, D, d_head, M, compute_dtype)
    if not ((0 < N <= MAX_N or fast) and 0 < D <= MAX_D and 0 < d_head <= MAX_D_HEAD
            and T > 0 and depth > 0 and n_heads > 0 and M > 0
            and D % 16 == 0 and d_head % 16 == 0 and M % 16 == 0):
        return (f"it takes N <= {MAX_N}, D <= {MAX_D}, d_head <= {MAX_D_HEAD}, "
                f"with D, d_head and the MLP width multiples of 16"
                + _fast_limits(D, d_head))
    if weights is not None:
        inner = n_heads * d_head
        expect = {"w_qkv": (3 * inner, D), "w_out": (D, inner), "w_ff1": (M, D),
                  "w_ff2": (D, M), "b_out": (D,), "b_ff1": (M,), "b_ff2": (D,),
                  "ln_a_s": (D,), "ln_a_b": (D,), "ln_f_s": (D,), "ln_f_b": (D,)}
        for name, want in expect.items():
            got = getattr(weights, name)
            if len(got) < depth or any(tuple(t.shape) != want for t in got[:depth]):
                return (f"{name} shapes {[tuple(t.shape) for t in got]} do not "
                        f"match {want}")
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        smem = _kernel_plan(N, D, n_heads, d_head, M, compute_dtype)[1]
        limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
        if smem > limit:
            return (f"needs {smem} bytes of shared memory per block, the device "
                    f"allows {limit}")
    return None


def _fast_limits(D: int, d_head: int) -> str:
    """The fast and f32 instances' own limits at these widths, for a
    refusal."""
    limits = []
    for name, insts in (("bfloat16", FAST_INSTANCES), ("float32", FAST_F32_INSTANCES)):
        max_n = max((i.max_n for i in insts if (i.d, i.d_head) == (D, d_head)), default=None)
        if max_n is not None:
            limits.append(f"N <= {max_n} in {name}")
    return f" ({'; '.join(limits)} at D {D}, d_head {d_head})" if limits else ""


def _kernel_plan(N, D, n_heads, d_head, M, cd) -> tuple:
    """(frames per block of the fast instance or 0 for the general one,
    shared-memory bytes per block, blocks per cluster, MLP chunk of the
    weight stream), from the kernel source's own plan."""
    dims = (N, D, n_heads, d_head, M, torch.finfo(cd).bits // 8)
    fn = lambda name, restype=ctypes.c_int: _build.function(
        "spatial_table", name, [ctypes.c_int] * 6, restype)(*dims)
    return (fn("spatial_table_plan"), fn("spatial_table_smem_bytes", ctypes.c_longlong),
            fn("spatial_table_cluster_size"), fn("spatial_table_mlp_chunk"))


def _launch(tokens, w: SpatialWeights, n_offsets, depth, n_heads, d_head,
            cd, scale):
    T, N, D = tokens.shape
    M = w.w_ff1[0].shape[0]
    shape = (f"tokens {tuple(tokens.shape)}, depth {depth}, {n_heads} heads x "
             f"{d_head}, mlp {M}, {cd}")
    dev = tokens.device
    refusal = (kernel_refusal(T, N, D, depth, n_heads, d_head, M, cd, dev, w)
               if n_offsets > 0 else "n_offsets must be positive")
    if refusal is not None:
        raise ValueError(f"spatial_table: shape not supported by the CUDA kernel "
                         f"({shape}): {refusal}")
    frames, _, cluster, chunk = _kernel_plan(N, D, n_heads, d_head, M, cd)
    inst = fast_instance(D, d_head, N, cd)
    expect = ((fast_frames_per_block(N, D, d_head, cd), inst.cluster, inst.mlp_chunk)
              if fast_applies(N, D, d_head, M, cd) else (0, 0, 0))
    if (frames, cluster, chunk) != expect:
        raise RuntimeError(f"spatial_table: the kernel source and its wrapper "
                           f"disagree on the instance for {shape}")

    wmat, wln = _packed_weights(w, depth, n_heads, cd, dev, mlp_chunk=chunk,
                                layout=inst.layout if frames else None)
    tok = _aligned(tokens.to(cd).contiguous())
    base = _aligned(w.base[:n_offsets, :N].to(device=dev, dtype=cd).contiguous())
    out = torch.empty((n_offsets, T, D), device=dev, dtype=cd)

    fn = _build.function("spatial_table", f"spatial_table_{_DTYPES[cd]}", _ARGTYPES)
    err = fn(tok.data_ptr(), base.data_ptr(), wmat.data_ptr(), wln.data_ptr(),
             out.data_ptr(), T, n_offsets, N, D, depth, n_heads, d_head, M,
             float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("spatial_table", err, "spatial_table")
    spatial_table.launches += 1
    spatial_table.instance = fast_instance_name(N, D, d_head, cd) if frames else "general"
    spatial_table.frames_per_block = frames or 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy that starts on a 16-byte boundary (the fast instance
    loads 16 bytes at a time; a view may start anywhere in its storage)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---- weights laid out for the kernel ---------------------------------------
# The fast instance (csrc/spatial_table.cu, namespace fast) is one design
# compiled for each width below, and consumes the weights as a stream of
# panels, each in the layout it has in shared memory, so that a panel is one
# flat copy: the blocked layout wgmma reads (csrc/wgmma.cuh), 8 x 8 core
# matrices of 64 contiguous elements, those of one 8-row group side by side
# along k ("core8x8"). Its f32 sibling (namespace tf32) takes the same
# stream in 8 x 16 tiles of 128 contiguous floats, those of one 8-row group
# side by side along k ("tile8x16"): lane (g, t) of a warp reads row g,
# columns 4t .. 4t + 3 of a tile as one float4, its split-TF32 B fragment.


class FastInstance(NamedTuple):
    """One compiled width of the fast instance (``Shape`` in the source):
    model and head width, the MLP columns of one FF panel, the rows its
    products compute per block, the rows of q, k and v in shared memory
    (packed frames), the most tokens a frame may have, and the blocks that
    share one frame."""
    d: int
    d_head: int
    mlp_chunk: int
    product_rows: int
    rows: int
    max_n: int = 80
    cluster: int = 1
    layout: str = "core8x8"


# Up to PACKED_MAX_N tokens (five 16-key tiles, one pass of the attention
# core) a block packs several frames; past it a block, or a cluster of two,
# owns one frame. The flagship ViViT's widths (2 x 64 wgmma rows + 16 on
# mma.sync a block): packed up to N 80, one frame a block up to its 144
# rows, one frame over a two-block cluster (MLP chunks of 64, so that the
# panels fit beside the frame's k and v) up to N 257, the full 256 px frame
# at patch 16. The demo ViViT's (2 x 64 wgmma rows): packed up to N 80.
PACKED_MAX_N = 80
FAST_INSTANCES = (FastInstance(128, 64, 128, 144, 160),
                  FastInstance(128, 64, 128, 144, 160, max_n=144),
                  FastInstance(128, 64, 64, 144, 160, max_n=257, cluster=2),
                  FastInstance(64, 32, 64, 128, 144))
# The f32 instance (products in split TF32): the flagship ViViT's widths,
# MLP chunks of 64; frames packed into a block of 80 rows up to N 80, past
# it one frame over a cluster of blocks of 64 rows (one compiled kernel; the
# cluster size is the launch's), each with its share of the frame's 16-row
# tiles (``cluster_row_split``), at most four: 2 blocks up to N 128, 3 up to
# 192, 4 up to 256, 5 at 257.
F32_CLUSTER_TILES = 4
_F32_CLUSTER_ROWS = 16 * F32_CLUSTER_TILES
FAST_F32_INSTANCES = (FastInstance(128, 64, 64, 80, 80, layout="tile8x16"),
                      *(FastInstance(128, 64, 64, _F32_CLUSTER_ROWS, _F32_CLUSTER_ROWS,
                                     max_n=min(_F32_CLUSTER_ROWS * c, 257), cluster=c,
                                     layout="tile8x16") for c in (2, 3, 4, 5)))
# the last layer's 16-row cls tile
FAST_MAX_FRAMES = 16

_GENERAL_ORDER = ("w_qkv", "w_out", "b_out", "w_ff1", "b_ff1", "w_ff2", "b_ff2")
_LN_ORDER = ("ln_a_s", "ln_a_b", "ln_f_s", "ln_f_b")


def fast_instance(D: int, d_head: int, N: int = 1, dtype: torch.dtype = torch.bfloat16):
    """The fast instance (bf16) or the f32 one compiled for these widths
    that takes frames of N tokens (by default the packed one), or None."""
    insts = (FAST_INSTANCES if dtype == torch.bfloat16
             else FAST_F32_INSTANCES if dtype == torch.float32 else ())
    return next((i for i in insts
                 if (i.d, i.d_head) == (D, d_head) and 1 <= N <= i.max_n), None)


def _instance_of(D: int, d_head: int, N: int = 1,
                 dtype: torch.dtype = torch.bfloat16) -> FastInstance:
    inst = fast_instance(D, d_head, N, dtype)
    if inst is None:
        raise ValueError(f"no fast instance is compiled for D {D}, d_head {d_head}, N {N}, "
                         f"{dtype}")
    return inst


def fast_applies(N: int, D: int, d_head: int, M: int,
                 dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether a call at these widths in ``dtype`` takes the fast instance
    (bf16) or the f32 one."""
    inst = fast_instance(D, d_head, N, dtype)
    return inst is not None and M > 0 and M % inst.mlp_chunk == 0


def fast_frames_per_block(N: int, D: int, d_head: int,
                          dtype: torch.dtype = torch.bfloat16) -> int:
    """Frames one block of the fast instance at these widths owns: packed
    (N <= PACKED_MAX_N), the most whose rows fit in the ``product_rows`` rows
    its products compute and, the last frame's keys padded to a multiple of
    16, in its ``rows`` rows of q, k and v, at most FAST_MAX_FRAMES (the last
    layer's cls tile); past it one (a block or a cluster owns a frame)."""
    inst = _instance_of(D, d_head, N, dtype)
    if inst.max_n > PACKED_MAX_N:
        return 1
    return min((inst.rows - -(-N // 16) * 16) // N + 1, inst.product_rows // N,
               FAST_MAX_FRAMES)


def fast_instance_name(N: int, D: int, d_head: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """``spatial_table.instance`` for the fast (or f32) instance at N
    tokens: by its frames per block where it packs them, else by N and its
    cluster size; the f32 one's name starts ``fast_f32``."""
    inst = _instance_of(D, d_head, N, dtype)
    kind = "fast_f32" if dtype == torch.float32 else "fast"
    if inst.max_n > PACKED_MAX_N:
        return f"{kind}_D{D}_N{N}_C{inst.cluster}"
    return f"{kind}_D{D}_F{fast_frames_per_block(N, D, d_head, dtype)}"


def cluster_row_split(N: int, C: int) -> list:
    """The f32 cluster's rows of a frame of N tokens, as ``(first row,
    rows)`` for each of its C blocks (``cluster_rows`` in the source): the
    frame's 16-row tiles shared out as evenly as they go, the odd ones to
    the last blocks, so block 0 (the cls row's) has the fewest."""
    tiles = -(-N // 16)
    base, big = tiles // C, C - tiles % C
    split = []
    for r in range(C):
        row0 = 16 * (r * base + max(r - big, 0))
        split.append((row0, min(16 * (base + (r >= big)), N - row0)))
    return split


def fast_kernel_attributes(D: int, d_head: int, N: int = 1,
                           dtype: torch.dtype = torch.bfloat16) -> dict:
    """The fast (or f32) instance at these widths that takes N tokens as
    the card takes it (builds the kernel library): registers a thread,
    dynamic and static shared memory a block, threads a block, blocks
    resident on one SM, blocks a cluster and clusters resident on the card
    (0 for a block of its own)."""
    out = (ctypes.c_int * 7)()
    fn = _build.function("spatial_table", "spatial_table_fast_attributes",
                         [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check("spatial_table", fn(N, D, d_head, torch.finfo(dtype).bits // 8,
                                     ctypes.addressof(out)),
                 "spatial_table_fast_attributes")
    keys = ("registers", "dynamic_smem_bytes", "static_smem_bytes", "threads",
            "blocks_per_sm", "cluster_size", "active_clusters")
    return dict(zip(keys, out))


def _panel(m: torch.Tensor, cols: int = 8) -> torch.Tensor:
    """(rows, K) -> flat blocked panel of 8 x ``cols`` tiles: element (n, k)
    at ((n // 8) * (K // cols) + k // cols) * 8 * cols + (n % 8) * cols +
    k % cols."""
    rows, K = m.shape
    return m.reshape(rows // 8, 8, K // cols, cols).permute(0, 2, 1, 3).reshape(-1)


def _unpanel(flat: torch.Tensor, rows: int, K: int, cols: int = 8) -> torch.Tensor:
    """The (rows, K) matrix of a flat blocked panel of 8 x ``cols`` tiles."""
    return flat.reshape(rows // 8, K // cols, 8, cols).permute(0, 2, 1, 3).reshape(rows, K)


# the panel layouts of the instances: columns per 8-row tile
PANEL_TILE_COLS = {"core8x8": 8, "tile8x16": 16}


def pack_fast(w: SpatialWeights, depth: int, n_heads: int,
              dtype: torch.dtype = torch.bfloat16, mlp_chunk: int = None,
              layout: str = "core8x8") -> torch.Tensor:
    """The fast (or f32) instance's weight stream, for the instance of the
    bundle's widths. Per layer, in the order the kernel multiplies: per head
    h the q rows then the k rows of w_qkv as one panel (2*d_head, D), its v
    rows (d_head, D), and its columns of w_out (D, d_head); per chunk c of
    ``mlp_chunk`` MLP columns (by default the packed instance's) the rows of
    w_ff1 (chunk, D) and the columns of w_ff2 (D, chunk); then b_out,
    b_ff1, b_ff2. Panels in ``layout`` (``PANEL_TILE_COLS``): the fast
    instance's "core8x8", the f32 one's "tile8x16"."""
    D = w.w_qkv[0].shape[1]
    dh = w.w_qkv[0].shape[0] // (3 * n_heads)
    mc = mlp_chunk or _instance_of(D, dh).mlp_chunk
    cols = PANEL_TILE_COLS[layout]
    panel = lambda m: _panel(m, cols)
    inner = n_heads * dh
    parts = []
    for d in range(depth):
        qkv, out = w.w_qkv[d].to(dtype), w.w_out[d].to(dtype)
        ff1, ff2 = w.w_ff1[d].to(dtype), w.w_ff2[d].to(dtype)
        for h in range(n_heads):
            rows = slice(h * dh, (h + 1) * dh)
            q, k, v = (qkv[part * inner:(part + 1) * inner][rows] for part in range(3))
            parts += [panel(torch.cat([q, k])), panel(v), panel(out[:, rows])]
        for m0 in range(0, ff1.shape[0], mc):
            parts += [panel(ff1[m0:m0 + mc]), panel(ff2[:, m0:m0 + mc])]
        parts += [getattr(w, name)[d].to(dtype).reshape(-1)
                  for name in ("b_out", "b_ff1", "b_ff2")]
    return torch.cat(parts)


def fast_panels(packed: torch.Tensor, depth: int, n_heads: int, M: int, D: int,
                d_head: int, mlp_chunk: int = None, layout: str = "core8x8"):
    """Walk a ``pack_fast`` stream of the instance at (D, d_head) in the
    kernel's order: yields ``(layer, kind, index, matrix)`` with the
    blocking (of ``layout``) undone, kind one of "qk", "v", "out" (index =
    head), "ff1", "ff2" (index = chunk), and "b_out", "b_ff1", "b_ff2"
    (vectors)."""
    dh, mc = d_head, mlp_chunk or _instance_of(D, d_head).mlp_chunk
    cols = PANEL_TILE_COLS[layout]
    pos = 0

    def take(rows, K):
        nonlocal pos
        n = rows * K
        if pos + n > packed.numel():
            raise ValueError(f"fast_panels: stream of {packed.numel()} elements, "
                             f"walked past its end at {pos + n}")
        pos += n
        flat = packed[pos - n:pos]
        return flat if rows == 1 else _unpanel(flat, rows, K, cols)

    for d in range(depth):
        for h in range(n_heads):
            yield d, "qk", h, take(2 * dh, D)
            yield d, "v", h, take(dh, D)
            yield d, "out", h, take(D, dh)
        for c in range(M // mc):
            yield d, "ff1", c, take(mc, D)
            yield d, "ff2", c, take(D, mc)
        for name, n in (("b_out", D), ("b_ff1", M), ("b_ff2", D)):
            yield d, name, 0, take(1, n)
    if pos != packed.numel():
        raise ValueError(f"fast_panels: stream of {packed.numel()} elements, "
                         f"walked {pos}")


def unpack_fast(packed: torch.Tensor, depth: int, n_heads: int, M: int, D: int,
                d_head: int, mlp_chunk: int = None, layout: str = "core8x8") -> dict:
    """The matrices and biases a ``pack_fast`` stream of the instance at (D,
    d_head) was made from, as ``{field: tuple over layers}`` in
    ``SpatialWeights`` layout."""
    dh = d_head
    got = {}
    for d, kind, _, m in fast_panels(packed, depth, n_heads, M, D, d_head, mlp_chunk, layout):
        got.setdefault((d, kind), []).append(m)
    out = {name: [] for name in _GENERAL_ORDER}
    for d in range(depth):
        qk = got[d, "qk"]
        out["w_qkv"].append(torch.cat([p[:dh] for p in qk] + [p[dh:] for p in qk]
                                      + got[d, "v"]))
        out["w_out"].append(torch.cat(got[d, "out"], dim=1))
        out["w_ff1"].append(torch.cat(got[d, "ff1"]))
        out["w_ff2"].append(torch.cat(got[d, "ff2"], dim=1))
        for name in ("b_out", "b_ff1", "b_ff2"):
            out[name].append(got[d, name][0])
    return {name: tuple(v) for name, v in out.items()}


def pack_general(w: SpatialWeights, depth: int, dtype: torch.dtype) -> torch.Tensor:
    """The general instance's weights: per layer w_qkv, w_out, b_out, w_ff1,
    b_ff1, w_ff2, b_ff2, each flat in Linear layout."""
    return torch.cat([getattr(w, name)[d].to(dtype).reshape(-1)
                      for d in range(depth) for name in _GENERAL_ORDER])


def pack_layer_norms(w: SpatialWeights, depth: int) -> torch.Tensor:
    """LayerNorm vectors in f32: per layer attention scale, bias, FF scale,
    bias; then the final scale and bias."""
    return torch.cat([getattr(w, name)[d].float().reshape(-1)
                      for d in range(depth) for name in _LN_ORDER]
                     + [w.ln_fin_s.float().reshape(-1), w.ln_fin_b.float().reshape(-1)])


def _mm_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T over the last axes, each output element summed on its own in
    one fixed order, so a row's result does not depend on which other rows
    are computed with it (a BLAS product may block a 1-row and an N-row
    call differently)."""
    return (a.unsqueeze(-2) * b.unsqueeze(-3)).sum(-1)


def _mm_rows_split_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_mm_rows`` as the f32 instance's products compute it: both operands
    split into TF32 pairs (``ops.attention.split_tf32``), lo_a hi_b + hi_a
    lo_b + hi_a hi_b, each product exact in f32, the sums in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (_mm_rows(al, bh) + _mm_rows(ah, bl)) + _mm_rows(ah, bh)


def two_pass_probs(scores: torch.Tensor, key_block: int) -> torch.Tensor:
    """Softmax over the last axis as the fast instance takes it past
    PACKED_MAX_N tokens (``attn_strip_two_pass``): a first pass over blocks
    of ``key_block`` keys keeps each row's running max and its sum of
    exponentials, rescaled when the max grows; the second divides each
    exponential by the sum (as a product with its reciprocal). f32."""
    m = torch.full_like(scores[..., :1], float("-inf"))
    total = torch.zeros_like(m)
    for k0 in range(0, scores.shape[-1], key_block):
        blk = scores[..., k0:k0 + key_block]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        total = total * torch.exp(m - m_new) + torch.exp(blk - m_new).sum(-1, keepdim=True)
        m = m_new
    return torch.exp(scores - m) * (1.0 / total)


def packed_walk_reference(tokens: torch.Tensor, packed: torch.Tensor, wln: torch.Tensor,
                          base: torch.Tensor, depth: int, n_heads: int, d_head: int, M: int,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          scale: float = None, cls_last: bool = True,
                          mlp_chunk: int = None, key_block: int = None,
                          layout: str = "core8x8", split: bool = False,
                          cluster: int = None) -> torch.Tensor:
    """The fast instance's walk in plain PyTorch: the same function as
    ``spatial_table_reference``, computed from a ``pack_fast`` stream (of
    ``layout``) panel by panel in the kernel's order (per head q|k, v,
    attention, out-projection summed over heads in f32; per MLP chunk FF1,
    GELU, FF2 summed over chunks in f32), with the kernel's cast points.
    With ``cls_last`` the last layer computes K and V for all rows and
    everything else for the cls row only, which is all the table keeps.
    ``mlp_chunk`` is the stream's chunk (by default the packed instance's);
    with ``key_block`` the softmax runs as the two-pass core does
    (``two_pass_probs``), else over all keys at once. With ``split`` every
    product runs as the f32 instance's do, in split TF32
    (``_mm_rows_split_tf32``), and P V takes the unnormalised exponentials
    and divides by their sum after, as its online softmax does; with
    ``cluster`` (the f32 cluster's blocks per frame) the keys come in the
    blocks of its row split (``cluster_row_split``), as the cluster's
    attention takes them (``_split_attention_parts``): in the all-row layers
    two parts, the first half of the blocks and the rest, merged; in the
    last layer one part per block, merged (the products are row by row, so
    the row split itself changes nothing else).
    Products go through ``_mm_rows``, so the cls row's arithmetic is the
    same either way, bit for bit; it is meant for small inputs."""
    cd = compute_dtype
    D, dh = tokens.shape[-1], d_head
    mc = mlp_chunk or _instance_of(D, dh).mlp_chunk
    scale = dh ** -0.5 if scale is None else scale
    rnd = lambda t: t.to(cd).float()
    mm = _mm_rows_split_tf32 if split else _mm_rows
    ln = wln.float().reshape(-1, D)
    panels = {(d, kind, i): rnd(m)
              for d, kind, i, m in fast_panels(packed, depth, n_heads, M, D, dh, mc, layout)}
    tokens, base = rnd(tokens), rnd(base[:, :tokens.shape[1]])
    out = []
    for off in range(base.shape[0]):
        x = rnd(tokens + base[off][None])                             # (T, N, D)
        for d in range(depth):
            rows = slice(0, 1) if cls_last and d == depth - 1 else slice(None)
            h = rnd(_layer_norm(x, ln[4 * d], ln[4 * d + 1]))
            acc = 0.0
            for hh in range(n_heads):
                qk, wv = panels[d, "qk", hh], panels[d, "v", hh]
                q, k = rnd(mm(h[:, rows], qk[:dh])), rnd(mm(h, qk[dh:]))
                v = rnd(mm(h, wv))
                sc = mm(q, k) * scale
                if split and cluster:
                    blocks = cluster_row_split(sc.shape[-1], cluster)
                    half = -(-cluster // 2)
                    parts = ([[b] for b in blocks] if cls_last and d == depth - 1
                             else [blocks[:half], blocks[half:]])
                    o = _split_attention_parts(sc, v, parts)
                elif split:
                    e = torch.exp(sc - sc.amax(-1, keepdim=True))
                    o = mm(e, v.transpose(-1, -2)) / e.sum(-1, keepdim=True)
                else:
                    if key_block:
                        prob = two_pass_probs(sc, key_block)
                    else:
                        e = torch.exp(sc - sc.amax(-1, keepdim=True))
                        prob = e / e.sum(-1, keepdim=True)
                    o = rnd(_mm_rows(rnd(prob), v.transpose(-1, -2)))
                acc = acc + mm(o, panels[d, "out", hh])
            x = rnd(x[:, rows] + rnd(rnd(acc) + panels[d, "b_out", 0]))
            f = rnd(_layer_norm(x, ln[4 * d + 2], ln[4 * d + 3]))
            acc = 0.0
            for c in range(M // mc):
                bias = panels[d, "b_ff1", 0][c * mc:(c + 1) * mc]
                mid = rnd(rnd(mm(f, panels[d, "ff1", c])) + bias)
                acc = acc + mm(rnd(F.gelu(mid, approximate="tanh")), panels[d, "ff2", c])
            x = rnd(x + rnd(rnd(acc) + panels[d, "b_ff2", 0]))
        out.append(_layer_norm(x[:, 0], ln[4 * depth], ln[4 * depth + 1]).to(cd))
    return torch.stack(out)


def _split_attention_parts(scores: torch.Tensor, v: torch.Tensor, parts) -> torch.Tensor:
    """softmax(scores) v as the f32 cluster's attention takes it: ``parts``
    is a list of lists of key blocks (``(first key, keys)``). Within a part
    the blocks' keys come in order, 16 at a time (a block's last tile may be
    short), each tile growing the running max, rescaling the running sum and
    output and adding its P V (split TF32, unnormalised P); the parts'
    outputs and sums are then merged in order, each scaled by exp(its max -
    the overall max), and the sum divides at the end."""
    merged = []
    for blocks in parts:
        m = torch.full_like(scores[..., :1], float("-inf"))
        total = torch.zeros_like(m)
        o = 0.0
        tiles = [(k0 + t0, min(16, n - t0)) for k0, n in blocks for t0 in range(0, n, 16)]
        for k0, n in tiles:
            blk = scores[..., k0:k0 + n]
            m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            e = torch.exp(blk - m_new)
            total = total * corr + e.sum(-1, keepdim=True)
            o = o * corr + _mm_rows_split_tf32(e, v[..., k0:k0 + n, :].transpose(-1, -2))
            m = m_new
        merged.append((m, total, o))
    if len(merged) == 1:
        return merged[0][2] / merged[0][1]
    mx = torch.stack([m for m, _, _ in merged]).amax(0)
    num, den = 0.0, 0.0
    for m, total, o in merged:
        e = torch.exp(m - mx)
        num, den = num + o * e, den + total * e
    return num / den


_pack_cache: dict = {}
_PACK_CACHE_SIZE = 8


def _packed_weights(w: SpatialWeights, depth, n_heads, cd, dev, mlp_chunk: int,
                    layout: str = None):
    """(matrices, LayerNorm vectors) on ``dev`` for the instance (the fast
    or f32 one's stream in MLP chunks of ``mlp_chunk`` and panels of
    ``layout``, by default the fast one's, or with chunk 0 the general
    one's), cached per weights object (its tensors' identity and version),
    dtype, device, chunk and layout."""
    layout = (layout or "core8x8") if mlp_chunk else None
    tensors = [t for field in w[1:] for t in (field if isinstance(field, tuple) else (field,))]
    key = (tuple((id(t), t._version) for t in tensors), depth, n_heads, cd, str(dev), mlp_chunk,
           layout)
    hit = _pack_cache.get(key)
    if hit is None:
        wmat = (pack_fast(w, depth, n_heads, cd, mlp_chunk, layout) if mlp_chunk
                else pack_general(w, depth, cd))
        # the entry keeps `tensors` alive, so their ids stay theirs
        hit = (wmat.to(dev), pack_layer_norms(w, depth).to(dev), tensors)
        while len(_pack_cache) >= _PACK_CACHE_SIZE:
            _pack_cache.pop(next(iter(_pack_cache)))
        _pack_cache[key] = hit
    return hit[0], hit[1]


spatial_table.launches = 0
spatial_table.instance = None
spatial_table.frames_per_block = None
