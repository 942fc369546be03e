"""Continuous whole-shot disruption-probability sweeps (video, 0D and
multimodal).

Port of ``kstar_tpu/infer/continuous.py``. A shot's frames (centre-cropped)
or its 0D table are uploaded to the device once; windows are gathered on
the device (raw frames by the window-gather kernel, ops/preprocess.py;
ViViT's cls table and 0D tables by the clamped rows of ``window_rows``,
one ``index_select`` each); the sweep runs
over fixed-size window chunks, bucketed so that ragged shot lengths give a
handful of shapes. On a GPU, the token paths of ``VideoSweeper`` and
``MultiModalSweeper`` replay one captured CUDA graph per chunk
(``_WindowLoop``, which both share): ViViT's temporal transformer, pool,
head and softmax of B gathered (L, D) windows, or a fusion model's
temporal transformer, 0D encoder, fusion head and softmax of B paired
(L, D) windows and (L, F) 0D rows, read from and written to buffers of
fixed shape, so that one capture serves every shot length.
``sweep_shots`` sweeps a shot library in groups that fit a device-memory
budget.

ViViT and the fusion models get the two exact fast paths of the JAX
sweep: per-frame patch embeddings are computed once per shot, and the
spatial transformer, which depends only on (frame, in-window offset), is
precomputed as the (offset x frame) cls table by the spatial-table kernel
(ops/spatial_table.py) where it takes the shape, so each window runs only
the temporal transformer (and, for a fusion model, the 0D encoder and the
fusion head).

Output alignment and startup suppression follow the reference:
  * video (generate_prob_curve, src/utils/utility.py:896-977):
    prob = [0]*(seq_len + frame_srt) + probs[1:-1]; zero any p >= 0.5 in
    the first second; time axis = arange(n)/fps;
  * 0D (generate_prob_curve_from_0D :979-1066): the scaler refit on the
    shot itself; prob = [0]*(frame_srt + seq_len) + probs[1:] + [0]*seq_len
    with frame_srt = int(t_start*fps/interval); suppression within fps*1
    samples; linear interpolation x interval to the frame rate; backward
    moving average k=12, clipped to [0, 1];
  * multi (generate_prob_curve_from_multi :1068-1178): stride-tau index
    ladders matched backward from the quench; piecewise time-axis
    reconstruction + linear interpolation; centred moving average k=16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import FPS, PIXEL_MEAN_BGR
from ..data.augment import center_crop
from ..ops.bn_act import bn_act
from ..ops.preprocess import gather_normalize
from ..parallel.comm import all_gather_objects
from ..ops.spatial_table import (extract_spatial_weights, kernel_refusal,
                                 spatial_table, spatial_table_reference)
from ..utils.graphs import capture, on_capture_stream, storage_key
from ..utils.profiling import span


def moving_average(x: np.ndarray, k: int, method: str = "backward") -> np.ndarray:
    """Moving-average smoothing, clipped to [0, 1]
    (reference moving_avarage_smoothing, src/utils/utility.py:872-893).

    backward: S[t] = mean(x[:t+1]) for t < k else sum(x[t-k:t]) / k
    (excludes x[t]); center: expanding head/tail means with a [t-hw, t+hw)
    body — one float64 cumulative sum."""
    n = len(x)
    if n == 0:
        return np.zeros(0)
    c = np.concatenate([[0.0], np.cumsum(np.asarray(x, np.float64))])
    t = np.arange(n)
    head = c[t + 1] / (t + 1)                       # mean(x[:t+1])
    if method == "backward":
        lo = np.maximum(t - k, 0)
        s = np.where(t < k, head, (c[t] - c[lo]) / k)
    else:
        hw = k // 2
        lo = np.maximum(t - hw, 0)
        hi = np.minimum(t + hw, n)
        body = (c[hi] - c[lo]) / np.maximum(hi - lo, 1)  # mean(x[t-hw:t+hw])
        tail = (c[n] - c[lo]) / np.maximum(n - lo, 1)    # mean(x[t-hw:])
        s = np.where(t < hw, head, np.where(t < n - hw, body, tail))
    return np.clip(s, 0, 1)


def startup_suppression(probs: np.ndarray, n_samples: int) -> np.ndarray:
    """Zero p >= 0.5 within the first second of the shot (reference
    src/utils/utility.py:957-960): the plasma-startup flash false positive."""
    out = probs.copy()
    head = out[:n_samples]
    head[head >= 0.5] = 0.0
    out[:n_samples] = head
    return out


def bucket_len(n: int) -> int:
    """Sub-octave shape bucket: smallest of {2^k, 1.25*2^k, 1.5*2^k} >= n
    (padding waste at most 33%)."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    for b in (5 * p // 8, 3 * p // 4, p):
        if b >= n:
            return b
    return p


def chunkify_starts(starts: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad window starts to a sub-octave chunk-count bucket (bucket_len) and
    reshape to (n_buck, B)."""
    n = len(starts)
    n_chunks = max((n + batch_size - 1) // batch_size, 1)
    n_buck = bucket_len(n_chunks)
    padded = np.zeros(n_buck * batch_size, np.int64)
    padded[:n] = starts
    return padded.reshape(n_buck, batch_size)


def video_encoder(model):
    """The ViViT encoder a spatial-cls table is built from: the model's
    first ``ViViTEncoder`` (a bare ViViT's ``encoder``, a fusion model's
    ``encoder_video`` or ``vis_model.encoder``); None for a model without
    one."""
    from ..models.vivit import ViViTEncoder

    return next((m for m in model.modules() if isinstance(m, ViViTEncoder)), None)


def _make_cls_table_fn(model, seq_len: int, crop_size: int, compute_dtype,
                       device, use_fused: Optional[bool] = None):
    """``tokens (T, N-1, D) -> (L, T, D)`` spatial-cls-table closure, and
    whether it runs the kernel: the window loop's (``_WindowLoop``).

    The widths come from the ViViT encoder the table is built from
    (``video_encoder``). ``use_fused`` is tri-state, as in the JAX sweep:
    ``None`` takes ``spatial_table`` when the kernel takes the shape
    (``kernel_refusal``, checked without a launch at the crop's N tokens,
    the cls row included) and ``spatial_table_reference`` on the same device
    otherwise; ``True`` takes ``spatial_table`` and raises for a shape the
    kernel refuses; ``False`` always takes the plain version.
    ``spatial_table`` launches the CUDA kernel on a GPU and runs the plain
    version on the CPU."""
    enc = video_encoder(model)
    st = enc.space_transformer
    depth, n_heads, d_head = st.depth, st.attn_0.n_heads, st.attn_0.d_head
    mlp = st.ff1_0.weight.shape[0]
    n_tokens = (crop_size // enc.patch_size) ** 2 + 1
    weights = extract_spatial_weights(enc, seq_len, depth=depth, dtype=compute_dtype)
    fused = use_fused is not False
    if fused:
        refusal = kernel_refusal(1, n_tokens, enc.dim, depth, n_heads, d_head, mlp,
                                 compute_dtype, device, weights)
        if refusal is not None:
            if use_fused:
                raise ValueError(
                    f"spatial_table: shape not supported by the CUDA kernel (N "
                    f"{n_tokens}, D {enc.dim}, depth {depth}, {n_heads} heads x "
                    f"{d_head}, mlp {mlp}, {compute_dtype}): {refusal}")
            fused = False
    table_fn = spatial_table if fused else spatial_table_reference

    def cls_table(tokens):
        tokens_cls = torch.nn.functional.pad(tokens, (0, 0, 1, 0))  # zero cls row
        return table_fn(tokens_cls, weights, seq_len, depth=depth, n_heads=n_heads,
                        d_head=d_head, compute_dtype=compute_dtype)

    return cls_table, fused


def window_rows(table: torch.Tensor, chunks: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """(n, B * L): the row of ``table`` that each window frame of the
    (n, B) window starts ``chunks`` reads, frame start + ``offsets[k]`` at
    offset k, clamped to the table; the rows of ``table_rows(table)``. A
    3-D table is an offset-major (L, T, D) spatial-cls table, read
    flattened to (L * T, D): offset k reads clamp(start + offsets[k], 0,
    T - 1) + k * T. Any other table is R rows along its first axis (0D
    rows, raw frames): offset k reads clamp(start + offsets[k], 0, R - 1).
    The one gather of the window loop: the graph's and ``gather_windows``."""
    offset_major = table.dim() == 3
    n_rows = table.shape[1] if offset_major else table.shape[0]
    rows = torch.clamp(chunks[:, :, None] + offsets, 0, n_rows - 1)
    if offset_major:
        rows = rows + torch.arange(table.shape[0], device=rows.device) * n_rows
    return rows.view(len(chunks), -1)


def table_rows(table: torch.Tensor) -> torch.Tensor:
    """``table`` as the rows ``window_rows`` numbers: a spatial-cls table
    (L, T, D) flattened to (L * T, D), any other table as it is."""
    return table.flatten(0, 1) if table.dim() == 3 else table


def gather_windows(table: torch.Tensor, starts: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """(B, L, ...) the windows starting at ``starts`` (B,): the rows
    ``window_rows`` gives, read with one ``index_select``."""
    rows = table_rows(table)
    picked = torch.index_select(rows, 0, window_rows(table, starts[None], offsets)[0])
    return picked.view(len(starts), len(offsets), *rows.shape[1:])


class _WindowGraph(NamedTuple):
    """A captured chunk forward: ``inputs`` the (B, L, width) buffers it
    reads (the windows, and a fusion model's 0D rows), ``probs`` (B,) out,
    all fixed buffers; ``key`` what it was captured for."""
    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    probs: torch.Tensor


class _WindowLoop:
    """The window loop of ``VideoSweeper`` and ``MultiModalSweeper``:
    everything between a device-resident shot and its probabilities.

    The constructor moves the model to the device in eval mode and, for a
    model with the token path (``spatial_cls``), builds the spatial-cls
    table's route (``_make_cls_table_fn``). ``upload_shot`` crops on the
    host (``_crop``), ``embed_all`` turns a shot's frames into its table.
    ``_sweep_windows`` sweeps the windows of the model's inputs, each a
    (table, starts, offsets) triple, in padded chunks of ``batch_size``
    (``_sweep_chunks``): on the token path on a GPU one captured CUDA graph
    of ``_window_probs`` a chunk, elsewhere the sweeper's ``chunk_probs``,
    launched eagerly. Token windows are gathered through ``window_rows``
    on both paths. A sweeper adds its window offsets, ``_window_probs``
    and ``chunk_probs``. ``graph_captures`` counts the captures,
    ``graphed_chunks`` the chunks replayed."""

    def __init__(self, model, seq_len: int, crop_size: int, batch_size: int,
                 compute_dtype: torch.dtype, use_fused_table: Optional[bool], device):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.seq_len, self.crop_size = seq_len, crop_size
        self.batch_size, self.compute_dtype = batch_size, compute_dtype
        # uint8 values and the integer channel means are exact in bf16, so
        # normalising directly in the compute dtype is lossless
        self._mean = torch.tensor(PIXEL_MEAN_BGR, dtype=compute_dtype, device=self.device)
        self._use_tokens = hasattr(model, "spatial_cls")
        self.fused_table_active = False
        if self._use_tokens:
            self._cls_table, self.fused_table_active = _make_cls_table_fn(
                self.model, seq_len, crop_size, compute_dtype, self.device, use_fused_table)
        self._shot = 0        # shots through embed_all: the sweep spans' ``shot``
        self._graph: Optional[_WindowGraph] = None
        self.graph_captures = self.graphed_chunks = 0

    def _crop(self, frames_u8: np.ndarray) -> np.ndarray:
        """(T, H, W, C) frames centre-cropped on the host, contiguous."""
        return np.ascontiguousarray(center_crop(frames_u8, self.crop_size))

    @torch.no_grad()
    def embed_tokens(self, frames_dev: torch.Tensor) -> torch.Tensor:
        """(T, h, w, C) uint8 on the device -> (T, N-1, D) patch embeddings."""
        return self.model.embed_frames(frames_dev.to(self.compute_dtype) - self._mean)

    @torch.no_grad()
    def embed_all(self, frames_dev: torch.Tensor) -> torch.Tensor:
        """Per-shot preprocessing: the (L, T, D) spatial-cls table (token
        path), or the frames themselves for a model without it. Starts the
        next shot of the spans (``sweep.embed``, ``sweep.table``)."""
        self._shot += 1
        if not self._use_tokens:
            return frames_dev
        with span("sweep.embed", shot=self._shot, frames=frames_dev.shape[0]):
            tokens = self.embed_tokens(frames_dev)
        with span("sweep.table", shot=self._shot, fused=self.fused_table_active):
            return self._cls_table(tokens)

    @torch.no_grad()
    def _sweep_windows(self, inputs) -> np.ndarray:
        """p_disrupt of every window of ``inputs``, one (table, starts,
        offsets) triple per model input, the starts host arrays of one
        length, in a ``sweep.windows`` span: ``windows`` real,
        ``dispatched`` in ``chunks`` padded chunks (``chunkify_starts``,
        the inputs' chunks up in one copy), ``graphed`` of them replayed as
        a graph."""
        tables, starts, offsets = zip(*inputs)
        n = len(starts[0])
        if n == 0:
            return np.zeros(0, np.float32)
        with span("sweep.windows", shot=self._shot, windows=n) as sp:
            chunks = torch.from_numpy(np.stack([
                chunkify_starts(np.asarray(s, np.int64), self.batch_size) for s in starts
            ])).to(self.device)
            graphed = self.graphed_chunks
            probs = self._sweep_chunks(tables, chunks, offsets).cpu().numpy()[:n]
            sp.set(dispatched=chunks[0].numel(), chunks=chunks.shape[1],
                   graphed=self.graphed_chunks - graphed)
            return probs

    def _sweep_chunks(self, tables, chunks, offsets) -> torch.Tensor:
        """(n_buck * B,) p_disrupt over ``tables``, one per model input,
        each with its (n_buck, B) window starts ``chunks`` on the device and
        its window ``offsets``; each chunk's launches in a ``sweep.chunk``
        span. Eagerly a chunk is the sweeper's ``chunk_probs``, its span
        carrying the conv epilogues it ran (``epilogues``) and how many of
        them ran as one kernel pass (``fused_epilogues``, ``ops/bn_act.py``'s
        counters). With a
        window graph it is the gather of each input's ``window_rows`` into
        the graph's input (one ``index_select`` each), the replay and the
        copy of its probabilities out."""
        graph = self._window_graph(tables)
        if graph is None:
            out = []
            for starts in zip(*chunks):
                with span("sweep.chunk", shot=self._shot) as sp:
                    fused, eager = bn_act.fused, bn_act.eager
                    out.append(self.chunk_probs(*tables, *starts))
                    sp.set(epilogues=bn_act.fused + bn_act.eager - fused - eager,
                           fused_epilogues=bn_act.fused - fused)
            return torch.cat(out)
        rows = [window_rows(*i) for i in zip(tables, chunks, offsets)]
        flat = [table_rows(table) for table in tables]
        bufs = [b.view(-1, t.shape[-1]) for t, b in zip(flat, graph.inputs)]
        out = torch.empty((len(rows[0]), self.batch_size), dtype=torch.float32,
                          device=self.device)
        for c in range(len(out)):
            with span("sweep.chunk", shot=self._shot):
                for table, buf, r in zip(flat, bufs, rows):
                    torch.index_select(table, 0, r[c], out=buf)
                graph.graph.replay()
                out[c].copy_(graph.probs)
        self.graphed_chunks += len(out)
        return out.view(-1)

    def _window_graph(self, tables) -> Optional[_WindowGraph]:
        """The chunk forward captured as a CUDA graph over inputs as wide as
        ``tables`` and of their dtypes, for the token path on a GPU; None
        elsewhere. Captured at first use, and again when a table's width or
        dtype or the storage (or shape) of a parameter or buffer changed;
        the graph reads the weights in place, so a weight updated in place
        is seen at the next replay."""
        if not self._use_tokens or self.device.type != "cuda":
            return None
        key = tuple((t.dtype, t.shape[-1]) for t in tables) + storage_key(self.model)
        if self._graph is None or self._graph.key != key:
            self._graph = None                   # the old graph's pool goes first
            self._graph = self._capture(key, tables)
        return self._graph

    @torch.no_grad()
    def _capture(self, key: tuple, tables) -> _WindowGraph:
        """Warm up and capture ``_window_probs`` on the capture stream
        (``utils/graphs.py``) over fixed (B, L, width) inputs. The warm-up
        makes what the forward makes once (cuBLAS handles and workspaces,
        the 0D encoder's position table) outside the capture."""
        inputs = tuple(torch.zeros(self.batch_size, self.seq_len, t.shape[-1], dtype=t.dtype,
                                   device=self.device) for t in tables)
        with on_capture_stream(self.device):
            for _ in range(2):
                self._window_probs(*inputs)
        graph = torch.cuda.CUDAGraph()
        with capture(graph, self.device):
            probs = self._window_probs(*inputs)
        self.graph_captures += 1
        return _WindowGraph(key, graph, inputs, probs)


class VideoSweeper(_WindowLoop):
    """Stride-1 sliding-window sweep over device-resident frames.

    The shot is cropped and uploaded once; per chunk of B windows the sweep
    gathers the windows on the device, runs the forward and takes the
    disruption probability softmax[:, 0]. ``device=None`` means the GPU
    (raising without one); the model is moved to ``device``.
    ``use_fused_table`` chooses the spatial-cls table's route
    (``_make_cls_table_fn``): ``None`` the kernel where it takes the shape
    and the plain version otherwise, ``True`` the kernel or an error,
    ``False`` the plain version; ``fused_table_active`` says which one the
    sweeper took. A model without the token path (the conv models) gathers
    raw windows per chunk with the window-gather kernel.

    On a GPU the token path replays a captured CUDA graph per chunk
    (``_WindowLoop``); the raw-frame path and the CPU launch eagerly.
    ``graph_captures`` counts the captures, ``graphed_chunks`` the chunks
    replayed.
    """

    def __init__(self, model, seq_len: int, crop_size: int, batch_size: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_table: Optional[bool] = None, device=None, mesh=None):
        super().__init__(model, seq_len, crop_size, batch_size, compute_dtype,
                         use_fused_table, mesh.device if mesh is not None else device)
        self.mesh = mesh     # sweep_shots splits the shot axis over its data ranks
        # window s covers frames [s+1, s+L]: frame s+1+k sits at offset k
        self._offsets = torch.arange(1, seq_len + 1, device=self.device)
        self._frames_dev = None

    def _window_probs(self, windows: torch.Tensor) -> torch.Tensor:
        """p_disrupt of (B, L, D) gathered spatial-cls windows."""
        return torch.softmax(self.model.forward_spatial_cls(windows).float(), dim=-1)[:, 0]

    @torch.no_grad()
    def chunk_probs(self, data: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """p_disrupt for the windows starting at ``starts`` (B,), launched
        eagerly."""
        if self._use_tokens:
            return self._window_probs(gather_windows(data, starts, self._offsets))
        # raw frames: the window-gather kernel (ops/preprocess.py)
        logits = self.model(gather_normalize(data, starts, self.seq_len,
                                             self.compute_dtype))  # (B, L, h, w, C)
        return torch.softmax(logits.float(), dim=-1)[:, 0]

    def sweep_table(self, data: torch.Tensor, starts: np.ndarray) -> np.ndarray:
        """All windows over preprocessed ``data`` (``embed_all``'s output),
        in a ``sweep.windows`` span: ``windows`` real, ``dispatched`` in
        ``chunks`` padded chunks, ``graphed`` of them replayed as a graph."""
        return self._sweep_windows(((data, starts, self._offsets),))

    def load_shot(self, frames_u8: np.ndarray) -> torch.Tensor:
        """Crop, upload once and preprocess (ViViT: embed + cls table)."""
        self._frames_dev = self.embed_all(self.upload_shot(frames_u8))
        return self._frames_dev

    def sweep(self, frames_u8: Optional[np.ndarray], starts: np.ndarray) -> np.ndarray:
        """Run all window starts; returns p_disrupt per window. Pass
        frames_u8=None to reuse the previously loaded shot."""
        if frames_u8 is not None:
            self.load_shot(frames_u8)
        return self.sweep_table(self._frames_dev, starts)

    def upload_shot(self, frames_u8: np.ndarray) -> torch.Tensor:
        """Centre-crop on the host and upload the raw uint8 frames."""
        return torch.from_numpy(self._crop(frames_u8)).to(self.device)

    def sweep_device(self, frames_dev: torch.Tensor, starts: np.ndarray) -> np.ndarray:
        """Whole-shot sweep including the per-shot preprocessing (embedding
        + spatial table) over device-resident cropped frames."""
        if len(starts) == 0:
            return np.zeros(0, np.float32)
        return self.sweep_table(self.embed_all(frames_dev), starts)

    def _hbm_budget_bytes(self) -> int:
        """Bytes the library stack may occupy in device memory: half the
        free device memory, floored at 512 MB; 4 GB on the CPU (grouping
        granularity only)."""
        if self.device.type != "cuda":
            return 4 << 30
        free, _ = torch.cuda.mem_get_info(self.device)
        return max(free // 2, 512 << 20)

    @torch.no_grad()
    def _sweep_group(self, cropped_list, starts_list, s_pad: int = 0) -> list:
        """One upload and one download for a group of already-cropped shots:
        pad to the group's half-octave frame/chunk buckets (plus ``s_pad``
        repeats of the last shot so groups share one shape), stack, sweep
        the real shots one by one on the device, slice.

        Spans: ``library.prep`` (pad and stack on the host), ``library.h2d``
        (the two stacks' uploads: ``bytes``, and ``frames`` and ``chunks``,
        the stacks' shapes) and ``library.sweep`` (the ``shots`` real shots'
        sweeps and the fetch)."""
        with span("library.prep"):
            if s_pad:
                cropped_list = list(cropped_list) + [cropped_list[-1]] * s_pad
                starts_list = list(starts_list) + [starts_list[-1]] * s_pad
            S, n_real = len(cropped_list), len(cropped_list) - s_pad
            B = self.batch_size
            t_buck = bucket_len(max(len(f) for f in cropped_list))
            n_buck = max(bucket_len(max((len(s) + B - 1) // B, 1))
                         for s in starts_list)

            frames_stack = np.empty((S, t_buck) + cropped_list[0].shape[1:], np.uint8)
            chunks_stack = np.zeros((S, n_buck * B), np.int64)
            for i, (cropped, starts) in enumerate(zip(cropped_list, starts_list)):
                frames_stack[i, :len(cropped)] = cropped
                frames_stack[i, len(cropped):] = cropped[-1]      # repeat the last frame
                chunks_stack[i, :len(starts)] = starts
            chunks_stack = chunks_stack.reshape(S, n_buck, B)
        with span("library.h2d", bytes=frames_stack.nbytes + chunks_stack.nbytes,
                  frames=frames_stack.shape, chunks=chunks_stack.shape):
            fd = torch.from_numpy(frames_stack).to(self.device)
            cd = torch.from_numpy(chunks_stack).to(self.device)
        with span("library.sweep", shots=n_real):
            probs = torch.stack([self._sweep_chunks((self.embed_all(fd[i]),), cd[i][None],
                                                    (self._offsets,))
                                 for i in range(n_real)]).cpu().numpy()
        return [probs[i, :len(starts_list[i])] for i in range(n_real)]

    def sweep_shots(self, frames_list, starts_list,
                    hbm_budget_bytes: Optional[int] = None) -> list:
        """Sweep a whole shot library: shots are cropped on the host, grouped
        so that a group's stacked frames fit the device-memory budget (half
        the free memory by default: stacking hundreds of full-length shots
        unconditionally runs out of memory by construction), and each group
        is uploaded in one transfer — shots padded to a common half-octave
        frame bucket (repeating the last frame) and chunk bucket — swept on
        the device, and the per-shot probability arrays sliced back out.

        Groups are a FIXED size (budget // the library's largest frame
        bucket, capped at bucket_len(S)); a partial final group repeats its
        last shot up to its own shot-count bucket. Shots are packed in
        ascending length order so a group shares a tight frame bucket, and
        the fixed shot count keeps the set of group shapes small. Results
        return in input order.

        With a ``mesh`` the shot axis is split over its data ranks: the list
        is padded to a multiple of the data-axis size by repeating its last
        shot, each rank sweeps its contiguous block as above (its own
        tables or window gathers), and the curves are all-gathered in shot
        order, the padding dropped (JAX's ``shard_map`` over the stack)."""
        S = len(frames_list)
        if S == 0:
            return []
        if self.mesh is not None:
            d, i = self.mesh.shape["data"], self.mesh.data_index
            pad = (-S) % d
            frames_list = list(frames_list) + [frames_list[-1]] * pad
            starts_list = list(starts_list) + [starts_list[-1]] * pad
            per = len(frames_list) // d
            mine = self._sweep_library(frames_list[i * per:(i + 1) * per],
                                       starts_list[i * per:(i + 1) * per],
                                       hbm_budget_bytes)
            parts = all_gather_objects(mine, self.mesh.data_group, d)
            return [p for part in parts for p in part][:S]
        return self._sweep_library(frames_list, starts_list, hbm_budget_bytes)

    def _sweep_library(self, frames_list, starts_list, hbm_budget_bytes) -> list:
        S = len(frames_list)
        if S == 0:
            return []
        cropped_list = [self._crop(frames_u8) for frames_u8 in frames_list]

        budget = hbm_budget_bytes or self._hbm_budget_bytes()
        itembytes = self.crop_size * self.crop_size * 3
        max_buck = max(bucket_len(len(c)) for c in cropped_list)
        s_chunk = max(min(int(budget // (max_buck * itembytes)),
                          bucket_len(S)), 1)
        order = sorted(range(S), key=lambda i: len(cropped_list[i]))
        groups = [order[i:i + s_chunk] for i in range(0, S, s_chunk)]

        out: list = [None] * S
        for g in groups:
            target = s_chunk if len(g) == s_chunk else min(
                bucket_len(len(g)), s_chunk)
            probs = self._sweep_group([cropped_list[i] for i in g],
                                      [starts_list[i] for i in g],
                                      s_pad=target - len(g))
            for i, p in zip(g, probs):
                out[i] = p
        return out


def predict_video_shot(
    model,
    frames_u8: np.ndarray,        # (T, H, W, C) the full shot
    frame_srt: int,
    frame_end: int,
    seq_len: int = 21,
    dist: int = 3,
    crop_size: int = 128,
    batch_size: int = 64,
    fps: float = FPS,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-shot video probability curve (reference generate_prob_curve).

    Returns (time_x, prob): prob[i] is the disruption probability at frame
    i. ``device=None`` means the GPU."""
    # reference slices paths[frame_srt : frame_end + 210]
    sub = frames_u8[frame_srt: frame_end + int(fps)]
    n_windows = max(len(sub) - seq_len - dist, 0)
    starts = np.arange(n_windows, dtype=np.int64)

    sweeper = VideoSweeper(model, seq_len, crop_size, batch_size, compute_dtype,
                           device=device)
    probs = sweeper.sweep(sub, starts)

    prob_list = np.concatenate([
        np.zeros(seq_len + frame_srt, np.float32),
        probs[1:-1] if len(probs) > 2 else probs[:0],
    ])
    prob_list = startup_suppression(prob_list, int(fps * 1))
    time_x = np.arange(len(prob_list)) / fps
    return time_x, prob_list


class TSSweeper:
    """Stride-1 sweep of a 0D model over a device-resident shot table: the
    table is uploaded once, each chunk of ``batch_size`` windows is gathered
    on the device with clipped indices (window s covers rows
    s+1 .. s+tau*(seq_len-1)+1), and the sweep returns softmax[:, 0] cut to
    the window count. The model runs in its own compute dtype.
    ``device=None`` means the GPU (raising without one)."""

    def __init__(self, model, seq_len: int, batch_size: int = 256, tau: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self._offsets = 1 + tau * torch.arange(seq_len, device=self.device)

    @torch.no_grad()
    def chunk_probs(self, data: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        logits = self.model(gather_windows(data, starts, self._offsets))
        return torch.softmax(logits.float(), dim=-1)[:, 0]

    def sweep(self, data: np.ndarray, starts: np.ndarray) -> np.ndarray:
        """p_disrupt of every window start over a (T, F) table."""
        n = len(starts)
        if n == 0:
            return np.zeros(0, np.float32)
        data_dev = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(self.device)
        chunks = torch.from_numpy(chunkify_starts(starts, self.batch_size)).to(self.device)
        probs = torch.cat([self.chunk_probs(data_dev, c) for c in chunks])
        return probs.cpu().numpy()[:n]


def predict_0d_shot(
    model,
    shot_values: np.ndarray,      # (T, F) raw (unscaled) shot table values
    times: np.ndarray,            # (T,) time column
    scaler,                       # Scaler; refit on this shot (reference quirk,
                                  # utility.py:499 fit_transform even when given)
    seq_len: int = 21,
    dist: int = 3,
    dt: float = 4.0 / 210.0,
    batch_size: int = 256,
    fps: float = FPS,
    smooth_k: int = 12,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-shot 0D probability curve on the frame grid (reference
    generate_prob_curve_from_0D, src/utils/utility.py:979-1066): stride-1
    windows, pad, suppress, linearly re-interpolate to the frame rate,
    backward moving average. Returns (time_x, prob); ``device=None`` means
    the GPU."""
    from ..data.splits import Scaler

    sc = Scaler(scaler.kind if scaler is not None else "Robust").fit(shot_values)
    data = sc.transform(shot_values)

    n_windows = max(len(data) - seq_len - dist, 0)
    starts = np.arange(n_windows, dtype=np.int64)
    probs = TSSweeper(model, seq_len, batch_size, device=device).sweep(data, starts)

    interval = int(round(dt * fps))
    frame_srt = int(float(times[0]) * fps / interval)
    prob_list = np.concatenate([
        np.zeros(frame_srt + seq_len, np.float32),
        probs[1:] if len(probs) > 1 else probs[:0],
        np.zeros(seq_len, np.float32),
    ])
    prob_list = startup_suppression(prob_list, int(fps * 1))

    # linear re-interpolation from the dt grid to the frame grid
    n = len(prob_list)
    prob_x = np.linspace(0, n, num=n, endpoint=True) * (interval / fps)
    fine_x = np.linspace(0, n * interval, num=n * interval, endpoint=True) / fps
    fine = moving_average(np.interp(fine_x, prob_x, prob_list), smooth_k, "backward")
    return np.arange(len(fine)) / fps, fine


class MultiModalSweeper(_WindowLoop):
    """Paired video + 0D window sweep for the fusion models, the multimodal
    counterpart of ``VideoSweeper``. ``upload_shot`` edge-replicates frame
    and 0D row counts up to their half-octave buckets and the chunk counts
    are bucketed (``chunkify_starts``), as in the JAX sweeper, so a library
    sweep sees a handful of shapes.

    A model with ``spatial_cls`` takes the fast path: the shot's (L, T, D)
    spatial-cls table is built once (``_make_cls_table_fn``: the
    spatial-table kernel where it takes the shape, ``use_fused_table`` as
    in ``VideoSweeper``, ``fused_table_active`` reports the route), and each
    window runs only the temporal transformer, the 0D encoder and the
    fusion head (``forward_spatial_cls``). On a GPU that path replays a
    captured CUDA graph per chunk (``_WindowLoop``), the windows and the 0D
    rows gathered into its two inputs; ``graph_captures`` counts the
    captures, ``graphed_chunks`` the chunks replayed. Another model takes
    raw frames, gathered through the same ``window_rows``, and launches
    eagerly, as the CPU does. ``device=None`` means the GPU.

    ``sweep_device`` sweeps a shot already on the device in its two
    halves, ``embed_all`` (spans ``sweep.embed``, ``sweep.table``) and
    ``sweep_table`` (``sweep.windows`` around one ``sweep.chunk`` a chunk),
    the spans ``VideoSweeper`` records."""

    def __init__(self, model, seq_len: int, tau: int = 1, crop_size: int = 128,
                 batch_size: int = 32, compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_table: Optional[bool] = None, device=None):
        super().__init__(model, seq_len, crop_size, batch_size, compute_dtype,
                         use_fused_table, device)
        self.tau = tau
        # the video window ends at v+1 (frames v+1-tau*(L-1) .. v+1, reference
        # paths[idx+1 : idx-tau*L+1 : -tau][::-1]); the 0D window ends at t
        back = tau * torch.arange(seq_len - 1, -1, -1, device=self.device)
        self._offsets, self._t_offsets = 1 - back, -back

    @staticmethod
    def _pad_bucket(arr: np.ndarray) -> np.ndarray:
        """Edge-replicate to the half-octave shape bucket (bucket_len)."""
        buck = bucket_len(len(arr))
        if len(arr) < buck:
            arr = np.concatenate([arr, np.repeat(arr[-1:], buck - len(arr), axis=0)])
        return arr

    def upload_shot(self, frames_u8: np.ndarray, data: np.ndarray):
        """Crop the frames (T, H, W, C) uint8 on the host, edge-replicate
        them and the scaled 0D rows (R, F) to their buckets, upload both."""
        cropped = self._pad_bucket(self._crop(frames_u8))
        rows = self._pad_bucket(np.ascontiguousarray(data, dtype=np.float32))
        return (torch.from_numpy(cropped).to(self.device),
                torch.from_numpy(rows).to(self.device))

    @torch.no_grad()
    def load_shot(self, frames_u8: np.ndarray, data: np.ndarray):
        """Upload a shot (``upload_shot``) and preprocess its frames
        (``embed_all``). Returns the device pair ``sweep_table`` reads
        before its ladders."""
        frames_dev, rows_dev = self.upload_shot(frames_u8, data)
        return self.embed_all(frames_dev), rows_dev

    def _window_probs(self, windows: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """p_disrupt of (B, L, D) spatial-cls windows paired with (B, L, F)
        0D rows."""
        return torch.softmax(self.model.forward_spatial_cls(windows, rows).float(),
                             dim=-1)[:, 0]

    @torch.no_grad()
    def chunk_probs(self, video: torch.Tensor, rows: torch.Tensor,
                    v_starts: torch.Tensor, t_starts: torch.Tensor) -> torch.Tensor:
        """p_disrupt of the paired windows ending at ``v_starts`` + 1 and
        ``t_starts`` (B,), indices clipped to the table, launched eagerly."""
        windows = gather_windows(video, v_starts, self._offsets)
        samples = gather_windows(rows, t_starts, self._t_offsets)
        if self._use_tokens:
            return self._window_probs(windows, samples)
        out = self.model(windows.to(self.compute_dtype) - self._mean, samples)
        logits = out[0] if isinstance(out, tuple) else out
        return torch.softmax(logits.float(), dim=-1)[:, 0]

    def sweep_table(self, video: torch.Tensor, rows: torch.Tensor, video_keep,
                    ts_keep) -> np.ndarray:
        """All paired windows over ``embed_all``'s output and the (R, F) 0D
        rows on the device -> p_disrupt each, in a ``sweep.windows`` span:
        ``windows`` real, ``dispatched`` in ``chunks`` padded chunks,
        ``graphed`` of them replayed as a graph. The two ladders' chunks go
        up in one copy."""
        return self._sweep_windows(((video, video_keep, self._offsets),
                                    (rows, ts_keep, self._t_offsets)))

    def sweep_device(self, frames_dev: torch.Tensor, rows_dev: torch.Tensor, video_keep,
                     ts_keep) -> np.ndarray:
        """Whole-shot paired sweep over device-resident cropped uint8 frames
        (T, h, w, C) and scaled 0D rows (R, F), with their matched
        window-end ladders: the per-shot preprocessing (``embed_all``) and
        the window loop (``sweep_table``)."""
        if len(video_keep) == 0:
            return np.zeros(0, np.float32)
        return self.sweep_table(self.embed_all(frames_dev), rows_dev, video_keep, ts_keep)

    def sweep(self, frames_u8: np.ndarray, data: np.ndarray, video_keep,
              ts_keep) -> np.ndarray:
        """Paired sweep: frames (T, H, W, C) uint8, data (R, F) scaled 0D
        rows, matched window-end ladders -> p_disrupt per window."""
        if len(video_keep) == 0:
            return np.zeros(0, np.float32)
        return self.sweep_device(*self.upload_shot(frames_u8, data), video_keep, ts_keep)


def multimodal_ladders(times: np.ndarray, frame_srt: int, frame_end: int,
                       t_srt: float, t_end: float, seq_len: int, dt: float,
                       tau: int):
    """Backward-matched stride-tau index ladders (reference utility.py:583-611).

    ts_idx_end is clamped to the last valid row: when no 0D sample lies
    beyond t_end the reference's formula yields len(times) itself, which the
    time-axis reconstruction would then index out of bounds."""
    video_indices = list(reversed(range(frame_end, frame_srt, -tau)))
    ts_idx_end = min(len(times) - int(np.sum(times > t_end)), len(times) - 1)
    ts_idx_start = int(t_srt / dt)
    ts_indices = list(reversed(range(ts_idx_end, ts_idx_start, -tau)))

    if len(video_indices) > len(ts_indices):
        video_indices = video_indices[-len(ts_indices):]
    elif len(video_indices) < len(ts_indices):
        ts_indices = ts_indices[-len(video_indices):]

    video_keep = [i for i in video_indices if i > seq_len * tau]
    ts_keep = [i for i in ts_indices if i > seq_len * tau]
    m = min(len(video_keep), len(ts_keep))
    return video_keep[-m:] if m else [], ts_keep[-m:] if m else []


def predict_multimodal_shot(
    model,
    frames_u8: np.ndarray,
    shot_values: np.ndarray,
    times: np.ndarray,
    scaler,
    frame_srt: int,
    frame_end: int,
    t_srt: float,
    t_end: float,
    seq_len: int = 21,
    dist: int = 3,
    dt: float = 1.0 / 210.0,
    tau: int = 1,
    crop_size: int = 128,
    batch_size: int = 32,
    fps: float = FPS,
    compute_dtype: torch.dtype = torch.bfloat16,
    sweeper: Optional[MultiModalSweeper] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-shot multimodal curve (reference generate_prob_curve_from_multi,
    src/utils/utility.py:1068-1178). Returns (time_x, prob).

    ``dist`` is accepted for signature parity and does not shift the
    ladders: the reference's inference dataset stores it and never uses it
    when matching indices. ``scaler`` None refits a robust scaler on the
    shot. Pass a built ``sweeper`` to share it across shots (as
    ``eval.alarms.sweep_multimodal_prob_curves`` does); ``device=None``
    means the GPU."""
    from ..data.splits import Scaler

    if scaler is None:
        data = Scaler("Robust").fit(shot_values).transform(shot_values)
    else:
        data = scaler.transform(shot_values)

    video_keep, ts_keep = multimodal_ladders(
        times, frame_srt, frame_end, t_srt, t_end, seq_len, dt, tau)
    if not video_keep:
        return np.zeros(0), np.zeros(0)

    if sweeper is None:
        sweeper = MultiModalSweeper(model, seq_len, tau, crop_size, batch_size,
                                    compute_dtype, device=device)
    probs = sweeper.sweep(frames_u8, data, video_keep, ts_keep)

    # piecewise time-axis reconstruction (reference utility.py:1136-1160)
    t_first = float(times[ts_keep[0]])
    interval = tau
    dt_end = 1.0
    head = np.zeros(int(t_first * fps / interval), np.float32)
    tail = np.zeros(int(dt_end * fps / interval), np.float32)
    total = np.concatenate([head, probs[1:], tail])
    total = startup_suppression(total, int(fps / interval))

    x_head = np.arange(len(head)) * interval / fps
    x_rest = ((x_head[-1] if len(x_head) else 0.0)
              + (np.arange(len(total) - len(head)) + 1) * interval / fps)
    prob_x = np.concatenate([x_head, x_rest])
    t_last = float(times[ts_keep[-1]])
    fine_x = np.linspace(0, t_last + dt_end, num=len(total) * interval, endpoint=True)
    fine = np.interp(fine_x, prob_x, total)
    return fine_x, moving_average(fine, 16, "center")


# ---------------------------------------------------------------------------
# Alarm logic
# ---------------------------------------------------------------------------

def alarm_times(time_x: np.ndarray, probs: np.ndarray, threshold: float = 0.5,
                t_min: float = 1.0, min_dwell_s: float = 0.0) -> Optional[float]:
    """First time the disruption probability crosses the threshold after the
    startup window (reference utility.py:843-853).

    ``min_dwell_s > 0`` trips the alarm at the END of the first run of
    samples that stays above threshold for ``min_dwell_s`` of continuous
    armed time (``time_x >= t_min``), counted on a uniform time grid (one
    median dt). ``min_dwell_s = 0`` is the reference first-crossing rule."""
    mask = (probs > threshold) & (time_x >= t_min)
    if not mask.any():
        return None
    if min_dwell_s > 0.0:
        if len(time_x) <= 1:
            # a single sample cannot hold a positive continuous dwell
            return None
        dt = float(np.median(np.diff(time_x)))
        # ceil so the continuous armed time (k-1)*dt >= min_dwell_s; the
        # 1e-9 guard keeps exact multiples from ceiling up on float noise
        k = int(np.ceil(min_dwell_s / dt - 1e-9)) + 1 if dt > 0 else 1
        if k > 1:
            if k > len(mask):
                return None
            runs = np.convolve(mask.astype(np.int64),
                               np.ones(k, np.int64), "valid")
            hits = np.flatnonzero(runs == k)
            return float(time_x[hits[0] + k - 1]) if len(hits) else None
    return float(time_x[int(np.argmax(mask))])


def warning_time(t_alarm: Optional[float], t_current_quench: float) -> Optional[float]:
    """Warning margin: how long before the current quench the alarm fired."""
    if t_alarm is None:
        return None
    return t_current_quench - t_alarm
