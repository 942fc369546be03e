// Spatial-cls table kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kstar_tpu/ops/spatial_table.py
// `spatial_table` / `_kernel` (attn_mode="batched"). For every in-window
// offset o and frame t it runs the whole pre-norm spatial transformer of
// ViViT over the frame's N tokens (x = tokens[t] + base[o]) and keeps the
// final-LayerNorm cls row: out[o, t, :]. Per layer:
//   LN -> qkv -> per-head softmax(q k^T * scale) v -> out-proj + bias ->
//   residual -> LN -> FF1 + bias -> tanh-GELU -> FF2 + bias -> residual.
// The cast points follow the JAX kernel: LayerNorm and softmax in f32,
// products accumulated in f32 and rounded to the operand type T, biases and
// residuals added in T.
//
// What bounds it: at the flagship widths (N 65, D 128, 4 heads x 64, MLP
// 1024, 21 offsets) a 4096-frame shot is ~10 TFLOP against ~90 MB of tokens
// in and table out, so it is bound by operations (the bf16 tensor cores'
// 989 TFLOP/s). Short of that peak a block loses time in four places: the
// shared-memory rate that feeds the tensor cores (128 bytes a clock per
// SM), block barriers between products too small to hide them, the work
// outside the tensor cores (GELU, softmax, LayerNorm, residuals), and the
// weights (1.7 MB for two layers), which every block streams from L2.
//
// Three hand-written instances, chosen by shape and type in the C launcher
// (spatial_table_plan), as the window-gather kernel chooses its aligned and
// unaligned ones:
//
//  * fast (bf16), one design compiled for two widths (the Shape template
//    below): the flagship's D 128 / d_head 64 with an MLP a multiple of 128
//    (64 past N 144), and the demo ViViT's D 64 / d_head 32 with an MLP a
//    multiple of 64. Up to N 80 one block owns F neighbouring frames of one
//    offset,
//    their tokens packed without padding into rows of shared memory (F = 2
//    at N 65 and 8 at N 17 for the flagship; 7 at N 17 for the demo), so
//    every weight panel is fetched once per F frames and a barrier is paid
//    once per F frames. T that is no multiple of F is masked at the edge.
//    - The row-wise products (qkv, out-projection, FF1, FF2: 92% of the
//      operations) run on wgmma.m64n64k16 (m64n32k16 for a 32-wide head's
//      v) for rows 0..127 (two warpgroups; A fragments from ldmatrix,
//      loaded once per product, B straight from the weight panel through a
//      matrix descriptor: the panel is read from shared memory once per
//      warpgroup, not once per warp). The flagship adds rows 128..143 on
//      mma.sync (a third warpgroup, B fragments from the same panel through
//      ldmatrix): 2 x 64 + 16 = 144 rows hold two frames of 65 tokens with
//      14 rows to spare, where three 64-row wgmma tiles would spend a third
//      of the tensor time on padding.
//    - Attention goes through the register-resident core of attn_core.cuh,
//      one warp per (frame, 16-query strip), compiled per count of key
//      tiles: scores and probabilities never touch shared memory, and a
//      frame's padding keys (the next frame's rows) are masked in the
//      fragments.
//    - The out-projection (over heads) and FF2 (over MLP chunks) accumulate
//      in registers and are rounded once; bias pairs are loaded ahead of
//      each epilogue.
//    - The wrapper packs the weights in the order the kernel consumes them,
//      each panel contiguous in the blocked layout wgmma reads (wgmma.cuh),
//      so a panel is one flat cp.async copy into one of two buffers, issued
//      one product ahead; one block barrier per product covers the panel's
//      arrival, the operands' visibility and the reuse of the other buffer.
//    - The table keeps the cls row only, so the last layer computes K and V
//      for all rows and the query, attention, out-projection, LayerNorm and
//      FF for the F cls rows alone, gathered into 16-row tiles: 41% fewer
//      operations per sequence, the same arithmetic for the rows kept. That
//      layer then runs at the rate its panels stream from L2.
//    Shared memory: x, LN output, one head's q, k, v (q and k reused by the
//    MLP chunk, q's region by the cls tiles) and two panel buffers. The
//    flagship's: 221,696 bytes, 168 registers a thread (the cap at 384
//    threads), one block per SM.
//    The demo width (a 2520-frame shot is 161 GFLOP, a bound of 0.163 ms)
//    is bound by what a block pays per product, not by the tensor cores: at
//    K = 64 a product is a quarter of the flagship's tensor work behind the
//    same barrier and panel wait. So the design buys fewer barriers per
//    frame and hides the ones left: 7 frames of 17 tokens in two wgmma tiles
//    (119 of 128 rows used; four tiles would hold 15 frames, but at 160,000
//    bytes only one block would fit an SM), q and k of a head in one
//    64-column product, v on m64n32k16, the MLP in 64-column chunks (so the
//    chunk fits in q and k), 55 barriers a block of 7 frames (the general
//    instance pays ~80 a frame). The block is 92,416 bytes and 256 threads,
//    so two share an SM and one multiplies while the other waits. Its
//    weights are 256 KB for two layers, streamed from L2 once per block:
//    ~1.9 GB a 2520-frame call.
//    Past N 80, at the flagship widths (the 144 .. 256 px crops of the
//    stored 256 px frames at patch 16, up to the whole frame's 257 tokens),
//    a frame no longer packs with another, and past N 144 it no longer
//    fits one block: at N 257 the block above would need 337,920 bytes
//    (x and h of 272 rows, q, k, v of 288, two 32 KB panels) against
//    232,448. The same kernel body, with two template parameters more:
//    - N 81..144: one frame a block in the flagship's own layout (its 144
//      product rows, 160 rows of q, k, v).
//    - N 145..257: one frame over a cluster of two blocks on neighbouring
//      SMs. Block r computes the frame's rows 144 r .. 144 r + 143 in the
//      flagship's row scheme, so every product is the same 144-row product
//      (89% of its rows real at N 257), and writes each head's k and v rows
//      into its own and the other block's shared memory (mapa +
//      st.shared::cluster), so both hold the frame's 272 key rows and
//      attend from their own rows with ldmatrix as before. A cluster
//      barrier in two halves orders it: before a head's first k store the
//      other block must be done reading the last head's keys, after its v
//      both blocks' rows must have landed. The key rows leave room for
//      two 16 KB panel buffers only (221,184 bytes in all), so a head's q
//      and k are two panels and the MLP goes in chunks of 64 (more
//      barriers per row than the packed case; the stream is the same up to
//      the chunk). In the last layer only block 0's cls row is kept: block
//      1 adds its k and v rows and leaves.
//    - Attention over more than five key tiles keeps the JAX kernel's cast
//      point (P normalised, then rounded to bf16, then P V) with two
//      passes over blocks of 64 keys (attn_strip_two_pass): the first
//      takes each row's max and sum, the second recomputes the scores and
//      multiplies. Q K^T runs twice (+33% of the attention's products, 2
//      exponentials a score) so that no rounding differs from the plain
//      version's; online softmax would round the unnormalised P instead.
//    What bounds it: at N 257 a 4096-frame shot is 26.2 TFLOP (26.5 ms of
//    bf16 tensor peak) against ~0.3 GB of tokens and table; a block pays
//    the flagship's product costs, 5.1x its attention per strip (17 key
//    tiles in two passes against 5 in one) on 9 of its 12 warps, and a
//    cluster barrier pair per head.
//  * f32 (namespace tf32), at the flagship's D 128 / d_head 64 with an MLP
//    a multiple of 64, N up to 80 (the 128 px crop's 65 tokens, the 64 px
//    crop's 17) in a block, up to 257 on a cluster: a sibling of the fast
//    template rather than an instance of it, because f32 doubles every row
//    and the wgmma layout does not carry over. The order of work is the fast
//    instance's: frames packed without padding into one block of 80 rows
//    (F = 1 at N 65, 3 at N 17), the
//    weights as a stream of panels double-buffered through shared memory
//    with cp.async and one barrier per product, out-projection and FF2
//    summed in registers, the register-resident attention core
//    (attn_strip_block_f32, one warp per strip), and the last layer's
//    queries, attention, out-projection and FF for the cls rows only.
//    - Products run on the tensor cores in split TF32 (attn_core.cuh:
//      hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), three m16n8k8
//      products lo hi, hi lo, hi hi; each term ~2^-21 relative, so the f32
//      tolerance of the plain version holds where one TF32 product, ~2^-11,
//      would not). Every product keeps its running sum in the MMA's
//      accumulator, which truncates (attn_core.cuh): within 2e-5 of the
//      plain table at the flagship against its 1e-4; summing each k step
//      apart (an ablation of analysis/profile_spatial_table.py) costs
//      time and registers. Hopper's tf32 wgmma reads B from shared
//      memory, so its split would need hi and lo panels there; mma.sync
//      takes both operands from registers, so weights and activations are
//      split as their fragments are loaded (a float4 per lane of each) and
//      a panel stays one f32 copy.
//    - Shared memory is the constraint: 80 rows of x (stride D + 4), h
//      (D + 16), q and k (d_head + 16) and v (d_head + 4), and two panel
//      buffers of 64 x 128 floats (32 KB: a head's q, k and v rows, its
//      out-projection columns, and MLP chunks of 64 are each one panel),
//      226,816 bytes in all, one block of 8 warps per SM. Pre-split hi/lo
//      panels would need 64 KB more, which is why the split is in
//      registers. The FF chunk reuses q and k, the cls tiles q (and h).
//    - Each warp owns 8 (or 16) output columns of a product for all 80
//      rows, so every weight element is read from shared memory by one
//      warp, and the activations by all eight; the panels, ~3.1 MB of f32
//      weights a block, stream from L2 once per block.
//    LayerNorm, softmax, GELU, biases and residuals are f32, as the plain
//    version computes them.
//    Past N 80 (the 144 .. 256 px crops of the stored 256 px frames, up to
//    the whole frame's 257 tokens) one f32 frame does not fit a block: a
//    head's k and v for 272 rows alone are 161 KB. The frame spreads over a
//    cluster of C blocks on neighbouring SMs, each of 64 rows (four 16-row
//    tiles: C = 2 up to N 128, 3 up to 192, 4 up to 256, 5 at 257), in the
//    same order of work. Each block runs its own rows through every product
//    and keeps only its own rows' k and v.
//    - Its query strips read the other blocks' keys over distributed shared
//      memory (mapa, then ordinary loads), 16 keys a call of the core, with
//      the online softmax's running max and sum; the scores (a k step at a
//      time) and P V (a 16-key tile at a time) are summed apart from the
//      MMA's truncating accumulator and added in f32. Two warps share a
//      strip (a block has at most four), each taking half of the cluster's
//      blocks, and merge their parts through the panel buffer the v
//      product has freed.
//    - V is stored transposed, each 16-key tile's keys permuted, so that a
//      lane's V fragments for 16 keys are one float4 over DSMEM (eight
//      scalar loads row-major); h is kept as its split-TF32 pair, split
//      once by the LayerNorm, so that the q, k, v and FF1 products read their A
//      fragments as they are; the products sum a k step at a time. The 64
//      rows leave room for both (230,400 bytes).
//    - A cluster barrier in two halves per head orders the k and v rows: no
//      block overwrites them while another may read them, none reads before
//      they have landed. In the last layer the cls query's attention runs
//      where the keys are: every block attends block 0's cls tile to its own
//      keys and stores its part (output row, max, sum) into block 0, which
//      merges them in rank order; then the other blocks leave.
//    What bounds it: at N 257 a 4096-frame shot is 26.2 TFLOP, 158.7 ms at
//    the TF32 tensor peak in three products each. A cluster's blocks keep
//    pace at two barriers a head; the all-row attention (17 strips against
//    272 keys, a third over DSMEM) is about a third of a block and the split
//    products most of the rest (analysis/profile_spatial_table.py --widths
//    f32 --crop 256).
//  * general (f32 and bf16 at any other width the wrapper accepts, N up to
//    128: f32 at the demo's D 64 or with an MLP no multiple of 64, bf16 at
//    widths no fast instance is compiled for): one block per (offset,
//    frame), 16 x 16 warp tiles with 32-bit fragment loads, scores through
//    shared memory, f32 on scalar FMAs with the weights read from global
//    memory. It holds the
//    algorithm to the f32 tolerance, is not tuned, and stays for the
//    shapes the other two leave.

#include "attn_core.cuh"
#include "wgmma.cuh"

namespace {


// ---------------------------------------------------------------------------
// general instance
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kMlpChunk = 128;

struct Dims {
  int T, n_off, N, NP, D, depth, H, dh, M, inner, mc;
  float scale;
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// Shared-memory carve-up (byte offsets) and row strides (elements). Rows
// are padded so that the rows a warp reads at once start in different
// banks. q's buffer is reused for the per-head output, the f32 scores are
// overwritten in place by the probabilities (in T), and the FF chunk reuses
// the whole attention region. bf16 adds two weight-panel buffers.
template <typename T>
struct Layout {
  int ldx, ldq, ldvt, lds, ldp, ldm, ldacc;
  size_t x, h, acc, q, k, vt, s, mid, panel[2], panel_bytes, total;

  __host__ __device__ explicit Layout(const Dims& d) {
    // bf16 (MMA fragments, 32-bit loads): 16 bytes of padding per row;
    // f32 (scalar, one row per lane): one element, for odd strides
    const bool mma = sizeof(T) == 2;
    const int pad = mma ? 8 : 1;
    ldx = d.D + pad;
    ldq = d.dh + pad;
    ldvt = d.NP + pad;
    lds = d.NP + (mma ? 4 : 1);
    ldp = lds * static_cast<int>(sizeof(float) / sizeof(T));
    ldm = d.mc + pad;
    ldacc = d.D + (mma ? 4 : 1);
    const size_t st = sizeof(T);
    x = 0;
    h = x + align16(d.NP * ldx * st);
    acc = h + align16(d.NP * ldx * st);
    const size_t region = acc + align16(d.NP * ldacc * sizeof(float));
    q = region;
    k = q + align16(d.NP * ldq * st);
    vt = k + align16(d.NP * ldq * st);
    s = vt + align16(d.dh * ldvt * st);
    const size_t attn_end = s + align16(d.NP * lds * sizeof(float));
    mid = region;
    const size_t ff_end = mid + align16(d.NP * ldm * st);
    const size_t end = max2(attn_end, ff_end);
    // the largest weight panel: rows x (K + 8) with K contiguous
    panel_bytes = 0;
    if (mma)
      panel_bytes = align16(max2(max2(d.dh * (d.D + 8), d.D * (d.dh + 8)),
                                 max2(d.mc * (d.D + 8), d.D * (d.mc + 8))) * st);
    panel[0] = end;
    panel[1] = end + panel_bytes;
    total = end + 2 * panel_bytes;
  }
};

// A rows x K block of a weight matrix in global memory, row n at
// base + n * stride with its K elements contiguous: the B operand of one
// product (a torch.nn.Linear weight slice).
template <typename T>
struct Panel {
  const T* base;
  int stride, rows, K;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// C[r, c] = sum_k A[r, k] * B[c, k] for r < rows, c < cols, handed to
// epi(r, c, value) once per element. A is row-major (k contiguous) with
// stride lda; brow(n) points at row n of B, whose k run is contiguous (a
// Linear weight row or a row of a transposed operand). rows, cols and K
// are multiples of 16. Each warp takes 16 x 16 output tiles in turn.
template <typename BRow, typename Epi>
__device__ __forceinline__ void gemm(const bf16* A, int lda, BRow brow, int rows,
                                     int cols, int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int mt = rows >> 4, items = mt * (cols >> 4);
  for (int it = warp; it < items; it += nwarps) {
    const int m0 = (it % mt) * 16, n0 = (it / mt) * 16;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* a_lo = A + (m0 + g) * lda + q2;
    const bf16* a_hi = a_lo + 8 * lda;
    const bf16* b_0 = brow(n0 + g) + q2;
    const bf16* b_1 = brow(n0 + 8 + g) + q2;
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      const uint32_t a0 = ld32(a_lo + k), a1 = ld32(a_hi + k);
      const uint32_t a2 = ld32(a_lo + k + 8), a3 = ld32(a_hi + k + 8);
      const uint32_t a[4] = {a0, a1, a2, a3};
      mma_bf16(c0, a, ld32(b_0 + k), ld32(b_0 + k + 8));
      mma_bf16(c1, a, ld32(b_1 + k), ld32(b_1 + k + 8));
    }
    epi(m0 + g, n0 + q2, c0[0]);
    epi(m0 + g, n0 + q2 + 1, c0[1]);
    epi(m0 + g + 8, n0 + q2, c0[2]);
    epi(m0 + g + 8, n0 + q2 + 1, c0[3]);
    epi(m0 + g, n0 + 8 + q2, c1[0]);
    epi(m0 + g, n0 + 8 + q2 + 1, c1[1]);
    epi(m0 + g + 8, n0 + 8 + q2, c1[2]);
    epi(m0 + g + 8, n0 + 8 + q2 + 1, c1[3]);
  }
}

// f32 operands: the same contract with scalar FMAs, summed in k order.
// Neighbouring threads take neighbouring rows of one column, so a warp
// reads one B element at a time (a broadcast) and A down a column (row
// strides are odd, so no bank conflicts).
template <typename BRow, typename Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, BRow brow, int rows,
                                     int cols, int K, Epi epi) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i % rows, c = i / rows;
    const float* a = A + r * lda;
    const float* b = brow(c);
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(a[k], b[k], acc);
    epi(r, c, acc);
  }
}

// Start copying a panel into a shared buffer (rows x (K + 8)), 16 bytes
// per cp.async, as one commit group (empty when the panel is).
__device__ __forceinline__ void panel_copy(bf16* dst, const Panel<bf16>& p) {
  const int per_row = p.K / 8;
  for (int i = threadIdx.x; i < p.rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const uint32_t s =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * (p.K + 8) + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(p.base + static_cast<size_t>(r) * p.stride + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The product with a weight panel: C = A @ p^T over p.rows columns.
// bf16: p sits in shared buffer `cur` (its copy was started one product
// earlier); this call starts copying `next` into the other buffer, waits
// for p, runs the product from shared memory, and flips the buffers.
// f32: reads p from global memory.
template <typename T, typename Epi>
__device__ __forceinline__ void weight_gemm(const T* A, int lda, int rows,
                                            const Panel<T>& p, const Panel<T>& next,
                                            T* const (&buf)[2], int& cur, Epi epi) {
  if constexpr (sizeof(T) == 2) {
    panel_copy(buf[cur ^ 1], next);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const T* b = buf[cur];
    const int ldb = p.K + 8;
    gemm(A, lda, [&](int n) { return b + n * ldb; }, rows, p.rows, p.K, epi);
    __syncthreads();  // buf[cur] is refilled by the next call's copy
    cur ^= 1;
  } else {
    gemm(A, lda, [&](int n) { return p.base + static_cast<size_t>(n) * p.stride; },
         rows, p.rows, p.K, epi);
  }
}

// flax LayerNorm in f32 (eps 1e-6, mean-of-squares variance clamped at 0)
// of `rows` rows of x into y (rounded to T), one warp per row.
template <typename T>
__device__ void layer_norm_rows(const T* x, T* y, int ld, int rows, int D,
                                const float* scale, const float* bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_f<T>(x[r * ld + c]);
      s += v;
      s2 += v * v;
    }
    const float mean = warp_sum(s) / D;
    const float var = fmaxf(warp_sum(s2) / D - mean * mean, 0.f);
    const float inv = rsqrtf(var + 1e-6f);
    for (int c = lane; c < D; c += 32)
      y[r * ld + c] = from_f<T>((to_f<T>(x[r * ld + c]) - mean) * (inv * scale[c]) + bias[c]);
  }
}

// Row softmax over the first n of each f32 score row (keys >= n masked),
// written back in place as probabilities in T (zeros for masked keys).
// A row holds at most 128 entries, four per lane.
template <typename T>
__device__ void softmax_rows(float* s, int lds, T* p, int ldp, int rows, int np, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5) {
    float v[4];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < n ? s[r * lds + c] : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < n ? expf(v[i] - m) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      if (c < np) p[r * ldp + c] = from_f<T>(v[i] / sum);
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_table_kernel(const T* __restrict__ tokens,  // (T, N, D)
                     const T* __restrict__ base,    // (n_off, N, D)
                     const T* __restrict__ wmat,    // per layer, see below
                     const float* __restrict__ wln, // per layer 4 x D, then 2 x D
                     T* __restrict__ out,           // (n_off, T, D)
                     Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> L(d);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  T* hs = reinterpret_cast<T*>(smem + L.h);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* os = qs;
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vts = reinterpret_cast<T*>(smem + L.vt);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* ps = reinterpret_cast<T*>(smem + L.s);
  T* mid = reinterpret_cast<T*>(smem + L.mid);
  T* const buf[2] = {reinterpret_cast<T*>(smem + L.panel[0]),
                     reinterpret_cast<T*>(smem + L.panel[1])};
  int cur = 0;

  const int frame = blockIdx.x, off = blockIdx.y, tid = threadIdx.x;
  const int N = d.N, NP = d.NP, D = d.D, dh = d.dh, M = d.M, inner = d.inner;
  const int H = d.H, mc = d.mc, n_chunks = (M + mc - 1) / mc;

  // per-layer weights, packed: w_qkv (3*inner, D), w_out (D, inner),
  // b_out (D), w_ff1 (M, D), b_ff1 (M), w_ff2 (D, M), b_ff2 (D)
  const size_t layer_elems = static_cast<size_t>(3 * inner) * D + D * inner + D +
                             static_cast<size_t>(M) * D + M + D * M + D;
  // The weight panels in the order a layer uses them: per head q, k, v,
  // out-projection; then per MLP chunk FF1, FF2. Past the last one of a
  // layer comes the next layer's first; past the last layer, none.
  const int per_layer = 4 * H + 2 * n_chunks;
  auto panel_at = [&](int l, int i) -> Panel<T> {
    if (i >= per_layer) {
      ++l;
      i = 0;
    }
    if (l >= d.depth) return Panel<T>{wmat, 0, 0, 8};
    const T* w_qkv = wmat + l * layer_elems;
    const T* w_out = w_qkv + static_cast<size_t>(3 * inner) * D;
    const T* w_ff1 = w_out + D * inner + D;
    const T* w_ff2 = w_ff1 + static_cast<size_t>(M) * D + M;
    if (i < 4 * H) {
      const int hh = i / 4, part = i % 4;
      if (part < 3)
        return Panel<T>{w_qkv + static_cast<size_t>(part * inner + hh * dh) * D, D, dh, D};
      return Panel<T>{w_out + hh * dh, inner, D, dh};
    }
    const int c = (i - 4 * H) / 2, m0 = c * mc, rows = M - m0 < mc ? M - m0 : mc;
    if ((i - 4 * H) % 2 == 0)
      return Panel<T>{w_ff1 + static_cast<size_t>(m0) * D, D, rows, D};
    return Panel<T>{w_ff2 + m0, M, D, rows};
  };
  if constexpr (sizeof(T) == 2) panel_copy(buf[0], panel_at(0, 0));

  // x = tokens + base, rounded to T; padded rows are zero
  for (int i = tid; i < NP * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float v = 0.f;
    if (r < N)
      v = round_to<T>(to_f<T>(tokens[(static_cast<size_t>(frame) * N + r) * D + c]) +
                      to_f<T>(base[(static_cast<size_t>(off) * N + r) * D + c]));
    xs[r * L.ldx + c] = from_f<T>(v);
  }
  __syncthreads();

  auto zero_acc = [&]() {
    for (int i = tid; i < NP * D; i += blockDim.x) acc[(i / D) * L.ldacc + i % D] = 0.f;
  };
  // x <- x + round(round(acc) + bias), all in T
  auto residual = [&](const T* bias) {
    for (int i = tid; i < NP * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const float upd = round_to<T>(round_to<T>(acc[r * L.ldacc + c]) + to_f<T>(bias[c]));
      xs[r * L.ldx + c] = from_f<T>(to_f<T>(xs[r * L.ldx + c]) + upd);
    }
  };

  for (int l = 0; l < d.depth; ++l) {
    const T* b_out = wmat + l * layer_elems + static_cast<size_t>(3 * inner) * D + D * inner;
    const T* b_ff1 = b_out + D + static_cast<size_t>(M) * D;
    const T* b_ff2 = b_ff1 + M + D * M;
    const float* ln = wln + 4 * l * D;
    int step = 0;
    // the product with this layer's panel `step`, prefetching the next
    auto wgemm = [&](const T* A, int lda, auto epi) {
      weight_gemm<T>(A, lda, NP, panel_at(l, step), panel_at(l, step + 1), buf, cur, epi);
      ++step;
    };

    // ---- attention ----
    layer_norm_rows<T>(xs, hs, L.ldx, NP, D, ln, ln + D);
    zero_acc();
    __syncthreads();
    for (int hh = 0; hh < H; ++hh) {
      wgemm(hs, L.ldx, [&](int r, int c, float v) { qs[r * L.ldq + c] = from_f<T>(v); });
      wgemm(hs, L.ldx, [&](int r, int c, float v) { ks[r * L.ldq + c] = from_f<T>(v); });
      wgemm(hs, L.ldx, [&](int r, int c, float v) { vts[c * L.ldvt + r] = from_f<T>(v); });
      __syncthreads();
      gemm(qs, L.ldq, [&](int n) { return ks + n * L.ldq; }, NP, NP, dh,
           [&](int r, int c, float v) { ss[r * L.lds + c] = v * d.scale; });
      __syncthreads();
      softmax_rows<T>(ss, L.lds, ps, L.ldp, NP, NP, N);
      __syncthreads();
      gemm(ps, L.ldp, [&](int n) { return vts + n * L.ldvt; }, NP, dh, NP,
           [&](int r, int c, float v) { os[r * L.ldq + c] = from_f<T>(v); });
      __syncthreads();
      wgemm(os, L.ldq, [&](int r, int c, float v) { acc[r * L.ldacc + c] += v; });
      __syncthreads();
    }
    residual(b_out);
    __syncthreads();

    // ---- feed-forward, over chunks of the MLP columns ----
    layer_norm_rows<T>(xs, hs, L.ldx, NP, D, ln + 2 * D, ln + 3 * D);
    zero_acc();
    __syncthreads();
    for (int m0 = 0; m0 < M; m0 += mc) {
      wgemm(hs, L.ldx, [&](int r, int c, float v) {
        const float y = round_to<T>(round_to<T>(v) + to_f<T>(b_ff1[m0 + c]));
        mid[r * L.ldm + c] = from_f<T>(gelu_tanh(y));
      });
      __syncthreads();
      wgemm(mid, L.ldm, [&](int r, int c, float v) { acc[r * L.ldacc + c] += v; });
      __syncthreads();
    }
    residual(b_ff2);
    __syncthreads();
  }

  // final LayerNorm of the cls row only
  if (tid < 32) {
    const float* fs = wln + 4 * d.depth * D;
    T* dst = out + (static_cast<size_t>(off) * d.T + frame) * D;
    float s = 0.f, s2 = 0.f;
    for (int c = tid; c < D; c += 32) {
      const float v = to_f<T>(xs[c]);
      s += v;
      s2 += v * v;
    }
    const float mean = warp_sum(s) / D;
    const float var = fmaxf(warp_sum(s2) / D - mean * mean, 0.f);
    const float inv = rsqrtf(var + 1e-6f);
    for (int c = tid; c < D; c += 32)
      dst[c] = from_f<T>((to_f<T>(xs[c]) - mean) * (inv * fs[c]) + fs[D + c]);
  }
}

Dims make_dims(int T, int n_off, int N, int D, int depth, int H, int dh, int M,
               float scale) {
  Dims d;
  d.T = T;
  d.n_off = n_off;
  d.N = N;
  d.NP = (N + 15) / 16 * 16;
  d.D = D;
  d.depth = depth;
  d.H = H;
  d.dh = dh;
  d.M = M;
  d.inner = H * dh;
  d.mc = M < kMlpChunk ? M : kMlpChunk;
  d.scale = scale;
  return d;
}

template <typename T>
int launch(const void* tokens, const void* base, const void* wmat, const void* wln,
           void* out, int T_, int n_off, int N, int D, int depth, int H, int dh,
           int M, float scale, void* stream) {
  const Dims d = make_dims(T_, n_off, N, D, depth, H, dh, M, scale);
  const Layout<T> L(d);
  cudaError_t err = cudaFuncSetAttribute(spatial_table_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  spatial_table_kernel<T><<<dim3(T_, n_off), kThreads, L.total,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(base),
      static_cast<const T*>(wmat), static_cast<const float*>(wln),
      static_cast<T*>(out), d);
  return cudaGetLastError();
}

// The launch configuration of a grid whose blocks go in clusters of
// `cluster` neighbours along x (a frame's blocks: x = frame * cluster + rank).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, int cluster, void* stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// ---------------------------------------------------------------------------
// fast instance: one design, compiled for each width in the list below
// ---------------------------------------------------------------------------

namespace fast {

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The cluster's other block: its shared memory at the address p has in
// this block, a release/acquire barrier over both blocks in two halves, and
// this block's rank.
__device__ __forceinline__ uint32_t peer_smem(const void* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_addr(p)), "r"(rank));
  return addr;
}
__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

constexpr int kPackedMaxN = 80;             // five 16-key tiles: one pass of the core
constexpr int kMaxFrames = 16;              // rows of the last layer's cls tiles
constexpr int kOneBlockMaxN = 144;          // one frame a block up to its 144 product rows
constexpr int kKeyTiles = 4;                // 16-key tiles per block of the two-pass core

// One compiled width of the fast instance and its row scheme: D and DH the
// model's and a head's width, MC the MLP columns of one FF panel, WG the
// warpgroups on wgmma (64 rows each), REM the rows one more warpgroup
// computes on mma.sync (0 or 16), MAXN the most tokens a frame may have,
// CLUSTER the blocks that share one frame (1 or 2). Up to kPackedMaxN
// tokens a block packs several frames and the attention core takes all of
// a frame's keys in one pass; past it a block (or a cluster) owns one
// frame and the core runs two passes over blocks of keys.
template <int D_, int DH_, int MC_, int WG_, int REM_, int MAXN_ = kPackedMaxN,
          int CLUSTER_ = 1>
struct Shape {
  static constexpr int kD = D_, kDh = DH_, kMc = MC_, kWg = WG_, kRem = REM_;
  static constexpr int kMaxN = MAXN_, kCluster = CLUSTER_;
  static constexpr bool kPacked = kMaxN <= kPackedMaxN;
  static constexpr int blocks_per_frame(int) { return kCluster; }
  static constexpr int kProdRows = 64 * kWg + kRem;   // rows the products compute
  static constexpr int kRows = kProdRows + 16;         // rows of x, h, q (and of k, v
                                                       // packed): the last frame's
                                                       // keys padded to 16
  static constexpr int kKeyRows = cmax(kRows, (kMaxN + 15) / 16 * 16);   // rows of k, v
  static constexpr int kWgmmaWarps = 4 * kWg;
  static constexpr int kWarps = kWgmmaWarps + (kRem ? 4 : 0), kThreads = kWarps * 32;
  // row strides: an odd number of 16-byte units, so that the eight rows of
  // an ldmatrix tile fall into different banks
  static constexpr int kLdx = kD + 8;                  // x, h
  static constexpr int kLdq = kDh + 8;                 // q, k, v
  static constexpr int kLdm = kMc + 8;                 // the FF chunk
  // weight panels as the wrapper packs them: blocked (wgmma.cuh), no padding.
  // A cluster's k and v rows leave room for two 16 KB panel buffers only,
  // so there a head's q and k rows are two panels (the same stream).
  static constexpr int kQkParts = kCluster > 1 ? 2 : 1;
  static constexpr int kHeadPanels = kQkParts + 2;     // q|k (or q, k), v, out
  static constexpr int kQkPanel = 2 * kDh * kD;        // a head's q rows, then its k rows
  static constexpr int kVPanel = kDh * kD;
  static constexpr int kOutPanel = kD * kDh;
  static constexpr int kFfPanel = kMc * kD;            // FF1 chunk (mc x D), FF2 chunk (D x mc)
  static constexpr int kPanelMax = cmax(cmax(kQkPanel / kQkParts, kVPanel),
                                        cmax(kOutPanel, kFfPanel));

  static constexpr size_t kOffX = 0;
  static constexpr size_t kOffH = kOffX + sizeof(bf16) * kRows * kLdx;
  static constexpr size_t kOffQ = kOffH + sizeof(bf16) * kRows * kLdx;
  static constexpr size_t kOffK = kOffQ + sizeof(bf16) * kRows * kLdq;
  static constexpr size_t kOffV = kOffK + sizeof(bf16) * kKeyRows * kLdq;
  static constexpr size_t kOffMid = kOffQ;             // the FF chunk reuses q (and k)
  static constexpr size_t kOffPanel = kOffV + sizeof(bf16) * kKeyRows * kLdq;
  static constexpr size_t kSmemBytes = kOffPanel + 2 * sizeof(bf16) * kPanelMax;
  // two blocks to an SM where two fit in its 228 KB (1 KB reserved for each)
  static constexpr int kMinBlocks = 2 * (kSmemBytes + 1024) <= 233472 ? 2 : 1;

  static_assert(kRem == 0 || (kRem == 16 && kDh % 64 == 0),
                "the mma.sync warpgroup takes 16 rows of 64-column products");
  static_assert(kDh == 32 || kDh == 64, "q and k share one 64-column product, or fill one each");
  static_assert(kD % 64 == 0 && kMc % 64 == 0 && 32 % (kD / 16) == 0, "64-column tiles");
  static_assert(kD / 16 <= kWarps && kMc / 16 <= kWarps, "a warp per 16 columns of a cls tile");
  static_assert(sizeof(bf16) * kRows * kLdm <= kOffV - kOffMid, "mid fits in q and k");
  static_assert(kCluster == 1 || kLdm <= kLdq,
                "mid stays in q: the other block of the cluster writes k and v");
  static_assert(kPacked ? kCluster == 1 : kMaxN <= kCluster * kProdRows,
                "one frame's rows in the cluster's product rows");
  static_assert(kQkParts == 1 || kDh == 64, "q and k apart: one 64-column product each");
  static_assert(16 * kLdx + 48 * kLdq + 16 * kLdm <= kRows * kLdq, "cls tiles fit in q's region");
  static_assert(kOffPanel % 128 == 0, "panels start on a core-matrix boundary");
  static_assert(kSmemBytes <= 232448, "fits in one block's shared memory");
};

// The instances. The flagship ViViT (D 128, d_head 64): 2 x 64 wgmma rows
// and 16 mma.sync rows hold two frames of 65 tokens (or 8 of 17), where a
// third wgmma tile would spend a third of the tensor time on padding;
// 221,696 bytes, one block per SM. The demo ViViT (D 64, d_head 32): 2 x 64
// wgmma rows hold 7 frames of 17 tokens in 92,416 bytes, so two blocks share
// an SM and one computes while the other waits at a barrier. Past 80 tokens
// at the flagship widths (crops of 144 px and up): one frame in the same
// block up to its 144 rows, then one frame over a cluster of two.
using Flagship = Shape<128, 64, 128, 2, 16>;
using Demo = Shape<64, 32, 64, 2, 0>;
using FlagshipOneBlock = Shape<128, 64, 128, 2, 16, kOneBlockMaxN, 1>;
using FlagshipCluster = Shape<128, 64, 64, 2, 16, 257, 2>;

// fn(S()) for the instance compiled for (N, D, dh), or `none` where there is none
template <typename R, typename Fn>
R with_instance(int N, int D, int dh, R none, Fn fn) {
  if (N < 1) return none;
  if (D == Flagship::kD && dh == Flagship::kDh) {
    if (N <= Flagship::kMaxN) return fn(Flagship());
    if (N <= FlagshipOneBlock::kMaxN) return fn(FlagshipOneBlock());
    if (N <= FlagshipCluster::kMaxN) return fn(FlagshipCluster());
  }
  if (D == Demo::kD && dh == Demo::kDh && N <= Demo::kMaxN) return fn(Demo());
  return none;
}

// Frames per block: packed, the most whose rows fit in the kProdRows rows
// the products compute and, with the last frame's keys padded to a multiple
// of 16, in the kRows rows of q, k and v; at most the 16 rows of the last
// layer's cls tiles. One past kPackedMaxN. 0 where the instance does not
// apply.
template <class S>
__host__ __device__ inline int frames_per_block(int N) {
  if (N < 1 || N > S::kMaxN) return 0;
  if (!S::kPacked) return 1;
  int fit = (S::kRows - (N + 15) / 16 * 16) / N + 1;
  if (fit > S::kProdRows / N) fit = S::kProdRows / N;
  return fit < kMaxFrames ? fit : kMaxFrames;
}

template <class S>
bool applies(int N, int M) {
  return M > 0 && M % S::kMc == 0 && frames_per_block<S>(N) > 0;
}

// Phase profile of a throw-away build (-DKSTAR_PROFILE, see
// kstar_torch/analysis/profile_spatial_table.py): thread 0 of every block
// adds the clock64() cycles it spent since its last stamp to prof[phase].
// It reads warp 0's view: a phase's time includes that warp's wait for the
// others at the barrier that ends it. A normal build compiles none of it.
enum Phase {
  kPhOther, kPhPanelWait, kPhLayerNorm, kPhAttention, kPhResidual,
  kPhQk, kPhV, kPhOut, kPhFf1, kPhFf2,               // all-row layers
  kPhLastKq, kPhLastOut, kPhLastFf1, kPhLastFf2,     // last layer, cls rows
  kPhases
};
#ifdef KSTAR_PROFILE
unsigned long long* g_prof = nullptr;
#define KSTAR_STAMP(ph) stamp(ph)
#define KSTAR_NEXT(ph) next_phase = (ph)
#else
#define KSTAR_STAMP(ph)
#define KSTAR_NEXT(ph)
#endif

struct Params {
#ifdef KSTAR_PROFILE
  unsigned long long* prof;
#endif
  const bf16* tokens;   // (T, N, D)
  const bf16* base;     // (n_off, N, D)
  const bf16* wmat;     // packed panels and biases, see pack_fast in the wrapper
  const float* wln;     // per layer 4 x D, then 2 x D
  bf16* out;            // (n_off, T, D)
  int T, N, F, depth, H, M;
  float scale;
};

// tanh-GELU as x * sigmoid(2u), u = sqrt(2/pi) (x + 0.044715 x^3): the same
// function as 0.5 x (1 + tanh u), one fast exponential and one division
__device__ __forceinline__ float gelu_fast(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.f + __expf(-2.f * u));
}

// flax LayerNorm in f32 (eps 1e-6) of `rows` rows of kD bf16. kD / 16 lanes
// share a row, 16 elements each, so a warp has 32 / (kD / 16) rows in
// flight. Row r is read at x + src(r) * kLdx and written at y + r * kLdx.
template <class S, typename Src>
__device__ __forceinline__ void layer_norm_fast(const bf16* x, bf16* y, int rows, Src src,
                                                const float* scale, const float* bias) {
  constexpr int kLanes = S::kD / 16, kPerWarp = 32 / kLanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kLanes, c0 = (lane % kLanes) * 16;
  float sc[16], bi[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(sc + 4 * j) = *reinterpret_cast<const float4*>(scale + c0 + 4 * j);
    *reinterpret_cast<float4*>(bi + 4 * j) = *reinterpret_cast<const float4*>(bias + c0 + 4 * j);
  }
  for (int r0 = warp * kPerWarp; r0 < rows; r0 += S::kWarps * kPerWarp) {
    const int r = r0 + sub < rows ? r0 + sub : rows - 1;   // idle lanes repeat the last row
    const bf16* xr = x + src(r) * S::kLdx + c0;
    uint4 raw[2] = {*reinterpret_cast<const uint4*>(xr), *reinterpret_cast<const uint4*>(xr + 8)};
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(raw);
    float v[16], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[2 * j] = __low2float(h2[j]);
      v[2 * j + 1] = __high2float(h2[j]);
      s += v[2 * j] + v[2 * j + 1];
      s2 += v[2 * j] * v[2 * j] + v[2 * j + 1] * v[2 * j + 1];
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / S::kD;
    const float inv = rsqrtf(fmaxf(s2 / S::kD - mean * mean, 0.f) + 1e-6f);
    uint32_t res[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      res[j] = pack_bf16((v[2 * j] - mean) * (inv * sc[2 * j]) + bi[2 * j],
                         (v[2 * j + 1] - mean) * (inv * sc[2 * j + 1]) + bi[2 * j + 1]);
    if (r0 + sub < rows) {
      bf16* yr = y + r * S::kLdx + c0;
      *reinterpret_cast<uint4*>(yr) = make_uint4(res[0], res[1], res[2], res[3]);
      *reinterpret_cast<uint4*>(yr + 8) = make_uint4(res[4], res[5], res[6], res[7]);
    }
  }
}

// 16 rows x NT2 * 8 columns on mma.sync with B from a blocked panel (K
// columns): acc[j] (+)= A[0..15, :] * panel[n0 + 8 j .., :]^T. A is row-major
// with stride lda; n0 is a multiple of 16.
template <int NT2, int K>
__device__ __forceinline__ void mma_gemm_blocked(float (*acc)[4], const bf16* A, int lda,
                                                 const bf16* panel, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* ap = A + lane_off_a(lane, lda);
  // ldmatrix.x4: tiles (n, k), (n, k + 8), (n + 8, k), (n + 8, k + 8)
  const bf16* bp = panel + blocked_off(n0 + (lane >> 4) * 8 + (lane & 7), ((lane >> 3) & 1) * 8, K);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, ap + kk * 16);
#pragma unroll
    for (int nj = 0; nj < NT2 / 2; ++nj) {
      uint32_t b[4];
      ldsm4(b, bp + blocked_off(nj * 16, kk * 16, K));
      mma_bf16(acc[2 * nj], a, b[0], b[1]);
      mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

// The all-row product, NW (64 or 32) output columns at a time: acc (+)= A *
// panel^T for the kProdRows rows of A (row-major, stride lda) and TILES * NW
// rows of a blocked panel with K columns; output columns NW t .. NW t + NW -
// 1 go to acc[NW / 8 * t ..]. Wgmma warp w holds rows 16 w .. 16 w + 15 and
// all NW columns of a tile (A fragments from ldmatrix, loaded once for all
// tiles; B through the descriptor; one commit and one wait for the lot).
// Where the instance has one, the mma.sync warpgroup takes the 16 rows after
// theirs, its warp i columns 16 i .. 16 i + 15 of each 64-column tile, in
// acc[8 t], acc[8 t + 1].
template <class S, int K, int NW, int TILES>
__device__ __forceinline__ void rows_gemm(float (*acc)[4], const bf16* A, int lda,
                                          const bf16* panel) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < S::kWgmmaWarps) {
    uint32_t a[K / 16][4];
    const bf16* ap = A + warp * 16 * lda + lane_off_a(lane, lda);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) ldsm4(a[kk], ap + kk * 16);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      uint64_t desc = wgmma_desc(panel + blocked_off(t * NW, 0, K), K);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wgmma_m64k16<NW>(acc + NW / 8 * t, a[kk], desc);
        desc = wgmma_desc_next_k(desc);
      }
    }
    wgmma_commit();
    wgmma_wait();
  } else if constexpr (S::kRem > 0) {
    static_assert(NW == 64, "the mma.sync warpgroup splits 64-column tiles");
#pragma unroll
    for (int t = 0; t < TILES; ++t)
      mma_gemm_blocked<2, K>(acc + 8 * t, A + S::kWgmmaWarps * 16 * lda, lda,
                             panel + blocked_off(t * 64, 0, K), (warp - S::kWgmmaWarps) * 16);
  }
}

// This thread's first column of the NW that rows_gemm produces per tile (its
// pairs are at this column + 8 j) and the number of its column pairs.
template <class S>
__device__ __forceinline__ int out_col0() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp < S::kWgmmaWarps ? 0 : (warp - S::kWgmmaWarps) * 16) + (lane & 3) * 2;
}
template <class S, int NW>
__device__ __forceinline__ int out_pairs() {
  return static_cast<int>(threadIdx.x >> 5) < S::kWgmmaWarps ? NW / 8 : 2;
}

// epi(row, col, j, v0, v1) for every pair of neighbouring columns this warp
// holds of one NW-column tile after rows_gemm (row < kProdRows, col =
// out_col0() + 8 j).
template <class S, int NW, typename Epi>
__device__ __forceinline__ void for_each_out(float (*acc)[4], Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = (warp < S::kWgmmaWarps ? warp : S::kWgmmaWarps) * 16 + (lane >> 2);
  const int col = out_col0<S>(), pairs = out_pairs<S, NW>();
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    if (j < pairs) {
      epi(row, col + j * 8, j, acc[j][0], acc[j][1]);
      epi(row + 8, col + j * 8, j, acc[j][2], acc[j][3]);
    }
  }
}

// The bias pairs of this thread's columns of a 64-column tile, loaded ahead
// of an epilogue so that no global load sits between its shared-memory
// stores: bias points at the tile's first column.
template <class S>
__device__ __forceinline__ void load_bias64(__nv_bfloat162 (&b)[8], const bf16* bias) {
  const int col = out_col0<S>(), pairs = out_pairs<S, 64>();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < pairs) b[j] = *reinterpret_cast<const __nv_bfloat162*>(bias + col + j * 8);
}

// round(round(v) + bias) in bf16, as f32
__device__ __forceinline__ float add_bias(float v, float bias) {
  return round_to<bf16>(round_to<bf16>(v) + bias);
}

__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// The all-row product of h with NW rows of a kD-column panel, rounded to
// bf16: output columns c and c + 1 of row r go to store(r, c, the pair).
template <class S, int NW, typename Store>
__device__ __forceinline__ void project(const bf16* hs, const bf16* panel, Store store) {
  float acc[NW / 8][4];
  zero_acc<NW / 8>(acc);
  rows_gemm<S, S::kD, NW, 1>(acc, hs, S::kLdx, panel);
  for_each_out<S, NW>(acc, [&](int r, int c, int, float v0, float v1) {
    store(r, c, pack_bf16(v0, v1));
  });
}

// softmax(q k^T * scale) v for one 16-query strip against the n_keys keys
// at k and v (KT16 = ceil(n_keys / 16) tiles), P rounded to bf16
template <class S, int KT16>
__device__ __forceinline__ void attend_strip(const bf16* q_rows, const bf16* k, const bf16* v,
                                             int n_keys, float scale,
                                             float (&o)[S::kDh / 8][4]) {
  uint32_t qf[S::kDh / 16][4];
  attn_load_q<S::kDh>(qf, q_rows, S::kLdq);
  float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  zero_acc<S::kDh / 8>(o);
  attn_strip_block<S::kDh, KT16, kPNormBf16, true>(qf, k, v, S::kLdq, n_keys, scale, m, lsum, o);
}

template <class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
spatial_table_fast_kernel(Params p) {
  constexpr int kD = S::kD, kDh = S::kDh, kMc = S::kMc, kWarps = S::kWarps;
  constexpr int kLdx = S::kLdx, kLdq = S::kLdq, kLdm = S::kLdm;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::kOffX);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::kOffH);
  bf16* qs = reinterpret_cast<bf16*>(smem + S::kOffQ);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::kOffV);
  bf16* mid = reinterpret_cast<bf16*>(smem + S::kOffMid);
  // The last layer's 16-row tiles for the cls rows (row f = frame f's cls
  // token) live in q's region, which that layer does not fill: LN output,
  // q (32 rows: strip f reads rows f..f+15), attention output, FF chunk.
  bf16* hc = qs;
  bf16* qc = hc + 16 * kLdx;
  bf16* oc = qc + 32 * kLdq;
  bf16* midc = oc + 16 * kLdq;
  bf16* const buf[2] = {reinterpret_cast<bf16*>(smem + S::kOffPanel),
                        reinterpret_cast<bf16*>(smem + S::kOffPanel) + S::kPanelMax};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int N = p.N, F = p.F, H = p.H, M = p.M;
  // a cluster's blocks share one frame: block `rank` owns its rows from
  // key_row0 on (0 for a block of its own), and k and v hold all its rows
  const uint32_t rank = S::kCluster > 1 ? cluster_rank() : 0;
  const int key_row0 = S::kPacked ? 0 : static_cast<int>(rank) * S::kProdRows;
  const int frame0 = blockIdx.x / S::kCluster * F, off = blockIdx.y;
  const int n_chunks = M / kMc;
  const int per_layer = S::kHeadPanels * H + 2 * n_chunks;
  const int n_panels = p.depth * per_layer;
  const size_t layer_panels = static_cast<size_t>(H) * (S::kQkPanel + S::kVPanel + S::kOutPanel) +
                              static_cast<size_t>(n_chunks) * 2 * S::kFfPanel;
  const size_t layer_elems = layer_panels + 2 * kD + M;

  // The weight panels lie in wmat in the order they are used, each in the
  // layout it has in shared memory, so a panel is one flat copy. Panel i
  // goes to buffer i % 2 while panel i - 1 is multiplied.
#ifdef KSTAR_PROFILE
  long long last_stamp = clock64();
  int next_phase = kPhOther;           // what the time up to the next barrier counts as
  auto stamp = [&](int ph) {
    if (threadIdx.x == 0) {
      const long long t = clock64();
      atomicAdd(&p.prof[ph], static_cast<unsigned long long>(t - last_stamp));
      last_stamp = t;
    }
  };
#endif
  const bf16* wnext = p.wmat;
  int issued = 0, consumed = 0;
  auto issue_next = [&]() {
    if (issued < n_panels) {
      const int i = issued % per_layer, part = i % S::kHeadPanels;
      const int n = i >= S::kHeadPanels * H ? S::kFfPanel
                    : part < S::kQkParts    ? S::kQkPanel / S::kQkParts
                    : part == S::kQkParts   ? S::kVPanel : S::kOutPanel;
      bf16* dst = buf[issued & 1];
      for (int e = tid * 8; e < n; e += S::kThreads * 8)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + e)),
                     "l"(wnext + e));
      wnext += n;
      if (i == per_layer - 1) wnext += 2 * kD + M;      // the layer's biases
      ++issued;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // One barrier per product: after it this product's panel has landed for
  // every thread (and is visible to wgmma's proxy), what earlier stages
  // wrote to shared memory is visible, and every warp is done with the
  // product before, so its panel buffer takes the next panel's copy, which
  // then runs under this product.
  auto next_panel = [&]() -> const bf16* {
    KSTAR_STAMP(next_phase);
    KSTAR_NEXT(kPhOther);
    asm volatile("cp.async.wait_group 0;\n" ::);
    fence_proxy_async();
    __syncthreads();
    KSTAR_STAMP(kPhPanelWait);
    issue_next();
    return buf[consumed++ & 1];
  };
  issue_next();

  // x = tokens + base, rounded to bf16, frames packed without padding: row
  // f * N + i is token i of frame frame0 + f (one frame: row i is its token
  // key_row0 + i). Rows of frames past T and rows past F * N (past N) are
  // zero (finite through every layer, never stored).
  for (int i = tid; i < S::kRows * (kD / 8); i += S::kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    const int f = S::kPacked ? r / N : 0;
    const int tok = S::kPacked ? r % N : key_row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (S::kPacked ? f < F && frame0 + f < p.T : r < S::kProdRows && tok < N) {
      const uint4 a = *reinterpret_cast<const uint4*>(
          p.tokens + (static_cast<size_t>(frame0 + f) * N + tok) * kD + c);
      const uint4 b = *reinterpret_cast<const uint4*>(
          p.base + (static_cast<size_t>(off) * N + tok) * kD + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
      uint32_t* v = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = pack_bf16(__low2float(a2[j]) + __low2float(b2[j]),
                         __high2float(a2[j]) + __high2float(b2[j]));
    }
    *reinterpret_cast<uint4*>(xs + r * kLdx + c) = val;
  }
  // The products fill rows 0..kProdRows-1 of q, k and v; the last frame's
  // padding keys may reach up to row kRows-1. Masked keys never count, but
  // their V rows are multiplied by p = 0, so they must be finite: zero them
  // once (the FF chunk reuses q and k only). One frame: the products fill
  // every row up to the frame's keys padded to 16.
  if constexpr (S::kPacked)
    for (int i = tid; i < (S::kRows - S::kProdRows) * kLdq; i += S::kThreads)
      vs[S::kProdRows * kLdq + i] = from_f<bf16>(0.f);
  __syncthreads();
  // The cluster's barrier runs in two halves around each head's k and v:
  // this first arrival pairs with the first wait, before any store into the
  // other block, which must have started.
  if constexpr (S::kCluster > 1) cluster_arrive();

  // x <- x + round(round(v) + bias), in bf16, for two neighbouring columns
  auto residual_pair = [](bf16* x, __nv_bfloat162 bias, float v0, float v1) {
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(x);
    *xp = __floats2bfloat162_rn(__low2float(*xp) + add_bias(v0, __low2float(bias)),
                                __high2float(*xp) + add_bias(v1, __high2float(bias)));
  };
  // the all-row residual: x[:, 64 t ..] += acc + bias, per 64 columns
  auto residual_rows = [&](float (*acc)[4], const bf16* bias) {
#pragma unroll
    for (int t = 0; t < kD / 64; ++t) {
      __nv_bfloat162 b2[8];
      load_bias64<S>(b2, bias + t * 64);
      for_each_out<S, 64>(acc + 8 * t, [&](int r, int c, int j, float v0, float v1) {
        residual_pair(xs + r * kLdx + t * 64 + c, b2[j], v0, v1);
      });
    }
  };
  // stores of a product's output pairs: q into this block's rows; k and v
  // at the frame's row key_row0 + r, in a cluster into both blocks (rows
  // past kKeyRows are the last block's padding and dropped)
  auto q_at = [=](int r, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(qs + r * kLdq + c) = v;
  };
  auto kv_at = [=](bf16* buf) {
    return [=](int r, int c, uint32_t v) {
      const int row = key_row0 + r;
      if (S::kPacked || row < S::kKeyRows) {
        bf16* dst = buf + row * kLdq + c;
        *reinterpret_cast<uint32_t*>(dst) = v;
        if constexpr (S::kCluster > 1) st_peer(peer_smem(dst, rank ^ 1u), v);
      }
    };
  };
  const auto k_at = kv_at(ks), v_at = kv_at(vs);
  // In a cluster each block's k and v rows land in both blocks: before the
  // first store of a head's k the other block must be done reading the
  // last head's (wait), and after the head's v both blocks' rows must be
  // there before the strips read them (arrive, wait); a block's strips done,
  // it arrives again. Alone, a block barrier makes k and v visible.
  auto kv_before_store = [&]() {
    if constexpr (S::kCluster > 1) cluster_wait();
  };
  auto kv_complete = [&]() {
    if constexpr (S::kCluster > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
  };
  auto kv_read_done = [&]() {
    if constexpr (S::kCluster > 1) cluster_arrive();
  };
  // One warp, one 16-query strip of one frame: the frame's keys are its N
  // rows at row0; the rows up to the next multiple of 16 belong to the next
  // frame or the zero tail and are masked in the core. Packed, the core is
  // compiled for each count of 16-key tiles, so its loops carry no
  // branches; past kPackedMaxN it runs two passes over blocks of keys.
  auto attend = [&](const bf16* q_rows, int row0, float (&o)[kDh / 8][4]) {
    const bf16* k = ks + row0 * kLdq;
    const bf16* v = vs + row0 * kLdq;
    if constexpr (S::kPacked) {
      switch ((N + 15) / 16) {
        case 1: attend_strip<S, 1>(q_rows, k, v, N, p.scale, o); break;
        case 2: attend_strip<S, 2>(q_rows, k, v, N, p.scale, o); break;
        case 3: attend_strip<S, 3>(q_rows, k, v, N, p.scale, o); break;
        case 4: attend_strip<S, 4>(q_rows, k, v, N, p.scale, o); break;
        default: attend_strip<S, 5>(q_rows, k, v, N, p.scale, o); break;
      }
    } else {
      uint32_t qf[kDh / 16][4];
      attn_load_q<kDh>(qf, q_rows, kLdq);
      attn_strip_two_pass<kDh, kKeyTiles>(qf, k, v, kLdq, N, p.scale, o);
    }
    __syncwarp();
  };
  // the 16-row cls tiles' products: warp w takes columns 16 w .. 16 w + 15
  const int ccol = warp * 16;
  // the cls rows: this block's, or in a cluster block 0's alone
  const bool has_cls = rank == 0;

  const int spf = (N + 15) / 16;            // strips per frame
  // query strips of this block: spf per packed frame, else those of its rows
  const int n_strips = S::kPacked ? F * spf
                                  : (cmin(S::kProdRows, N - key_row0) + 15) / 16;
  for (int l = 0; l < p.depth; ++l) {
    const bf16* b_out = p.wmat + l * layer_elems + layer_panels;
    const bf16* b_ff1 = b_out + kD;
    const bf16* b_ff2 = b_ff1 + M;
    const float* ln = p.wln + 4 * l * kD;
    layer_norm_fast<S>(xs, hs, S::kProdRows, [](int r) { return r; }, ln, ln + kD);
    __syncthreads();
    KSTAR_STAMP(kPhLayerNorm);

    if (l < p.depth - 1) {
      // ---- attention, all rows ----
      float oacc[kD / 8][4];                // out-projection, summed over heads
      zero_acc<kD / 8>(oacc);
      for (int hh = 0; hh < H; ++hh) {
        {  // q (the panel's first kDh rows) and k (the next kDh) of this head
          const bf16* w = next_panel();
          KSTAR_NEXT(kPhQk);
          if constexpr (S::kQkParts == 2) { // q and k in two panels
            project<S, 64>(hs, w, q_at);
            w = next_panel();
            kv_before_store();
            project<S, 64>(hs, w, k_at);
          } else if constexpr (kDh == 64) {
            project<S, 64>(hs, w, q_at);
            project<S, 64>(hs, w + blocked_off(kDh, 0, kD), k_at);
          } else {                          // q and k side by side in one product
            project<S, 64>(hs, w, [=](int r, int c, uint32_t v) {
              if (c < kDh)
                q_at(r, c, v);
              else
                k_at(r, c - kDh, v);
            });
          }
        }
        // v, row-major: the core reads it through ldmatrix.trans
        project<S, kDh>(hs, next_panel(), v_at);
        kv_complete();
        KSTAR_STAMP(kPhV);
        // The output replaces the strip's own q rows (rows past the frame's
        // end are left alone: they are the next frame's q).
        for (int s = warp; s < n_strips; s += kWarps) {
          const int f = S::kPacked ? s / spf : 0, q0 = (S::kPacked ? s % spf : s) * 16;
          const int row0 = f * N, left = N - (S::kPacked ? 0 : key_row0) - q0;
          float o[kDh / 8][4];
          bf16* dst = qs + (row0 + q0) * kLdq;
          attend(dst, row0, o);
#pragma unroll
          for (int t = 0; t < kDh / 8; ++t) {
            if (g < left) store_pair(dst + g * kLdq + t * 8 + c2, o[t][0], o[t][1]);
            if (g + 8 < left)
              store_pair(dst + (g + 8) * kLdq + t * 8 + c2, o[t][2], o[t][3]);
          }
        }
        kv_read_done();
        KSTAR_STAMP(kPhAttention);
        // out-projection of this head's output, summed in registers
        rows_gemm<S, kDh, 64, kD / 64>(oacc, qs, kLdq, next_panel());
        KSTAR_NEXT(kPhOut);
      }
      KSTAR_STAMP(kPhOut);
      residual_rows(oacc, b_out);
      __syncthreads();
      KSTAR_STAMP(kPhResidual);

      // ---- feed-forward, all rows, over chunks of kMc MLP columns ----
      layer_norm_fast<S>(xs, hs, S::kProdRows, [](int r) { return r; }, ln + 2 * kD,
                         ln + 3 * kD);
      KSTAR_STAMP(kPhLayerNorm);
      zero_acc<kD / 8>(oacc);               // FF2, summed over the chunks
      for (int ch = 0; ch < n_chunks; ++ch) {
        {
          const bf16* w = next_panel();
          KSTAR_NEXT(kPhFf1);
#pragma unroll
          for (int t = 0; t < kMc / 64; ++t) {
            __nv_bfloat162 b2[8];
            load_bias64<S>(b2, b_ff1 + ch * kMc + t * 64);
            float acc[8][4];
            zero_acc<8>(acc);
            rows_gemm<S, kD, 64, 1>(acc, hs, kLdx, w + blocked_off(t * 64, 0, kD));
            for_each_out<S, 64>(acc, [&](int r, int c, int j, float v0, float v1) {
              store_pair(mid + r * kLdm + t * 64 + c,
                         gelu_fast(add_bias(v0, __low2float(b2[j]))),
                         gelu_fast(add_bias(v1, __high2float(b2[j]))));
            });
          }
        }
        rows_gemm<S, kMc, 64, kD / 64>(oacc, mid, kLdm, next_panel());
        KSTAR_NEXT(kPhFf2);
      }
      KSTAR_STAMP(kPhFf2);
      residual_rows(oacc, b_ff2);
      __syncthreads();
      KSTAR_STAMP(kPhResidual);
    } else {
      // ---- last layer: the table keeps the cls row after the final
      // LayerNorm, so K and V are needed for all rows and everything else
      // for the F cls rows, gathered into 16-row tiles (row f = frame f).
      // The same arithmetic for those rows as the all-row path. In a
      // cluster block 0 holds the cls row; block 1 adds its k and v rows
      // and leaves.
      for (int i = tid; i < 16 * (kD / 8); i += S::kThreads) {
        const int f = i / (kD / 8), c = (i % (kD / 8)) * 8;
        *reinterpret_cast<uint4*>(hc + f * kLdx + c) =
            *reinterpret_cast<const uint4*>(hs + (f < F ? f * N : 0) * kLdx + c);
      }
      // q of the cls rows from a panel holding q's kDh rows first
      auto cls_q = [&](const bf16* w) {
        if (has_cls && warp < kDh / 16) {
          float qa[2][4];
          zero_acc<2>(qa);
          mma_gemm_blocked<2, kD>(qa, hc, kLdx, w, ccol);
          store_pair(qc + g * kLdq + ccol + c2, qa[0][0], qa[0][1]);
          store_pair(qc + (g + 8) * kLdq + ccol + c2, qa[0][2], qa[0][3]);
          store_pair(qc + g * kLdq + ccol + 8 + c2, qa[1][0], qa[1][1]);
          store_pair(qc + (g + 8) * kLdq + ccol + 8 + c2, qa[1][2], qa[1][3]);
        }
      };
      float cacc[2][4];                     // out-projection of the cls rows
      zero_acc<2>(cacc);
      for (int hh = 0; hh < H; ++hh) {
        {  // k for all rows (the panel's rows kDh..2 kDh-1), q for the cls rows
          const bf16* w = next_panel();
          KSTAR_NEXT(kPhLastKq);
          if constexpr (S::kQkParts == 2) {
            cls_q(w);
            w = next_panel();
            kv_before_store();
            project<S, kDh>(hs, w, k_at);
          } else {
            project<S, kDh>(hs, w + blocked_off(kDh, 0, kD), k_at);
            cls_q(w);
          }
        }
        project<S, kDh>(hs, next_panel(), v_at);
        kv_complete();
        KSTAR_STAMP(kPhV);
        // strip f: queries qc rows f..f+15, of which row 0 is frame f's cls
        for (int f = warp; f < F && has_cls; f += kWarps) {
          float o[kDh / 8][4];
          attend(qc + f * kLdq, f * N, o);
          if (g == 0) {
#pragma unroll
            for (int t = 0; t < kDh / 8; ++t)
              store_pair(oc + f * kLdq + t * 8 + c2, o[t][0], o[t][1]);
          }
        }
        kv_read_done();
        KSTAR_STAMP(kPhAttention);
        {
          const bf16* w = next_panel();
          KSTAR_NEXT(kPhLastOut);
          if (has_cls && warp < kD / 16) mma_gemm_blocked<2, kDh>(cacc, oc, kLdq, w, ccol);
        }
      }
      if constexpr (S::kCluster > 1) {
        cluster_wait();                     // every store into block 0 has landed
        if (!has_cls) {
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          return;
        }
      }
      // cls tile row g is frame g (rows 8..15 hold no frame when F <= 8)
      auto cls_residual = [&](const bf16* bias) {
        if (warp < kD / 16) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = ccol + j * 8 + c2;
            const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
            if (g < F) residual_pair(xs + g * N * kLdx + c, b2, cacc[j][0], cacc[j][1]);
            if (g + 8 < F)
              residual_pair(xs + (g + 8) * N * kLdx + c, b2, cacc[j][2], cacc[j][3]);
          }
        }
      };
      KSTAR_STAMP(kPhLastOut);
      cls_residual(b_out);
      __syncthreads();
      KSTAR_STAMP(kPhResidual);

      layer_norm_fast<S>(xs, hc, F, [N](int r) { return r * N; }, ln + 2 * kD, ln + 3 * kD);
      KSTAR_STAMP(kPhLayerNorm);
      zero_acc<2>(cacc);                    // FF2 of the cls rows
      for (int ch = 0; ch < n_chunks; ++ch) {
        {
          const bf16* w = next_panel();
          KSTAR_NEXT(kPhLastFf1);
          if (warp < kMc / 16) {
            const bf16* bias = b_ff1 + ch * kMc + ccol + c2;
            const __nv_bfloat162 b2[2] = {*reinterpret_cast<const __nv_bfloat162*>(bias),
                                          *reinterpret_cast<const __nv_bfloat162*>(bias + 8)};
            float acc[2][4];
            zero_acc<2>(acc);
            mma_gemm_blocked<2, kD>(acc, hc, kLdx, w, ccol);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int hi = 0; hi < 2; ++hi)
                store_pair(midc + (g + 8 * hi) * kLdm + ccol + j * 8 + c2,
                           gelu_fast(add_bias(acc[j][2 * hi], __low2float(b2[j]))),
                           gelu_fast(add_bias(acc[j][2 * hi + 1], __high2float(b2[j]))));
          }
        }
        {
          const bf16* w = next_panel();
          KSTAR_NEXT(kPhLastFf2);
          if (warp < kD / 16) mma_gemm_blocked<2, kMc>(cacc, midc, kLdm, w, ccol);
        }
      }
      KSTAR_STAMP(kPhLastFf2);
      cls_residual(b_ff2);
      __syncthreads();
      KSTAR_STAMP(kPhResidual);
    }
  }

  // final LayerNorm of each frame's cls row
  const float* fs = p.wln + 4 * p.depth * kD;
  for (int f = warp; f < F && frame0 + f < p.T; f += kWarps) {
    const bf16* x = xs + f * N * kLdx;
    bf16* dst = p.out + (static_cast<size_t>(off) * p.T + frame0 + f) * kD;
    float v[kD / 32], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      v[j] = to_f<bf16>(x[lane + 32 * j]);
      s += v[j];
      s2 += v[j] * v[j];
    }
    const float mean = warp_sum(s) / kD;
    const float var = fmaxf(warp_sum(s2) / kD - mean * mean, 0.f);
    const float inv = rsqrtf(var + 1e-6f);
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const int c = lane + 32 * j;
      dst[c] = from_f<bf16>((v[j] - mean) * (inv * fs[c]) + fs[kD + c]);
    }
  }
}

// Sets the kernel's shared-memory limit: before it is launched or asked
// for its occupancy.
template <class S>
cudaError_t prepare() {
  return cudaFuncSetAttribute(spatial_table_fast_kernel<S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(S::kSmemBytes));
}

template <class S>
int launch(const void* tokens, const void* base, const void* wmat, const void* wln,
           void* out, int T, int n_off, int N, int depth, int H, int M, float scale,
           void* stream) {
  for (const void* ptr : {tokens, base, wmat})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  Params p;
  p.tokens = static_cast<const bf16*>(tokens);
  p.base = static_cast<const bf16*>(base);
  p.wmat = static_cast<const bf16*>(wmat);
  p.wln = static_cast<const float*>(wln);
  p.out = static_cast<bf16*>(out);
  p.T = T;
  p.N = N;
  p.F = frames_per_block<S>(N);
  p.depth = depth;
  p.H = H;
  p.M = M;
  p.scale = scale;
#ifdef KSTAR_PROFILE
  p.prof = g_prof;
#endif
  cudaError_t err = prepare<S>();
  if (err != cudaSuccess) return err;
  if constexpr (S::kCluster == 1) {
    spatial_table_fast_kernel<S><<<dim3((T + p.F - 1) / p.F, n_off), S::kThreads,
                                   S::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  } else {
    ClusterLaunch lc(dim3(T * S::kCluster, n_off), S::kThreads, S::kSmemBytes, S::kCluster,
                     stream);
    err = cudaLaunchKernelEx(&lc.cfg, spatial_table_fast_kernel<S>, p);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace fast

// ---------------------------------------------------------------------------
// f32 instance: the fast design's order of work on f32 operands, products in
// split TF32
// ---------------------------------------------------------------------------

namespace tf32 {

constexpr int kWarps = 8, kThreads = kWarps * 32;

// One compiled width: D and DH the model's and a head's width, MC the MLP
// columns of one FF panel, ROWS the rows of a block. With MAXC 1 a block
// packs frames without padding into its rows (the last frame's keys padded to
// 16 inside them), up to N = ROWS; with MAXC > 1 one frame of up to MAXN
// tokens spreads over a cluster of ceil(N / ROWS) <= MAXC blocks on
// neighbouring SMs, each with its share of the frame's rows (cluster_rows),
// its own rows' q, k and v, and the other blocks' keys read from their
// shared memory (distributed shared memory). Row strides in
// floats: the products' A operands and q, k are read as float4 fragments
// (16 mod 32, attn_core.cuh), v as single words (4 mod 32), x by LayerNorm
// and the residual epilogues only. Every weight panel is 64 x D or D x 64
// (kPanel floats), in 8 x 16 tiles: its 8-row group g, 16-column block b is
// 128 contiguous floats, so a lane's B fragment is one float4 and a panel
// is one flat copy.
template <int D_, int DH_, int MC_, int ROWS_, int MAXN_ = ROWS_, int MAXC_ = 1>
struct Shape {
  static constexpr int kD = D_, kDh = DH_, kMc = MC_, kRows = ROWS_, kMt = ROWS_ / 16;
  static constexpr int kMaxN = MAXN_, kMaxCluster = MAXC_;
  static constexpr bool kClustered = MAXC_ > 1;
  // A cluster's block keeps h as split-TF32 pairs, each row the LayerNorm's
  // output rounded to TF32 (hi) and then the rest (lo, kHLo floats on), so
  // that the products that read h (q, k, v, FF1) take its fragments as they
  // are instead of every warp splitting every row; and V transposed
  // (attn_pv_f32_t), so that the other blocks read a lane's V fragments of
  // 16 keys as one float4 over distributed shared memory. Its 64 rows leave
  // room for both.
  static constexpr bool kSplitH = kClustered;
  static constexpr int kHLo = kSplitH ? kD : 0;
  // blocks that share one frame of N tokens: at most kMt of its 16-row
  // tiles a block
  static constexpr int blocks_per_frame(int N) {
    return kClustered ? ((N + 15) / 16 + kMt - 1) / kMt : 1;
  }
  static constexpr int kLdx = kD + 4, kLdh = (kSplitH ? 2 * kD : kD) + 16, kLdq = kDh + 16;
  static constexpr int kLdv = kClustered ? kRows + 16 : kDh + 4;
  static constexpr int kVRows = kClustered ? kDh : kRows;   // rows of v (of v^T)
  static constexpr int kLdm = kMc + 16;
  static constexpr int kPanel = fast::cmax(kDh * kD, kMc * kD);
  static constexpr size_t kOffX = 0;
  static constexpr size_t kOffH = kOffX + sizeof(float) * kRows * kLdx;
  static constexpr size_t kOffQ = kOffH + sizeof(float) * kRows * kLdh;
  static constexpr size_t kOffK = kOffQ + sizeof(float) * kRows * kLdq;
  static constexpr size_t kOffV = kOffK + sizeof(float) * kRows * kLdq;
  static constexpr size_t kOffPanel = kOffV + sizeof(float) * kVRows * kLdv;
  static constexpr size_t kSmemBytes = kOffPanel + 2 * sizeof(float) * kPanel;

  static_assert(kDh == 8 * kWarps && kMc == 8 * kWarps,
                "64-column panels: one 8-column tile a warp");
  static_assert(kD == 16 * kWarps, "D-column products: two 8-column tiles a warp");
  static_assert(kLdh % 32 == 16 && kLdq % 32 == 16 && kLdm % 32 == 16 &&
                    kLdv % 32 == (kClustered ? 16 : 4),
                "fragment strides");
  static_assert(kRows % 16 == 0 && kRows >= 48, "16-row tiles; q holds the cls tiles");
  static_assert(kRows * kLdm <= 2 * kRows * kLdq, "the FF chunk fits in q and k");
  static_assert(48 * kLdq + 16 * kLdm <= kRows * kLdq, "the cls tiles fit in q");
  static_assert(kSmemBytes <= 232448, "fits in one block's shared memory");
  static_assert(!kClustered || (kMaxN <= kMaxCluster * kRows && kMaxCluster <= 8),
                "a frame's rows in a portable cluster's blocks");
  static_assert(!kClustered || kRows * kLdm <= kRows * kLdq,
                "the FF chunk stays in q: the cluster's other blocks read k");
  static_assert(!kClustered || (kLdq >= kDh + 2 && kMaxCluster < 16),
                "a block's cls part (output row, max, sum) in a row of oc");
};

// The flagship ViViT (D 128, d_head 64): frames of up to 80 tokens packed
// into a block of 80 rows (F = 1 at N 65, 3 at N 17), 226,816 bytes, one
// block per SM; past 80 tokens (the 144 .. 256 px crops of the stored 256 px
// frames) one frame over a cluster of blocks of 64 rows, 4 tiles: 2 up to N
// 128, 3 up to 192, 4 up to 256 and 5 at 257. Four strips a block let two
// warps share each strip's keys (attend_cluster).
using Flagship = Shape<128, 64, 64, 80>;
using FlagshipCluster = Shape<128, 64, 64, 64, 257, 5>;

template <typename R, typename Fn>
R with_instance(int N, int D, int dh, R none, Fn fn) {
  if (N >= 1 && D == Flagship::kD && dh == Flagship::kDh) {
    if (N <= Flagship::kMaxN) return fn(Flagship());
    if (N <= FlagshipCluster::kMaxN) return fn(FlagshipCluster());
  }
  return none;
}

// Frames per block: packed, the most whose rows fit, the last frame's keys
// padded to a multiple of 16, at most the cls tile's 16; one in a cluster;
// 0 where none fits.
template <class S>
__host__ __device__ inline int frames_per_block(int N) {
  if (S::kClustered) return N >= 1 && N <= S::kMaxN ? 1 : 0;
  const int pad = (N + 15) / 16 * 16;
  if (N < 1 || pad > S::kRows) return 0;
  return fast::cmin((S::kRows - pad) / N + 1, fast::kMaxFrames);
}

// The rows of a frame of N tokens that block r of a cluster of C owns: its
// first row (x) and how many (y). The frame's 16-row tiles are shared out as
// evenly as they go, the odd ones to the last blocks, so block 0, which
// alone carries the cls row through the last layer, has the fewest. Every
// block owns at least one tile (N > 16 (C - 1)).
__host__ __device__ inline int2 cluster_rows(int N, int C, int r) {
  const int tiles = (N + 15) / 16, base = tiles / C, big = C - tiles % C;
  const int row0 = 16 * (r * base + (r > big ? r - big : 0));
  return make_int2(row0, fast::cmin(16 * (base + (r >= big ? 1 : 0)), N - row0));
}

template <class S>
bool applies(int N, int M) {
  return M > 0 && M % S::kMc == 0 && frames_per_block<S>(N) > 0;
}

struct Params {
  const float* tokens;  // (T, N, D)
  const float* base;    // (n_off, N, D)
  const float* wmat;    // packed panels and biases (pack_fast, layout "tile8x16")
  const float* wln;     // per layer 4 x D, then 2 x D
  float* out;           // (n_off, T, D)
  int T, N, F, C, depth, H, M;   // C: blocks per frame (1 where frames are packed)
  float scale;
};

// The split pair of four floats already split: hi (TF32 values) and lo
__device__ __forceinline__ Split4 as_split4(const float4& hi, const float4& lo) {
  Split4 r;
  const float h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.hi[i] = __float_as_uint(h[i]);
    r.lo[i] = __float_as_uint(l[i]);
  }
  return r;
}

// acc[i][j] (+)= A x panel^T in split TF32 for the first mt (<= MT) 16-row
// tiles of A (row r at arow(r), K floats) and the warp's NT 8-column tiles
// of the panel (output columns 8 NT w .. 8 NT w + 8 NT - 1 for warp w). Per
// 16-column block each lane loads one float4 of B per tile and two of A per
// row tile and splits them as it loads; with ALO, A is stored split, its lo
// part ALO floats past its hi part, and is loaded as it is. With STEP each
// k step is summed from zero on the tensor core and added to acc in f32
// (rounded to nearest, and the MMAs of two steps do not wait on one
// accumulator); without it acc stays in the MMA's accumulator.
template <int MT, int NT, int K, int ALO = 0, bool STEP = false, typename ARow>
__device__ __forceinline__ void tc_rows(float (&acc)[MT][NT][4], ARow arow,
                                        const float* panel, int mt = MT) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* bp = panel + warp * NT * (K / 16) * 128 + lane * 4;
  auto k_block = [&](int kb) {
    Split4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = split4(ld4(bp + (j * (K / 16) + kb) * 128));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mt) break;
      const float* r0 = arow(16 * i + g) + kb * 16 + 4 * t;
      const float* r1 = arow(16 * i + g + 8) + kb * 16 + 4 * t;
      const Split4 a0 = ALO ? as_split4(ld4(r0), ld4(r0 + ALO)) : split4(ld4(r0));
      const Split4 a1 = ALO ? as_split4(ld4(r1), ld4(r1 + ALO)) : split4(ld4(r1));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (STEP) {
          float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_k16_step(d0, a0, a1, b[j], 0);
          mma_k16_step(d1, a0, a1, b[j], 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d0[e] + d1[e];
        } else {
          mma_k16_step(acc[i][j], a0, a1, b[j], 0);
          mma_k16_step(acc[i][j], a0, a1, b[j], 1);
        }
      }
    }
  };
  // the step-summed products (a cluster's) one k block at a time: two in
  // flight spill registers in the kernel that has the cluster's attention
  if constexpr (STEP) {
#pragma unroll 1
    for (int kb = 0; kb < K / 16; ++kb) k_block(kb);
  } else {
#pragma unroll 2
    for (int kb = 0; kb < K / 16; ++kb) k_block(kb);
  }
}

// epi(row, col, v0, v1) for the pairs of neighbouring columns a thread
// holds after tc_rows
template <int MT, int NT, typename Epi>
__device__ __forceinline__ void for_each_pair(float (&acc)[MT][NT][4], Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = warp * NT * 8 + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      epi(16 * i + g, c + 8 * j, acc[i][j][0], acc[i][j][1]);
      epi(16 * i + g + 8, c + 8 * j, acc[i][j][2], acc[i][j][3]);
    }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// flax LayerNorm in f32 (eps 1e-6) of `rows` rows of x: kD / 4 lanes share
// a row, a float4 each. Row r is read at x + src(r) * kLdx and written at
// y + r * ldy; where S keeps h split (kHLo), as its TF32 pair, hi there and
// lo kHLo floats past it.
template <class S, typename Src>
__device__ __forceinline__ void layer_norm(const float* x, float* y, int ldy, int rows, Src src,
                                           const float* scale, const float* bias) {
  constexpr int kLanes = S::kD / 4, kPerWarp = 32 / kLanes;
  static_assert(32 % kLanes == 0, "a row's lanes within a warp");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kLanes, c0 = (lane % kLanes) * 4;
  const float4 sc = ld4(scale + c0), bi = ld4(bias + c0);
  for (int r0 = warp * kPerWarp; r0 < rows; r0 += kWarps * kPerWarp) {
    const int r = r0 + sub < rows ? r0 + sub : rows - 1;   // idle lanes repeat the last row
    const float4 v = ld4(x + src(r) * S::kLdx + c0);
    float s = v.x + v.y + v.z + v.w;
    float s2 = v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / S::kD;
    const float inv = rsqrtf(fmaxf(s2 / S::kD - mean * mean, 0.f) + 1e-6f);
    const float4 out =
        make_float4((v.x - mean) * (inv * sc.x) + bi.x, (v.y - mean) * (inv * sc.y) + bi.y,
                    (v.z - mean) * (inv * sc.z) + bi.z, (v.w - mean) * (inv * sc.w) + bi.w);
    if (r0 + sub < rows) {
      if constexpr (S::kHLo > 0) {
        const Split4 p = split4(out);
        *reinterpret_cast<uint4*>(y + r * ldy + c0) =
            make_uint4(p.hi[0], p.hi[1], p.hi[2], p.hi[3]);
        *reinterpret_cast<uint4*>(y + r * ldy + c0 + S::kHLo) =
            make_uint4(p.lo[0], p.lo[1], p.lo[2], p.lo[3]);
      } else {
        *reinterpret_cast<float4*>(y + r * ldy + c0) = out;
      }
    }
  }
}

// softmax(q k^T * scale) v for one 16-query strip against the n_keys keys at
// k and v (KT16 = ceil(n_keys / 16) tiles), normalised
template <class S, int KT16>
__device__ __forceinline__ void attend_strip(const float* q_rows, const float* k, const float* v,
                                             int n_keys, float scale,
                                             float (&o)[S::kDh / 8][4]) {
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < S::kDh / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[t][i] = 0.f;
  // the running scores stay in the MMA's accumulator: summing each k step
  // apart spills this kernel's registers and slows a shot (an ablation of
  // analysis/profile_spatial_table.py --widths f32), for no gain against
  // its tolerance (the row products' error is the larger)
  attn_strip_block_f32<S::kDh, KT16, true, false>(q_rows, S::kLdq, k, S::kLdq, v, S::kLdv,
                                                  n_keys, scale, m, l, o);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int t = 0; t < S::kDh / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[t][i] *= inv[i >> 1];
}

// The address p has in the shared memory of the cluster's block `rank`, as
// a generic pointer (ordinary loads and stores reach it over distributed
// shared memory)
template <typename T>
__device__ __forceinline__ T* cluster_peer(T* p, int rank) {
  uint64_t a;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(a);
}

// 16-key tiles the cluster's attention core takes at a call: one, so that
// its scores leave room for all eight of a tile's V loads in flight without
// a spill (a block's 64 keys in one call would hold four times the scores)
constexpr int kClusterKeyTiles = 1;

// One 16-query strip against the keys that blocks r0 .. r1 - 1 of a
// cluster of C hold of a frame of N tokens (block r's cluster_rows(N, C, r)
// keys lie in its k and v at the addresses this block's have), read over
// distributed shared memory 16 keys a call of the core, with the running
// max m and sum l of the online softmax; the scores are summed a k step at a
// time and P V a 16-key tile at a time, each from zero and added in f32, so
// that no sum stays in the MMA's truncating accumulator across the frame
// (attn_core.cuh). o is left unnormalised.
template <class S>
__device__ __forceinline__ void attend_cluster(const float* q_rows, const float* k, const float* v,
                                               int N, int C, int r0, int r1, float scale,
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[S::kDh / 8][4]) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int t = 0; t < S::kDh / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[t][i] = 0.f;
  constexpr int kKeys = 16 * kClusterKeyTiles;   // keys a call of the core takes
  for (int r = r0; r < r1; ++r) {
    const float* kr = cluster_peer(k, r);
    const float* vr = cluster_peer(v, r);
    const int n = cluster_rows(N, C, r).y;
    for (int k0 = 0; k0 < n; k0 += kKeys)
      attn_strip_block_f32<S::kDh, kClusterKeyTiles, false, true, true>(
          q_rows, S::kLdq, kr + k0 * S::kLdq, S::kLdq, vr + k0, S::kLdv, n - k0, scale, m, l, o);
  }
}

// A strip's part (m, l, o of attend_cluster) as one lane holds it, in a
// scratch slot of 32 lanes x 36 floats (lane-major: a quarter warp's float4s
// fall into different banks)
constexpr int kPartFloats = 36;
template <int DH>
__device__ __forceinline__ void store_part(float* slot, const float (&m)[2], const float (&l)[2],
                                           const float (&o)[DH / 8][4]) {
  static_assert(DH / 8 * 4 + 4 == kPartFloats, "a lane's part fills its slot");
  float4* d = reinterpret_cast<float4*>(slot + (threadIdx.x & 31) * kPartFloats);
#pragma unroll
  for (int t = 0; t < DH / 8; ++t) d[t] = make_float4(o[t][0], o[t][1], o[t][2], o[t][3]);
  d[DH / 8] = make_float4(m[0], m[1], l[0], l[1]);
}
// o <- (o e^(m - M) + o' e^(m' - M)) / (l e^(m - M) + l' e^(m' - M)), M the
// larger max, with (m', l', o') the part in the slot: the strip's output
template <int DH>
__device__ __forceinline__ void merge_part(const float* slot, const float (&m)[2],
                                           const float (&l)[2], float (&o)[DH / 8][4]) {
  const float4* d = reinterpret_cast<const float4*>(slot + (threadIdx.x & 31) * kPartFloats);
  const float4 ml = d[DH / 8];
  const float m2[2] = {ml.x, ml.y}, l2[2] = {ml.z, ml.w};
  float a[2], b[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mx = fmaxf(m[r], m2[r]);
    a[r] = expf(m[r] - mx);
    b[r] = expf(m2[r] - mx);
    inv[r] = 1.f / (l[r] * a[r] + l2[r] * b[r]);
  }
#pragma unroll
  for (int t = 0; t < DH / 8; ++t) {
    const float4 p = d[t];
    const float o2[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[t][i] = (o[t][i] * a[i >> 1] + o2[i] * b[i >> 1]) * inv[i >> 1];
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads, 1)
spatial_table_tf32_kernel(Params p) {
  constexpr int kD = S::kD, kDh = S::kDh, kMc = S::kMc, kMt = S::kMt, kRows = S::kRows;
  constexpr int kLdx = S::kLdx, kLdh = S::kLdh, kLdq = S::kLdq, kLdv = S::kLdv;
  constexpr int kLdm = S::kLdm;
  // a cluster's products sum each k step apart (tc_rows)
  constexpr bool kStep = S::kClustered;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + S::kOffX);
  float* hs = reinterpret_cast<float*>(smem + S::kOffH);
  float* qs = reinterpret_cast<float*>(smem + S::kOffQ);
  float* ks = reinterpret_cast<float*>(smem + S::kOffK);
  float* vs = reinterpret_cast<float*>(smem + S::kOffV);
  float* mid = qs;                          // the FF chunk reuses q
  // The last layer's 16-row cls tiles (row f = frame f's cls token): q (32
  // rows: strip f reads rows f..f+15), the attention output and the FF
  // chunk in q's region; the LayerNorm output in h's.
  float* qc = qs;
  float* oc = qc + 32 * kLdq;
  float* midc = oc + 16 * kLdq;
  float* hc = hs;
  // panel buffer i % 2 (an address, not a pointer array a thread would
  // keep in local memory)
  float* const panels = reinterpret_cast<float*>(smem + S::kOffPanel);
  auto buf = [=](int i) { return panels + (i & 1) * S::kPanel; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int N = p.N, F = p.F, H = p.H, M = p.M;
  // In a cluster the C blocks of a frame are neighbours along x; block
  // `rank` owns the frame's rows own.x .. own.x + own.y - 1 in mt 16-row
  // tiles, block 0 the cls row. Packed, a block owns all its rows.
  const int C = S::kClustered ? p.C : 1;
  const int rank = S::kClustered ? static_cast<int>(fast::cluster_rank()) : 0;
  const int2 own = S::kClustered ? cluster_rows(N, C, rank) : make_int2(0, kRows);
  const int mt = S::kClustered ? (own.y + 15) / 16 : kMt;
  const bool has_cls = rank == 0;
  const int frame0 = blockIdx.x / C * F, off = blockIdx.y;
  const int n_chunks = M / kMc;
  const int per_layer = 4 * H + 2 * n_chunks;
  const int n_panels = p.depth * per_layer;
  const size_t layer_panels = static_cast<size_t>(H) * 4 * kDh * kD +
                              static_cast<size_t>(n_chunks) * 2 * kMc * kD;
  const size_t layer_elems = layer_panels + 2 * kD + M;

  // The panels lie in wmat in the order they are used: per head q, k, v,
  // out-projection; per MLP chunk FF1, FF2; then the layer's biases. Panel i
  // goes to buffer i % 2 while panel i - 1 is multiplied.
  const float* wnext = p.wmat;
  int issued = 0, consumed = 0;
  auto issue_next = [&]() {
    if (issued < n_panels) {
      const int i = issued % per_layer;
      const int n = i < 4 * H ? kDh * kD : kMc * kD;
      float* dst = buf(issued);
      for (int e = tid * 4; e < n; e += kThreads * 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + e)),
                     "l"(wnext + e));
      wnext += n;
      if (i == per_layer - 1) wnext += 2 * kD + M;      // the layer's biases
      ++issued;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // One barrier per product: after it the product's panel has landed, what
  // earlier stages wrote is visible, and every warp is done with the
  // product before, whose buffer then takes the next panel's copy.
  auto next_panel = [&]() -> const float* {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    issue_next();
    return buf(consumed++);
  };
  issue_next();

  // x = tokens + base, frames packed without padding: row f * N + i is token
  // i of frame frame0 + f (in a cluster row i is the frame's token own.x +
  // i). Rows of frames past T and past F * N (past own.y) are zero (finite
  // through every layer, never stored). q's region starts at zero, so that
  // the cls strips' padding rows are finite at any depth.
  for (int i = tid; i < kRows * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    const int f = S::kClustered ? 0 : r / N, tok = S::kClustered ? own.x + r : r % N;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (S::kClustered ? r < own.y : f < F && frame0 + f < p.T) {
      const float4 a = ld4(p.tokens + (static_cast<size_t>(frame0 + f) * N + tok) * kD + c);
      const float4 b = ld4(p.base + (static_cast<size_t>(off) * N + tok) * kD + c);
      val = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    *reinterpret_cast<float4*>(xs + r * kLdx + c) = val;
  }
  for (int i = tid; i < kRows * kLdq; i += kThreads) qs[i] = 0.f;
  __syncthreads();
  // The cluster's barrier runs in two halves around each head's k and v:
  // this first arrival pairs with the wait before the first k store.
  if constexpr (S::kClustered) fast::cluster_arrive();

  auto rows_of = [](const float* base, int ld) {
    return [=](int r) { return base + r * ld; };
  };
  // x[r, c..c+1] += v + bias, for two neighbouring columns
  auto residual_pair = [&](int r, int c, const float* bias, float v0, float v1) {
    float2* xp = reinterpret_cast<float2*>(xs + r * kLdx + c);
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    const float2 x = *xp;
    *xp = make_float2(x.x + (v0 + b.x), x.y + (v1 + b.y));
  };
  // One warp, one 16-query strip of one frame: packed, the frame's keys are
  // its N rows at row0, and the rows up to the next multiple of 16 belong to
  // the next frame or the zero tail and are masked in the core; in a
  // cluster, the frame's keys are every block's rows.
  auto attend = [&](const float* q_rows, int row0, float (&o)[kDh / 8][4]) {
    const float* k = ks + row0 * kLdq;
    const float* v = vs + row0 * kLdv;
    switch ((N + 15) / 16) {
      case 1: attend_strip<S, 1>(q_rows, k, v, N, p.scale, o); break;
      case 2: attend_strip<S, 2>(q_rows, k, v, N, p.scale, o); break;
      case 3: attend_strip<S, 3>(q_rows, k, v, N, p.scale, o); break;
      case 4: attend_strip<S, 4>(q_rows, k, v, N, p.scale, o); break;
      default: attend_strip<S, 5>(q_rows, k, v, N, p.scale, o); break;
    }
    __syncwarp();
  };
  // the strip's output o (16 rows at dst, left of them real) over its q rows
  auto store_strip = [&](float* dst, int left, const float (&o)[kDh / 8][4]) {
#pragma unroll
    for (int t = 0; t < kDh / 8; ++t) {
      if (g < left)
        *reinterpret_cast<float2*>(dst + g * kLdq + t * 8 + c2) = make_float2(o[t][0], o[t][1]);
      if (g + 8 < left)
        *reinterpret_cast<float2*>(dst + (g + 8) * kLdq + t * 8 + c2) =
            make_float2(o[t][2], o[t][3]);
    }
  };
  // the all-row product of h with the next 64-row panel into dst (stride
  // ld); for v in a cluster transposed, row r to column attn_vt_slot(r)
  auto project = [&](float* dst, int ld, bool vt = false) {
    float acc[kMt][1][4];
    zero(acc);
    tc_rows<kMt, 1, kD, S::kHLo, kStep>(acc, rows_of(hs, kLdh), next_panel(), mt);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      if (S::kClustered && vt) {
        dst[c * ld + attn_vt_slot(r)] = v0;
        dst[(c + 1) * ld + attn_vt_slot(r)] = v1;
      } else {
        *reinterpret_cast<float2*>(dst + r * ld + c) = make_float2(v0, v1);
      }
    });
  };
  // In a cluster the other blocks read this block's k and v: before the
  // first store of a head's k every block must be done reading the last
  // head's (wait), and after the head's v every block's rows must be there
  // before the strips read them (arrive, wait); a block's strips done, it
  // arrives again. Alone, a block barrier makes k and v visible.
  auto kv_before_store = [&]() {
    if constexpr (S::kClustered) fast::cluster_wait();
  };
  auto kv_complete = [&]() {
    if constexpr (S::kClustered) {
      fast::cluster_arrive();
      fast::cluster_wait();
    } else {
      __syncthreads();
    }
  };
  auto kv_read_done = [&]() {
    if constexpr (S::kClustered) fast::cluster_arrive();
  };

  const int spf = (N + 15) / 16;            // strips per frame
  // query strips of this block: spf per packed frame, else its row tiles
  const int strips = S::kClustered ? mt : F * spf;
  static_assert(!S::kClustered || (2 * kMt <= kWarps && kWarps / 2 * 32 * kPartFloats <= S::kPanel),
                "two warps a strip in a cluster, their parts in a panel buffer");
  const int ln_rows = S::kClustered ? 16 * mt : kRows;
  for (int l = 0; l < p.depth; ++l) {
    const float* b_out = p.wmat + l * layer_elems + layer_panels;
    const float* b_ff1 = b_out + kD;
    const float* b_ff2 = b_ff1 + M;
    const float* ln = p.wln + 4 * l * kD;
    layer_norm<S>(xs, hs, kLdh, ln_rows, [](int r) { return r; }, ln, ln + kD);
    __syncthreads();

    if (l < p.depth - 1) {
      // ---- attention, all rows ----
      float oacc[kMt][2][4];                // out-projection, summed over heads
      zero(oacc);
      for (int hh = 0; hh < H; ++hh) {
        project(qs, kLdq);
        kv_before_store();
        project(ks, kLdq);
        project(vs, kLdv, true);
        kv_complete();
        // the output replaces the strip's own q rows (rows past the frame's
        // end are left alone: they are the next frame's q)
        if constexpr (S::kClustered) {
          // two warps a strip (kMt <= kWarps / 2): warp s takes the keys of
          // the cluster's first half of blocks, warp s + 4 the rest, and
          // leaves its part in the panel buffer the v product has freed;
          // warp s merges the two
          const int s = warp % (kWarps / 2), half = (C + 1) / 2;
          const bool second = warp >= kWarps / 2;
          const bool active = s < strips;
          float* slot = buf(consumed + 1) + s * 32 * kPartFloats;
          float m[2], lsum[2], o[kDh / 8][4];
          if (active)
            attend_cluster<S>(qs + s * 16 * kLdq, ks, vs, N, C, second ? half : 0,
                              second ? C : half, p.scale, m, lsum, o);
          if (active && second) store_part<kDh>(slot, m, lsum, o);
          __syncthreads();
          if (active && !second) {
            merge_part<kDh>(slot, m, lsum, o);
            store_strip(qs + s * 16 * kLdq, own.y - s * 16, o);
          }
        } else {
          for (int s = warp; s < strips; s += kWarps) {
            const int row0 = s / spf * N, q0 = s % spf * 16, left = N - q0;
            float* dst = qs + (row0 + q0) * kLdq;
            float o[kDh / 8][4];
            attend(dst, row0, o);
            store_strip(dst, left, o);
          }
        }
        kv_read_done();
        tc_rows<kMt, 2, kDh, 0, kStep>(oacc, rows_of(qs, kLdq), next_panel(), mt);
      }
      for_each_pair(oacc, [&](int r, int c, float v0, float v1) {
        residual_pair(r, c, b_out, v0, v1);
      });
      __syncthreads();

      // ---- feed-forward, all rows, over chunks of kMc MLP columns ----
      layer_norm<S>(xs, hs, kLdh, ln_rows, [](int r) { return r; }, ln + 2 * kD, ln + 3 * kD);
      zero(oacc);                           // FF2, summed over the chunks
      for (int ch = 0; ch < n_chunks; ++ch) {
        {
          float acc[kMt][1][4];
          zero(acc);
          tc_rows<kMt, 1, kD, S::kHLo, kStep>(acc, rows_of(hs, kLdh), next_panel(), mt);
          const float* bias = b_ff1 + ch * kMc;
          for_each_pair(acc, [&](int r, int c, float v0, float v1) {
            *reinterpret_cast<float2*>(mid + r * kLdm + c) =
                make_float2(gelu_tanh(v0 + bias[c]), gelu_tanh(v1 + bias[c + 1]));
          });
        }
        tc_rows<kMt, 2, kMc, 0, kStep>(oacc, rows_of(mid, kLdm), next_panel(), mt);
      }
      for_each_pair(oacc, [&](int r, int c, float v0, float v1) {
        residual_pair(r, c, b_ff2, v0, v1);
      });
      __syncthreads();
    } else {
      // ---- last layer: the table keeps the cls row after the final
      // LayerNorm, so K and V are needed for all rows and everything else
      // for the F cls rows, as 16-row tiles (row f = frame f; rows past F
      // repeat frame 0 or hold finite leftovers, and are never stored). In
      // a cluster block 0 holds the cls row; the others add their k and v
      // rows and leave once block 0 has read them.
      auto cls_h = [&](int r) { return hs + (r < F ? r * N : 0) * kLdh; };
      // In a cluster the cls query's attention runs where the keys are:
      // every block attends block 0's cls tile (qc) to its own keys, warp 0,
      // and stores the cls row's unnormalised output, its max and its sum
      // into block 0's oc row 1 + rank; block 0 merges them into oc row 0,
      // in rank order.
      auto cls_attend_cluster = [&]() {
        if (warp == 0) {
          float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f}, o[kDh / 8][4];
#pragma unroll
          for (int t = 0; t < kDh / 8; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[t][i] = 0.f;
          attn_strip_block_f32<kDh, kMt, false, true, true>(
              cluster_peer(qc, 0), kLdq, ks, kLdq, vs, kLdv, own.y, p.scale, m, lsum, o);
          float* part = cluster_peer(oc + (1 + rank) * kLdq, 0);
          if (g == 0) {
#pragma unroll
            for (int t = 0; t < kDh / 8; ++t)
              *reinterpret_cast<float2*>(part + t * 8 + c2) = make_float2(o[t][0], o[t][1]);
            if (lane == 0) *reinterpret_cast<float2*>(part + kDh) = make_float2(m[0], lsum[0]);
          }
        }
        fast::cluster_arrive();
        fast::cluster_wait();               // every block's part is in block 0
        if (has_cls && warp == 0) {
          float mx = -INFINITY;
          for (int r = 0; r < C; ++r) mx = fmaxf(mx, oc[(1 + r) * kLdq + kDh]);
          for (int c = lane; c < kDh; c += 32) {
            float num = 0.f, den = 0.f;
            for (int r = 0; r < C; ++r) {
              const float* part = oc + (1 + r) * kLdq;
              const float e = expf(part[kDh] - mx);
              num += part[c] * e;
              den += part[kDh + 1] * e;
            }
            oc[c] = num / den;
          }
        }
      };
      float cacc[1][2][4];                  // out-projection of the cls rows
      zero(cacc);
      for (int hh = 0; hh < H; ++hh) {
        {
          const float* w = next_panel();
          if (has_cls) {
            float qa[1][1][4];
            zero(qa);
            tc_rows<1, 1, kD, S::kHLo, kStep>(qa, cls_h, w);
            for_each_pair(qa, [&](int r, int c, float v0, float v1) {
              *reinterpret_cast<float2*>(qc + r * kLdq + c) = make_float2(v0, v1);
            });
          }
        }
        kv_before_store();
        project(ks, kLdq);
        project(vs, kLdv, true);
        kv_complete();
        if constexpr (S::kClustered) {
          cls_attend_cluster();
        } else {
          // strip f: queries qc rows f..f+15, of which row 0 is frame f's cls
          for (int f = warp; has_cls && f < F; f += kWarps) {
            float o[kDh / 8][4];
            attend(qc + f * kLdq, f * N, o);
            if (g == 0) {
#pragma unroll
              for (int t = 0; t < kDh / 8; ++t)
                *reinterpret_cast<float2*>(oc + f * kLdq + t * 8 + c2) =
                    make_float2(o[t][0], o[t][1]);
            }
          }
        }
        kv_read_done();
        {
          const float* w = next_panel();
          if (has_cls) tc_rows<1, 2, kDh, 0, kStep>(cacc, rows_of(oc, kLdq), w);
        }
      }
      if constexpr (S::kClustered) {
        fast::cluster_wait();               // block 0 has read every block's k and v
        if (!has_cls) {
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          return;
        }
      }
      auto cls_residual = [&](const float* bias) {
        for_each_pair(cacc, [&](int r, int c, float v0, float v1) {
          if (r < F) residual_pair(r * N, c, bias, v0, v1);
        });
      };
      cls_residual(b_out);
      __syncthreads();

      layer_norm<S>(xs, hc, kLdh, F, [N](int r) { return r * N; }, ln + 2 * kD, ln + 3 * kD);
      zero(cacc);                           // FF2 of the cls rows
      for (int ch = 0; ch < n_chunks; ++ch) {
        {
          float acc[1][1][4];
          zero(acc);
          tc_rows<1, 1, kD, S::kHLo, kStep>(acc, rows_of(hc, kLdh), next_panel());
          const float* bias = b_ff1 + ch * kMc;
          for_each_pair(acc, [&](int r, int c, float v0, float v1) {
            *reinterpret_cast<float2*>(midc + r * kLdm + c) =
                make_float2(gelu_tanh(v0 + bias[c]), gelu_tanh(v1 + bias[c + 1]));
          });
        }
        tc_rows<1, 2, kMc, 0, kStep>(cacc, rows_of(midc, kLdm), next_panel());
      }
      cls_residual(b_ff2);
      __syncthreads();
    }
  }

  // final LayerNorm of each frame's cls row
  const float* fs = p.wln + 4 * p.depth * kD;
  for (int f = warp; f < F && frame0 + f < p.T; f += kWarps) {
    const float* x = xs + f * N * kLdx;
    float* dst = p.out + (static_cast<size_t>(off) * p.T + frame0 + f) * kD;
    float v[kD / 32], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      v[j] = x[lane + 32 * j];
      s += v[j];
      s2 += v[j] * v[j];
    }
    const float mean = warp_sum(s) / kD;
    const float var = fmaxf(warp_sum(s2) / kD - mean * mean, 0.f);
    const float inv = rsqrtf(var + 1e-6f);
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const int c = lane + 32 * j;
      dst[c] = (v[j] - mean) * (inv * fs[c]) + fs[kD + c];
    }
  }
}

template <class S>
cudaError_t prepare() {
  return cudaFuncSetAttribute(spatial_table_tf32_kernel<S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(S::kSmemBytes));
}

template <class S>
int launch(const void* tokens, const void* base, const void* wmat, const void* wln,
           void* out, int T, int n_off, int N, int depth, int H, int M, float scale,
           void* stream) {
  for (const void* ptr : {tokens, base, wmat})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  Params p;
  p.tokens = static_cast<const float*>(tokens);
  p.base = static_cast<const float*>(base);
  p.wmat = static_cast<const float*>(wmat);
  p.wln = static_cast<const float*>(wln);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.N = N;
  p.F = frames_per_block<S>(N);
  p.C = S::blocks_per_frame(N);
  p.depth = depth;
  p.H = H;
  p.M = M;
  p.scale = scale;
  cudaError_t err = prepare<S>();
  if (err != cudaSuccess) return err;
  if constexpr (!S::kClustered) {
    spatial_table_tf32_kernel<S><<<dim3((T + p.F - 1) / p.F, n_off), kThreads, S::kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(p);
  } else {
    ClusterLaunch lc(dim3(T * p.C, n_off), kThreads, S::kSmemBytes, p.C, stream);
    err = cudaLaunchKernelEx(&lc.cfg, spatial_table_tf32_kernel<S>, p);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace tf32

}  // namespace

extern "C" int spatial_table_plan(int N, int D, int H, int dh, int M, int elem_bytes);

namespace {
// fn(S()) for the instance a call at these widths takes (the f32 one's or
// the fast one's Shape), `none` for the general one
template <typename R, typename Fn>
R with_planned(int N, int D, int H, int dh, int M, int elem_bytes, R none, Fn fn) {
  if (spatial_table_plan(N, D, H, dh, M, elem_bytes) == 0) return none;
  return elem_bytes == 4 ? tf32::with_instance(N, D, dh, none, fn)
                         : fast::with_instance(N, D, dh, none, fn);
}

// out[0..6] of spatial_table_fast_attributes for one instance's kernel, err
// being its prepare()'s result; out[6] (clusters resident on the card) is 0
// for a block of its own
template <typename Params>
cudaError_t instance_attributes(void (*kernel)(Params), cudaError_t err, int threads,
                                size_t smem, int cluster, int* out) {
  cudaFuncAttributes attr{};
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = threads;
  out[4] = blocks;
  out[5] = cluster;
  out[6] = 0;
  if (err == cudaSuccess && cluster > 1) {
    ClusterLaunch lc(dim3(cluster), threads, smem, cluster, nullptr);
    err = cudaOccupancyMaxActiveClusters(&out[6], kernel, &lc.cfg);
  }
  return err;
}
}  // namespace

extern "C" {

#ifdef KSTAR_PROFILE
// prof: fast::kPhases zeroed 64-bit counters on the device
void spatial_table_set_profile(void* prof) {
  fast::g_prof = static_cast<unsigned long long*>(prof);
}
#endif

// Which instance a call takes: 0 the general one, otherwise the fast one
// (bf16) or the f32 one compiled for (N, D, dh), the value being its frames
// per block (1 where one frame has a block or a cluster of its own).
int spatial_table_plan(int N, int D, int H, int dh, int M, int elem_bytes) {
  (void)H;
  if (elem_bytes == 4)
    return tf32::with_instance(N, D, dh, 0, [&](auto s) {
      using S = decltype(s);
      return tf32::applies<S>(N, M) ? tf32::frames_per_block<S>(N) : 0;
    });
  if (elem_bytes != 2) return 0;
  return fast::with_instance(N, D, dh, 0, [&](auto s) {
    using S = decltype(s);
    return fast::applies<S>(N, M) ? fast::frames_per_block<S>(N) : 0;
  });
}

// The blocks that share a frame in the fast or f32 instance a call takes
// (1 or 2), 0 for the general one.
int spatial_table_cluster_size(int N, int D, int H, int dh, int M, int elem_bytes) {
  return with_planned(N, D, H, dh, M, elem_bytes, 0,
                      [&](auto s) { return decltype(s)::blocks_per_frame(N); });
}

// The MLP columns of one FF panel of the fast or f32 instance a call takes
// (the wrapper's pack_fast chunk), 0 for the general one.
int spatial_table_mlp_chunk(int N, int D, int H, int dh, int M, int elem_bytes) {
  return with_planned(N, D, H, dh, M, elem_bytes, 0,
                      [](auto s) { return decltype(s)::kMc; });
}

// Dynamic shared memory one block needs, in bytes (elem_bytes 2 or 4).
long long spatial_table_smem_bytes(int N, int D, int H, int dh, int M, int elem_bytes) {
  const long long fast_bytes = with_planned(N, D, H, dh, M, elem_bytes, 0LL, [](auto s) {
    return static_cast<long long>(decltype(s)::kSmemBytes);
  });
  if (fast_bytes > 0) return fast_bytes;
  const Dims d = make_dims(1, 1, N, D, 1, H, dh, M, 1.f);
  return elem_bytes == 2 ? static_cast<long long>(Layout<bf16>(d).total)
                         : static_cast<long long>(Layout<float>(d).total);
}

// The fast (elem_bytes 2) or f32 (4) instance compiled for (N, D, dh) as
// the card takes it: out[0] registers a thread, out[1] dynamic and out[2]
// static shared memory a block (bytes), out[3] threads a block, out[4]
// blocks resident on one SM, out[5] blocks a cluster, out[6] clusters
// resident on the card at once (0 for a block of its own). Returns a CUDA
// error code; cudaErrorInvalidValue where no instance is.
int spatial_table_fast_attributes(int N, int D, int dh, int elem_bytes, int* out) {
  if (elem_bytes == 4)
    return tf32::with_instance(N, D, dh, static_cast<int>(cudaErrorInvalidValue), [&](auto s) {
      using S = decltype(s);
      return static_cast<int>(instance_attributes(tf32::spatial_table_tf32_kernel<S>,
                                                  tf32::prepare<S>(), tf32::kThreads,
                                                  S::kSmemBytes, S::blocks_per_frame(N), out));
    });
  return fast::with_instance(N, D, dh, static_cast<int>(cudaErrorInvalidValue), [&](auto s) {
    using S = decltype(s);
    return static_cast<int>(instance_attributes(fast::spatial_table_fast_kernel<S>,
                                                fast::prepare<S>(), S::kThreads,
                                                S::kSmemBytes, S::kCluster, out));
  });
}

// wmat is packed for the instance spatial_table_plan names (the wrapper's
// pack_fast with spatial_table_mlp_chunk's chunk, in 8 x 8 core matrices
// for the fast instance and 8 x 16 tiles for the f32 one, or
// pack_general); the fast and f32 ones need 16-byte-aligned pointers.
int spatial_table_bf16(const void* tokens, const void* base, const void* wmat,
                       const void* wln, void* out, int T, int n_off, int N, int D,
                       int depth, int H, int dh, int M, float scale, void* stream) {
  if (spatial_table_plan(N, D, H, dh, M, 2) > 0)
    return fast::with_instance(N, D, dh, 0, [&](auto s) {
      return fast::launch<decltype(s)>(tokens, base, wmat, wln, out, T, n_off, N, depth, H,
                                       M, scale, stream);
    });
  return launch<bf16>(tokens, base, wmat, wln, out, T, n_off, N, D, depth, H, dh, M,
                      scale, stream);
}

int spatial_table_f32(const void* tokens, const void* base, const void* wmat,
                      const void* wln, void* out, int T, int n_off, int N, int D,
                      int depth, int H, int dh, int M, float scale, void* stream) {
  if (spatial_table_plan(N, D, H, dh, M, 4) > 0)
    return tf32::with_instance(N, D, dh, 0, [&](auto s) {
      return tf32::launch<decltype(s)>(tokens, base, wmat, wln, out, T, n_off, N, depth, H,
                                       M, scale, stream);
    });
  return launch<float>(tokens, base, wmat, wln, out, T, n_off, N, D, depth, H, dh, M,
                       scale, stream);
}

}  // extern "C"
