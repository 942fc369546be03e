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
// in and table out, so it is compute-bound on this card (the bf16 tensor
// cores' 989 TFLOP/s, or 67 TFLOP/s for f32 outside them).
//
// Design: the TPU kernel holds all ~1.5 MB of weights and a block of frames
// in VMEM; a Hopper block has 227 KB of shared memory, so here one block
// owns one (offset, frame) pair and keeps only that frame's activations in
// shared memory, in T: the residual x and the LN output h (N x D), one head
// of q, k, v^T (N x d_head) with its f32 scores, an f32 accumulator (N x D)
// that collects the out-projection head by head and FF2 over chunks of 128
// MLP columns. The weights (~1.5 MB at the flagship) stay resident in the
// 50 MB L2 across blocks. In bf16 every product runs on the tensor cores
// through mma.sync m16n8k16 with f32 accumulation, with both operands in
// shared memory: the weight panel each product needs (a head's q, k or v
// columns, its out-projection rows, an FF chunk) is copied in with cp.async
// one product ahead, into one of two buffers, so the copy overlaps the
// product before it. The f32 instantiation (used to hold the algorithm to
// a tight tolerance) uses scalar FMAs and reads the weights from global
// memory. Rows are padded to a multiple of 16 for the MMA tiles; padded
// keys are masked out of the softmax, and padded query rows are computed
// and never stored. wgmma with TMA-fed weight tiles is the next step.

#include "common.cuh"

namespace {

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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
      mma_bf16(c0, a0, a1, a2, a3, ld32(b_0 + k), ld32(b_0 + k + 8));
      mma_bf16(c1, a0, a1, a2, a3, ld32(b_1 + k), ld32(b_1 + k + 8));
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

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (elem_bytes 2 or 4).
long long spatial_table_smem_bytes(int N, int D, int H, int dh, int M, int elem_bytes) {
  const Dims d = make_dims(1, 1, N, D, 1, H, dh, M, 1.f);
  return elem_bytes == 2 ? static_cast<long long>(Layout<bf16>(d).total)
                         : static_cast<long long>(Layout<float>(d).total);
}

int spatial_table_bf16(const void* tokens, const void* base, const void* wmat,
                       const void* wln, void* out, int T, int n_off, int N, int D,
                       int depth, int H, int dh, int M, float scale, void* stream) {
  return launch<bf16>(tokens, base, wmat, wln, out, T, n_off, N, D, depth, H, dh, M,
                      scale, stream);
}

int spatial_table_f32(const void* tokens, const void* base, const void* wmat,
                      const void* wln, void* out, int T, int n_off, int N, int D,
                      int depth, int H, int dh, int M, float scale, void* stream) {
  return launch<float>(tokens, base, wmat, wln, out, T, n_off, N, D, depth, H, dh, M,
                       scale, stream);
}

}  // extern "C"
