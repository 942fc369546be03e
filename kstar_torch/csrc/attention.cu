// Fused small-sequence attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kstar_tpu/ops/attention.py
// `fused_attention` / `_attn_kernel`: for each (b, h) row of (B, H, N, D)
// inputs, out = softmax(q k^T * scale) v with every product, the softmax
// and the sum in f32, cast to the input type at the end.
//
// What bounds it: ViViT's shapes are short sequences (N 65 spatial, 22
// temporal) with d_head 64, ~4 N^2 D operations against 4 N D elements
// moved per row, so the call is bound by bytes: q, k, v read once and o
// written once. What a kernel can lose on top is latency (a row is a few
// KB, so one block's life is load -> compute -> store with nothing to
// overlap but other blocks) and, for the products, the shared-memory rate
// if they run as scalar FMAs.
//
// Design: the TPU kernel pads N to the 128-lane tile and holds one whole
// row in VMEM. Here three hand-written instances share the interface, chosen
// in the C launcher by shape and alignment (fused_attention_plan):
//
//  * bf16 with D in {16, 32, 64, 128} and 16-byte-aligned rows: the
//    tensor-core instance. One block owns up to 128 queries of one (b, h)
//    row, one warp per 16-query strip (ceil(N / 16) warps, at most 8). Q and
//    a block of K and V are copied to shared memory in bf16 with 16-byte
//    cp.async, and each warp runs the register-resident core of
//    attn_core.cuh: S = Q K^T and P V on mma.sync.m16n8k16, softmax on the
//    accumulator fragments, P as a hi + lo pair of bf16 fragments (see the
//    header for why). A row of up to 128 keys is one block of keys, so
//    there is no block barrier between the loads' arrival and the final
//    store; longer rows walk blocks of 128 keys with the online softmax. The
//    key block is compiled at 32, 80 and 128 keys so that a short row does
//    not carry 64 score registers. The output strip is staged in the strip's
//    own (already consumed) Q rows and leaves with 16-byte stores.
//  * f32 with D in {16, 32, 64, 128}, 16-byte-aligned rows and N <= 80:
//    the same tensor-core design in split TF32 (attn_strip_block_f32 in
//    attn_core.cuh) over one block of 32 or 80 keys. Q, K and V are copied
//    to shared memory in f32 with 16-byte cp.async (Q and K rows at a
//    stride of 16 mod 32 floats, V at 4 mod 32, for conflict-free fragment
//    loads); each warp's strip splits its fragments into hi + lo TF32 pairs
//    as it loads them and runs S = Q K^T and P V as three m16n8k8 TF32
//    products each (lo hi, hi lo, hi hi), with P unnormalised and split the
//    same way. Every product term is off by ~2^-21 relative (the header's
//    argument), so the f32 tolerance of 2e-5 holds; a single TF32 product
//    (~2^-11) would break it. The split costs six MMAs where bf16 runs one
//    or two, but the call is bound by bytes (f32 moves twice bf16's), not by
//    these products. The scores are summed a k step at a time and added in
//    f32 (kStepSums, attn_core.cuh), since the MMA's accumulator truncates.
//    Past 80 keys f32 stays on the scalar instance: with logits near 80 at
//    N 130 and 300 (tests/test_torch_cuda_kernels.py, large logits) it
//    keeps within 2e-5 of the plain version, where this design, before its
//    scores were summed by k step, landed 2.6e-5 and 3.7e-5 on the H100.
//    ViViT's f32 rows are 22 and 65 long, one block of keys.
//  * f32 and bf16 at any other D <= 256 or alignment, and f32 past 80
//    keys: scalar FMAs in f32,
//    register-tiled: tiles of 32 queries x 64 keys, each thread a 4 x 4
//    query-by-key tile of the scores and a 4 x 4 query-by-column tile of
//    P V, so eight shared loads feed sixteen FMAs; online softmax across
//    key tiles. Tiles are filled one warp per row (coalesced, no index
//    division), and warps and key columns wholly past the sequence's end
//    are skipped.

#include "attn_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// tensor-core instance (bf16)
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 8;                 // 128 queries per block

// 16-byte cp.async of `rows` rows of D elements (bf16 or f32) from src
// (row stride D) into dst (row stride ld)
template <int D, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, int ld, const T* src, int rows) {
  constexpr int kVec = 16 / sizeof(T), kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + r * ld + c)),
                 "l"(src + static_cast<size_t>(r) * D + c));
  }
}

template <int D, int KT16>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N,
                     float scale) {
  constexpr int kLd = D + 8;                 // 16 bytes of padding per row
  constexpr int kKeys = KT16 * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);        // 16 * nwarps rows
  bf16* Ks = Qs + nwarps * 16 * kLd;                   // kKeys rows
  bf16* Vs = Ks + kKeys * kLd;                         // kKeys rows

  const size_t row = static_cast<size_t>(blockIdx.x) * N * D;
  const int q0 = blockIdx.y * (kMaxWarps * 16);
  const int nq = min(N - q0, nwarps * 16);
  copy_rows_async<D>(Qs, kLd, q + row + static_cast<size_t>(q0) * D, nq);

  uint32_t qf[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kKeys) {
    const int nk = min(N - k0, kKeys);
    if (k0 > 0) __syncthreads();             // the previous key block is consumed
    copy_rows_async<D>(Ks, kLd, k + row + static_cast<size_t>(k0) * D, nk);
    copy_rows_async<D>(Vs, kLd, v + row + static_cast<size_t>(k0) * D, nk);
    // V rows up to the next multiple of 16 enter P V with p = 0: make them 0
    const int pad_rows = ((nk + 15) & ~15) - nk;
    for (int i = threadIdx.x; i < pad_rows * (D / 8); i += blockDim.x)
      *reinterpret_cast<uint4*>(Vs + (nk + i / (D / 8)) * kLd + (i % (D / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (k0 == 0) attn_load_q<D>(qf, Qs + warp * 16 * kLd, kLd);
    if (warp * 16 < nq)
      attn_strip_block<D, KT16, kPHiLo>(qf, Ks, Vs, kLd, nk, scale, m, l, acc);
  }

  // stage the strip in its own Q rows (only this warp reads or writes them
  // after the fragments were loaded), then 16 bytes per lane to global
  if (warp * 16 >= nq) return;
  __syncwarp();
  bf16* stage = Qs + warp * 16 * kLd;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<uint32_t*>(stage + g * kLd + t * 8 + c2) =
        pack_bf16(acc[t][0] * inv0, acc[t][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + t * 8 + c2) =
        pack_bf16(acc[t][2] * inv1, acc[t][3] * inv1);
  }
  __syncwarp();
  bf16* dst = o + row + static_cast<size_t>(q0 + warp * 16) * D;
  const int rows = min(16, nq - warp * 16);
  for (int i = lane; i < rows * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * D + c) =
        *reinterpret_cast<const uint4*>(stage + r * kLd + c);
  }
}

template <int D, int KT16>
int launch_mma(const void* q, const void* k, const void* v, void* o, int rows, int N,
               float scale, cudaStream_t stream) {
  const int nwarps = min(kMaxWarps, (N + 15) / 16);
  const int qtiles = (N + kMaxWarps * 16 - 1) / (kMaxWarps * 16);
  const size_t bytes = static_cast<size_t>(nwarps * 16 + 2 * KT16 * 16) * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<D, KT16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_mma_kernel<D, KT16><<<dim3(rows, qtiles), nwarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), N, scale);
  return cudaGetLastError();
}

template <int D>
int launch_mma_d(const void* q, const void* k, const void* v, void* o, int rows, int N,
                 float scale, cudaStream_t stream) {
  if (N <= 32) return launch_mma<D, 2>(q, k, v, o, rows, N, scale, stream);
  if (N <= 80) return launch_mma<D, 5>(q, k, v, o, rows, N, scale, stream);
  return launch_mma<D, 8>(q, k, v, o, rows, N, scale, stream);
}

// ---------------------------------------------------------------------------
// tensor-core instance (f32, split TF32)
// ---------------------------------------------------------------------------

// Row strides in floats: Q and K are read as float4 fragments (16 mod 32),
// V as single words at rows 2t, 2t + 1 (4 mod 32); both keep 16-byte rows.
template <int D> struct Tf32Ld {
  static constexpr int kQk = D % 32 == 0 ? D + 16 : D + 32;
  static constexpr int kV = D + 4;
};

template <int D, int KT16>
__host__ __device__ constexpr size_t tf32_smem_bytes(int nwarps) {
  return (static_cast<size_t>(nwarps * 16 + KT16 * 16) * Tf32Ld<D>::kQk +
          static_cast<size_t>(KT16 * 16) * Tf32Ld<D>::kV) * sizeof(float);
}

template <int D, int KT16>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int N,
                      float scale) {
  constexpr int kLd = Tf32Ld<D>::kQk, kLdv = Tf32Ld<D>::kV;
  constexpr int kKeys = KT16 * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qs = reinterpret_cast<float*>(smem_raw);      // 16 * nwarps rows
  float* Ks = Qs + nwarps * 16 * kLd;                  // kKeys rows
  float* Vs = Ks + kKeys * kLd;                        // kKeys rows, stride kLdv

  const size_t row = static_cast<size_t>(blockIdx.x) * N * D;
  const int nq = N;                                    // one block holds every query
  copy_rows_async<D>(Qs, kLd, q + row, nq);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  // all N <= kKeys keys are one block (the launcher's plan)
  copy_rows_async<D>(Ks, kLd, k + row, N);
  copy_rows_async<D>(Vs, kLdv, v + row, N);
  // V rows up to the next multiple of 16 enter P V with p = 0: make them 0
  const int pad_rows = ((N + 15) & ~15) - N;
  for (int i = threadIdx.x; i < pad_rows * (D / 4); i += blockDim.x)
    *reinterpret_cast<float4*>(Vs + (N + i / (D / 4)) * kLdv + (i % (D / 4)) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (warp * 16 < nq)
    attn_strip_block_f32<D, KT16>(Qs + warp * 16 * kLd, kLd, Ks, kLd, Vs, kLdv, N, scale, m,
                                  l, acc);

  // stage the strip in its own Q rows (only this warp reads or writes them),
  // then 16 bytes per lane to global
  if (warp * 16 >= nq) return;
  __syncwarp();
  float* stage = Qs + warp * 16 * kLd;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<float2*>(stage + g * kLd + t * 8 + c2) =
        make_float2(acc[t][0] * inv0, acc[t][1] * inv0);
    *reinterpret_cast<float2*>(stage + (g + 8) * kLd + t * 8 + c2) =
        make_float2(acc[t][2] * inv1, acc[t][3] * inv1);
  }
  __syncwarp();
  float* dst = o + row + static_cast<size_t>(warp * 16) * D;
  const int rows = min(16, nq - warp * 16);
  for (int i = lane; i < rows * (D / 4); i += 32) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * D + c) =
        *reinterpret_cast<const float4*>(stage + r * kLd + c);
  }
}

template <int D, int KT16>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int rows, int N,
                float scale, cudaStream_t stream) {
  const int nwarps = (N + 15) / 16;                    // N <= 80: at most 5 strips
  const size_t bytes = tf32_smem_bytes<D, KT16>(nwarps);
  cudaError_t err = cudaFuncSetAttribute(attention_tf32_kernel<D, KT16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_tf32_kernel<D, KT16><<<rows, nwarps * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, scale);
  return cudaGetLastError();
}

template <int D>
int launch_tf32_d(const void* q, const void* k, const void* v, void* o, int rows, int N,
                  float scale, cudaStream_t stream) {
  if (N <= 32) return launch_tf32<D, 2>(q, k, v, o, rows, N, scale, stream);
  return launch_tf32<D, 5>(q, k, v, o, rows, N, scale, stream);
}

// ---------------------------------------------------------------------------
// scalar instance (f32 and bf16 at the shapes the tensor-core ones leave)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kQ = 32;      // query rows per tile: 8 thread rows x 4
constexpr int kK = 64;      // keys per tile: 16 thread columns x 4

__host__ __device__ constexpr size_t scalar_smem_floats(int D) {
  // Q and K tiles (rows padded to D+1), V and O tiles, the probabilities
  return static_cast<size_t>(kQ) * (D + 1) + kK * (D + 1) + kK * D + kQ * D +
         kQ * (kK + 1);
}

// max / sum over the 16 consecutive lanes that share four query rows
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int N, int D,
                        float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;                    // kQ x (D+1)
  float* Ks = Qs + kQ * (D + 1);     // kK x (D+1)
  float* Vs = Ks + kK * (D + 1);     // kK x D
  float* Os = Vs + kK * D;           // kQ x D
  float* Ps = Os + kQ * D;           // kQ x (kK+1)

  const size_t row = static_cast<size_t>(blockIdx.x) * N * D;
  const T* qr = q + row;
  const T* kr = k + row;
  const T* vr = v + row;
  T* orow = o + row;
  const int tid = threadIdx.x;
  // thread (ty, tx): queries ty*4 + i, keys and output columns tx + 16*u.
  // The 16 lanes of a half warp share ty, so a query row's softmax and its
  // probabilities stay inside one warp.
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.y * kQ;
  const int nq = N - q0 < kQ ? N - q0 : kQ;

  // one warp per row, lanes along the row: coalesced, no index division
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = warp; rr < kQ; rr += kThreads / 32)
    for (int c = lane; c < D; c += 32) {
      Qs[rr * (D + 1) + c] = rr < nq ? to_f<T>(qr[static_cast<size_t>(q0 + rr) * D + c]) : 0.f;
      Os[rr * D + c] = 0.f;
    }
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kK) {
    const int nk = N - k0 < kK ? N - k0 : kK;
    __syncthreads();  // the previous key tile is consumed (and Q, O are set)
    // a warp whose eight query rows are all past the tile's end has nothing
    // to compute, and key columns past nk (in sixteens) are skipped: rows of
    // the key tile past nu * 16 are never read
    const bool active = warp * 8 < nq;
    const int nu = (nk + 15) / 16;
    for (int rr = warp; rr < nu * 16; rr += kThreads / 32) {
      const bool real = rr < nk;
      for (int c = lane; c < D; c += 32) {
        Ks[rr * (D + 1) + c] = real ? to_f<T>(kr[static_cast<size_t>(k0 + rr) * D + c]) : 0.f;
        Vs[rr * D + c] = real ? to_f<T>(vr[static_cast<size_t>(k0 + rr) * D + c]) : 0.f;
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[i][u] = 0.f;
    const float* a = Qs + ty * 4 * (D + 1);
    const float* b = Ks + tx * (D + 1);
#pragma unroll 4
    for (int c = 0; active && c < D; ++c) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[i * (D + 1) + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) bv[u] = u < nu ? b[u * 16 * (D + 1) + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nu) sc[i][u] = fmaf(av[i], bv[u], sc[i][u]);
    }
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sc[i][u] = tx + 16 * u < nk ? sc[i][u] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][u]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));
      corr[i] = expf(m_run[i] - m_new);        // 0 on the first key tile
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = expf(sc[i][u] - m_new);   // 0 for a masked key
        Ps[(ty * 4 + i) * (kK + 1) + tx + 16 * u] = p;
        psum += p;
      }
      l_run[i] = l_run[i] * corr[i] + half_warp_sum(psum);
      m_run[i] = m_new;
    }
    __syncwarp();   // a query row's probabilities come from its own half warp

    const float* p = Ps + ty * 4 * (kK + 1);
    for (int cb = 0; active && cb < D; cb += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = cb + tx + 16 * u;
          acc[i][u] = c < D ? Os[(ty * 4 + i) * D + c] * corr[i] : 0.f;
        }
#pragma unroll 2
      for (int j = 0; j < nk; ++j) {
        float pv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = p[i * (kK + 1) + j];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = cb + tx + 16 * u;
          vv[u] = c < D ? Vs[j * D + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(pv[i], vv[u], acc[i][u]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = cb + tx + 16 * u;
          if (c < D) Os[(ty * 4 + i) * D + c] = acc[i][u];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < nq)
      for (int c = tx; c < D; c += 16)
        orow[static_cast<size_t>(q0 + r) * D + c] = from_f<T>(Os[r * D + c] / l_run[i]);
  }
}

template <typename T>
int launch_scalar(const void* q, const void* k, const void* v, void* o, int rows, int N,
                  int D, float scale, cudaStream_t stream) {
  const size_t bytes = scalar_smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_scalar_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_scalar_kernel<T><<<dim3(rows, (N + kQ - 1) / kQ), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, D, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Which instance a call takes: 0 the scalar one; otherwise the tensor-core
// one of the element type (bf16, or f32 in split TF32 up to 80 keys), the
// value being its key block (32, 80 or 128 keys).
int fused_attention_plan(int N, int D, int elem_bytes, int aligned) {
  if ((elem_bytes != 2 && elem_bytes != 4) || !aligned ||
      (D != 16 && D != 32 && D != 64 && D != 128) || (elem_bytes == 4 && N > 80))
    return 0;
  return N <= 32 ? 32 : N <= 80 ? 80 : 128;
}

int fused_attention_bf16(const void* q, const void* k, const void* v, void* o, int rows,
                         int N, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  if (fused_attention_plan(N, D, 2, aligned) == 0)
    return launch_scalar<bf16>(q, k, v, o, rows, N, D, scale, s);
  switch (D) {
    case 16: return launch_mma_d<16>(q, k, v, o, rows, N, scale, s);
    case 32: return launch_mma_d<32>(q, k, v, o, rows, N, scale, s);
    case 64: return launch_mma_d<64>(q, k, v, o, rows, N, scale, s);
    default: return launch_mma_d<128>(q, k, v, o, rows, N, scale, s);
  }
}

int fused_attention_f32(const void* q, const void* k, const void* v, void* o, int rows,
                        int N, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  if (fused_attention_plan(N, D, 4, aligned) == 0)
    return launch_scalar<float>(q, k, v, o, rows, N, D, scale, s);
  switch (D) {
    case 16: return launch_tf32_d<16>(q, k, v, o, rows, N, scale, s);
    case 32: return launch_tf32_d<32>(q, k, v, o, rows, N, scale, s);
    case 64: return launch_tf32_d<64>(q, k, v, o, rows, N, scale, s);
    default: return launch_tf32_d<128>(q, k, v, o, rows, N, scale, s);
  }
}

}  // extern "C"
