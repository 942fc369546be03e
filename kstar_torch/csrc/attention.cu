// Fused small-sequence attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kstar_tpu/ops/attention.py
// `fused_attention` / `_attn_kernel`: for each (b, h) row of (B, H, N, D)
// inputs, out = softmax(q k^T * scale) v with every product, the softmax
// and the sum in f32, cast to the input type at the end.
//
// What bounds it: ViViT's shapes are short sequences (N 65 spatial, 22
// temporal) with d_head 64, ~4 N^2 D operations against 4 N D elements
// moved per row, so the call is memory-bound: q, k, v read once and o
// written once.
//
// Design: the TPU kernel pads N to the 128-lane tile and holds one whole
// row in VMEM. Here one block owns one (b, h) row and walks it in tiles of
// 32 queries x 32 keys with an online softmax (running max and sum in f32),
// so any N runs without padding and keys past N are never read, which is
// the TPU kernel's key mask. Four threads share a query row: each scores
// eight keys and accumulates every fourth output column, with independent
// accumulators so the FMAs overlap; the row's running max and sum are
// combined with warp shuffles. Shared memory holds a few 32 x D f32 tiles,
// so D up to 256 fits.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 32;      // query rows per tile
constexpr int kK = 32;      // keys per tile
constexpr int kSplit = 4;   // threads per query row
constexpr int kKeysPerThread = kK / kSplit;

__host__ __device__ constexpr size_t smem_floats(int D) {
  // Q, K (rows padded to D+1), V and O tiles, and the probabilities
  return static_cast<size_t>(kQ) * (D + 1) + kK * (D + 1) + kK * D + kQ * D +
         kQ * (kK + 1);
}

// max / sum over the kSplit consecutive lanes that share a query row
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int N, int D, float scale) {
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
  const int r = tid / kSplit, s = tid % kSplit;   // query row, slot in the row

  for (int q0 = 0; q0 < N; q0 += kQ) {
    const int nq = N - q0 < kQ ? N - q0 : kQ;
    __syncthreads();  // previous query tile fully consumed
#pragma unroll 8
    for (int i = tid; i < nq * D; i += blockDim.x) {
      const int rr = i / D, c = i % D;
      Qs[rr * (D + 1) + c] = to_f<T>(qr[(q0 + rr) * D + c]);
      Os[rr * D + c] = 0.f;
    }
    float m_run = -INFINITY, l_run = 0.f;
    for (int k0 = 0; k0 < N; k0 += kK) {
      const int nk = N - k0 < kK ? N - k0 : kK;
      __syncthreads();  // previous key tile fully consumed
#pragma unroll 8
      for (int i = tid; i < nk * D; i += blockDim.x) {
        const int rr = i / D, c = i % D;
        Ks[rr * (D + 1) + c] = to_f<T>(kr[(k0 + rr) * D + c]);
        Vs[rr * D + c] = to_f<T>(vr[(k0 + rr) * D + c]);
      }
      __syncthreads();

      // scores of keys j = s + kSplit * u; rows past nq are computed on
      // whatever the tile holds and never stored
      float sc[kKeysPerThread];
#pragma unroll
      for (int u = 0; u < kKeysPerThread; ++u) sc[u] = 0.f;
      const float* a = Qs + r * (D + 1);
      for (int c = 0; c < D; ++c) {
        const float av = a[c];
#pragma unroll
        for (int u = 0; u < kKeysPerThread; ++u)
          sc[u] = fmaf(av, Ks[(s + kSplit * u) * (D + 1) + c], sc[u]);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKeysPerThread; ++u) {
        sc[u] = s + kSplit * u < nk ? sc[u] * scale : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      const float m_new = fmaxf(m_run, group_max(mx));
      const float corr = expf(m_run - m_new);     // 0 on the first key tile
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kKeysPerThread; ++u) {
        const float p = s + kSplit * u < nk ? expf(sc[u] - m_new) : 0.f;
        Ps[r * (kK + 1) + s + kSplit * u] = p;
        psum += p;
      }
      l_run = l_run * corr + group_sum(psum);
      m_run = m_new;
      __syncwarp();   // the row's probabilities come from its own four lanes

      // output columns c = s + kSplit * u, four at a time
      if (r < nq) {
        const float* p = Ps + r * (kK + 1);
        float* orow_s = Os + r * D;
        for (int cb = s; cb < D; cb += 4 * kSplit) {
          float acc[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = cb + kSplit * u;
            acc[u] = c < D ? orow_s[c] * corr : 0.f;
          }
          for (int j = 0; j < nk; ++j) {
            const float pj = p[j];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int c = cb + kSplit * u;
              if (c < D) acc[u] = fmaf(pj, Vs[j * D + c], acc[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = cb + kSplit * u;
            if (c < D) orow_s[c] = acc[u];
          }
        }
      }
    }
    if (r < nq)
      for (int c = s; c < D; c += kSplit)
        orow[(q0 + r) * D + c] = from_f<T>(Os[r * D + c] / l_run);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int rows, int N,
           int D, float scale, void* stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_kernel<T><<<rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_attention_bf16(const void* q, const void* k, const void* v, void* o, int rows,
                         int N, int D, float scale, void* stream) {
  return launch<bf16>(q, k, v, o, rows, N, D, scale, stream);
}

int fused_attention_f32(const void* q, const void* k, const void* v, void* o, int rows,
                        int N, int D, float scale, void* stream) {
  return launch<float>(q, k, v, o, rows, N, D, scale, stream);
}

}  // extern "C"
