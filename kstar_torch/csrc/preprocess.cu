// Sliding-window gather + normalise for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kstar_tpu/ops/preprocess.py
// `gather_normalize_pallas` / `_window_kernel`: frames (T, H, W, 3) uint8
// and window starts (B,) give (B, L, H, W, 3) in bf16 or f32,
//   out[b, t] = frames[clip(starts[b] + 1 + t, 0, T - 1)] - mean,
// the channel of a pixel byte being its flat index within the frame % 3.
// uint8 values, the integer means and their differences are exact in bf16,
// so the result equals subtract-in-f32-then-round bit for bit.
//
// What bounds it: bytes. Every output element is written once (2 or 4
// bytes) from one input byte, and the B windows overlap, so the distinct
// frames read are a small fraction of the bytes written and mostly come
// from L2.
//
// Design: the TPU kernel copies one window's frames into VMEM with one DMA
// per frame and normalises the tile there. Here there is no staging: a
// thread loads the input bytes that fill one 16-byte store (8 bytes for
// bf16, 4 for f32), subtracts the channel means in registers and stores the
// vector, so both the loads and the stores of a warp are contiguous. The
// channel phase of a chunk follows from its byte offset within the frame.
// One block row (blockIdx.x) is one (window, frame) pair and computes its
// clipped source frame once; blockIdx.y walks the frame. A frame size that
// is not a multiple of the chunk, or a pointer that is not aligned to it,
// takes the one-byte-per-thread variant of the same kernel, chosen in
// `launch`. Offsets are 64-bit: a shot is hundreds of megabytes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // chunks per thread

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float byte_of(uint32_t w, int j) {
  return static_cast<float>((w >> (8 * j)) & 0xffu);
}

// One chunk: V input bytes at `in` whose first byte has channel mean m0, the
// next m1, then m2, then m0 again.
template <typename T, int V> struct Chunk;

template <typename T> struct Chunk<T, 1> {
  static __device__ __forceinline__ void run(const uint8_t* in, T* out, float m0, float,
                                             float) {
    *out = from_f<T>(static_cast<float>(*in) - m0);
  }
};

template <> struct Chunk<bf16, 8> {
  static __device__ __forceinline__ void run(const uint8_t* in, bf16* out, float m0,
                                             float m1, float m2) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(in));
    uint4 r;
    r.x = pack_bf16(byte_of(w.x, 0) - m0, byte_of(w.x, 1) - m1);
    r.y = pack_bf16(byte_of(w.x, 2) - m2, byte_of(w.x, 3) - m0);
    r.z = pack_bf16(byte_of(w.y, 0) - m1, byte_of(w.y, 1) - m2);
    r.w = pack_bf16(byte_of(w.y, 2) - m0, byte_of(w.y, 3) - m1);
    *reinterpret_cast<uint4*>(out) = r;
  }
};

template <> struct Chunk<float, 4> {
  static __device__ __forceinline__ void run(const uint8_t* in, float* out, float m0,
                                             float m1, float m2) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(in));
    *reinterpret_cast<float4*>(out) = make_float4(byte_of(w, 0) - m0, byte_of(w, 1) - m1,
                                                  byte_of(w, 2) - m2, byte_of(w, 3) - m0);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gather_normalize_kernel(const uint8_t* __restrict__ frames,
                        const long long* __restrict__ starts, T* __restrict__ out,
                        long long n_frames, int L, int frame_bytes, float mean0,
                        float mean1, float mean2) {
  const int bt = blockIdx.x;                  // (window, frame in window)
  long long src = starts[bt / L] + 1 + bt % L;
  src = src < 0 ? 0 : (src > n_frames - 1 ? n_frames - 1 : src);
  const uint8_t* in = frames + static_cast<size_t>(src) * frame_bytes;
  T* o = out + static_cast<size_t>(bt) * frame_bytes;
  const int n_chunks = frame_bytes / V;
  const int c0 = blockIdx.y * (kThreads * kUnroll) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int c = c0 + u * kThreads;
    if (c < n_chunks) {
      const int phase = (c * V) % 3;          // channel of the chunk's first byte
      const float m0 = phase == 0 ? mean0 : (phase == 1 ? mean1 : mean2);
      const float m1 = phase == 0 ? mean1 : (phase == 1 ? mean2 : mean0);
      const float m2 = phase == 0 ? mean2 : (phase == 1 ? mean0 : mean1);
      Chunk<T, V>::run(in + c * V, o + static_cast<size_t>(c) * V, m0, m1, m2);
    }
  }
}

template <typename T, int V>
int launch_v(const void* frames, const void* starts, void* out, long long n_frames, int B,
             int L, int frame_bytes, float m0, float m1, float m2, void* stream) {
  const int n_chunks = frame_bytes / V;
  const int per_block = kThreads * kUnroll;
  const dim3 grid(B * L, (n_chunks + per_block - 1) / per_block);
  gather_normalize_kernel<T, V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const long long*>(starts),
      static_cast<T*>(out), n_frames, L, frame_bytes, m0, m1, m2);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* frames, const void* starts, void* out, long long n_frames, int B,
           int L, int frame_bytes, float m0, float m1, float m2, void* stream) {
  constexpr int V = 16 / sizeof(T);           // input bytes per 16-byte store
  const bool vector = frame_bytes % V == 0 &&
                      reinterpret_cast<uintptr_t>(frames) % V == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vector ? launch_v<T, V>(frames, starts, out, n_frames, B, L, frame_bytes, m0, m1,
                                 m2, stream)
                : launch_v<T, 1>(frames, starts, out, n_frames, B, L, frame_bytes, m0, m1,
                                 m2, stream);
}

}  // namespace

extern "C" {

// frames (n_frames, frame_bytes) uint8, starts (B,) int64, out (B, L,
// frame_bytes); frame_bytes = H * W * 3; mean0..2 are the channel means.
int gather_normalize_bf16(const void* frames, const void* starts, void* out,
                          long long n_frames, int B, int L, int frame_bytes, float mean0,
                          float mean1, float mean2, void* stream) {
  return launch<bf16>(frames, starts, out, n_frames, B, L, frame_bytes, mean0, mean1, mean2,
                      stream);
}

int gather_normalize_f32(const void* frames, const void* starts, void* out,
                         long long n_frames, int B, int L, int frame_bytes, float mean0,
                         float mean1, float mean2, void* stream) {
  return launch<float>(frames, starts, out, n_frames, B, L, frame_bytes, mean0, mean1, mean2,
                       stream);
}

}  // extern "C"
