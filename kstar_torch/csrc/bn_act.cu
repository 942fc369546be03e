// BatchNorm (evaluation), LeakyReLU and the cast to bf16 of a conv output, in
// one pass, with an optional residual join, for Hopper (sm_90a).
//
// Replaces no TPU kernel: XLA fuses the JAX package's chain
// (kstar_tpu/models/r2plus1d.py Conv3dBN, STResBlock) on its own. Eager
// PyTorch runs it as six full-tensor passes in f32 (cast, subtract, multiply,
// add, LeakyReLU, cast back; ~44 bytes of device memory an element) and the
// residual blocks' join as two more. This kernel reads each bf16 element once
// and writes it once. For channels-last x (n, C) bf16 it computes, in f32,
//   y   = ((x - mean[c]) * mul[c]) + bias[c];  y = y > 0 ? y : alpha * y
//   out = bf16(y)
// and with a residual r of the same shape goes on
//   s   = bf16(float(out) + float(r));  out = bf16(s > 0 ? s : alpha * s)
// Every operation rounds as the eager chain's own kernel does (__fsub_rn,
// __fmul_rn, __fadd_rn: nothing contracts into an FMA; round to nearest even
// into bf16), so the result equals the eager chain bit for bit. `mul` is
// rsqrt(var + eps) * weight as PyTorch computed it; `alpha` is the f32 value
// PyTorch's leaky_relu takes.
//
// What bounds it: bytes, 4 an element (6 with the residual). Design: a
// thread moves 16-byte vectors (8 bf16). The grid strides by a number of
// vectors that is a multiple of C / gcd(C, 8), so every vector a thread
// visits starts at the same channel: the thread finds its 8 channels with one
// division and keeps their mean, mul and bias in registers for the whole
// pass (an odd C makes a vector span a channel boundary: the 8 channels wrap
// at C). Loads are unrolled 4 deep for bytes in flight. The n % 8 elements
// past the last whole vector are done one by one by block 0. The wrapper
// (kstar_torch/ops/bn_act.py) checks types, shapes, contiguity and 16-byte
// alignment; the launcher sizes the grid.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;       // bf16 per 16-byte vector
constexpr int kUnroll = 4;    // vectors in flight per thread

__device__ __forceinline__ float bn_leaky(float x, float mean, float mul, float bias,
                                          float alpha) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
  return y > 0.f ? y : __fmul_rn(y, alpha);
}

// bf16(y), then with a residual the join: bf16(LeakyReLU(bf16(out + r)))
template <bool kResidual>
__device__ __forceinline__ bf16 finish(float y, bf16 r, float alpha) {
  const bf16 out = __float2bfloat16_rn(y);
  if (!kResidual) return out;
  const float s =
      __bfloat162float(__float2bfloat16_rn(__fadd_rn(__bfloat162float(out), __bfloat162float(r))));
  return __float2bfloat16_rn(s > 0.f ? s : __fmul_rn(s, alpha));
}

template <bool kResidual>
__device__ __forceinline__ uint4 vector_epilogue(uint4 xv, uint4 rv, const float* m,
                                                 const float* k, const float* b, float alpha) {
  const bf16* xs = reinterpret_cast<const bf16*>(&xv);
  const bf16* rs = reinterpret_cast<const bf16*>(&rv);
  uint4 o;
  bf16* os = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    os[j] = finish<kResidual>(bn_leaky(__bfloat162float(xs[j]), m[j], k[j], b[j], alpha), rs[j],
                              alpha);
  return o;
}

template <bool kResidual>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res, bf16* __restrict__ out,
              const float* __restrict__ mean, const float* __restrict__ mul,
              const float* __restrict__ bias, long long n, int C, float alpha) {
  const long long n_vec = n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < n - n_vec * kVec) {   // the ragged tail
    const long long e = n_vec * kVec + threadIdx.x;
    const int c = static_cast<int>(e % C);
    out[e] = finish<kResidual>(bn_leaky(__bfloat162float(x[e]), mean[c], mul[c], bias[c], alpha),
                               kResidual ? res[e] : x[e], alpha);
  }
  if (v >= n_vec) return;
  float m[kVec], k[kVec], b[kVec];
  int c = static_cast<int>((v * kVec) % C);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    m[j] = mean[c];
    k[j] = mul[c];
    b[j] = bias[c];
    if (++c == C) c = 0;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(res);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (; v + (kUnroll - 1) * stride < n_vec; v += kUnroll * stride) {
    uint4 xs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xs[u] = __ldcs(xv + v + u * stride);
      rs[u] = kResidual ? __ldcs(rv + v + u * stride) : xs[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ov[v + u * stride] = vector_epilogue<kResidual>(xs[u], rs[u], m, k, b, alpha);
  }
  for (; v < n_vec; v += stride) {
    const uint4 xs = __ldcs(xv + v);
    const uint4 rs = kResidual ? __ldcs(rv + v) : xs;
    ov[v] = vector_epilogue<kResidual>(xs, rs, m, k, b, alpha);
  }
}

template <bool kResidual>
int launch(const void* x, const void* res, void* out, const void* mean, const void* mul,
           const void* bias, long long n, int C, float alpha, cudaStream_t stream) {
  // a full wave of resident blocks, found once per device (the card's SMs
  // times the kernel's occupancy); 0 marks a device not yet looked up
  static int wave[64];
  int dev = 0, err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int full = dev < 64 ? wave[dev] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_act_kernel<kResidual>,
                                                            kThreads, 0)))
      return err;
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) wave[dev] = full;
  }
  // one vector a thread where a wave covers them all; else a multiple of
  // C / gcd(C, 8 * kThreads) blocks, so the stride keeps each thread's channels
  const long long cover = (n / kVec + kThreads - 1) / kThreads;
  long long blocks = cover > 0 ? cover : 1;
  if (cover > full) {
    int a = C, b = kVec * kThreads;
    while (b) { const int t = a % b; a = b; b = t; }
    const long long g = C / a;
    blocks = full >= g ? full / g * g : g;
  }
  bn_act_kernel<kResidual><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(res), static_cast<bf16*>(out),
      static_cast<const float*>(mean), static_cast<const float*>(mul),
      static_cast<const float*>(bias), n, C, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, res (null for none), out: (n / C, C) bf16, contiguous, 16-byte aligned;
// mean, mul, bias: (C,) f32 on the same device; n > 0.
int bn_act_bf16(const void* x, const void* res, void* out, const void* mean, const void* mul,
                const void* bias, long long n, int C, float alpha, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return res != nullptr ? launch<true>(x, res, out, mean, mul, bias, n, C, alpha, s)
                        : launch<false>(x, res, out, mean, mul, bias, n, C, alpha, s);
}

}  // extern "C"
