// Register-resident tensor-core attention core for Hopper (sm_90a), shared
// by the fused-attention kernel (attention.cu) and the spatial-table kernel
// (spatial_table.cu), with the ldmatrix and mma.sync wrappers both use.
//
// One warp owns a strip of 16 queries of one sequence. Q, K and V sit in
// shared memory in bf16, row-major (one token per row, the head dimension
// contiguous) with a row stride that is an odd multiple of 16 bytes, so the
// eight rows of an ldmatrix tile fall into different banks. The strip's Q
// fragments are loaded once; S = Q K^T runs on mma.sync.m16n8k16 (bf16
// operands, f32 sum) straight into registers; scale, key mask, row max and
// row sum are taken on the accumulator fragments with the quad's shuffles
// (a row of S lives in the four lanes of one quad); the probabilities are
// repacked in registers as the A fragments of P V, and V's B fragments come
// from row-major V through ldmatrix.trans. Scores and probabilities never
// touch shared memory and no block barrier is needed inside a strip.
//
// bf16 x bf16 products are exact in f32, so Q K^T differs from a plain f32
// product only in summation order. P's precision is the caller's choice:
//   kPNormBf16  the probabilities are normalised (e / sum) and rounded to
//               bf16 before P V, the cast point of the spatial-table
//               kernel's plain version; all keys are in one block;
//   kPHiLo      P stays unnormalised and is split into a bf16 pair
//               hi + lo (lo = bf16(p - hi)), two products, ~2^-17 relative:
//               the fused-attention kernel, whose plain version keeps P in
//               f32. A single bf16 P would hold that kernel's tolerance
//               (1e-2 + 1e-2 |x|) on normal inputs but spends it: two keys
//               of p ~ 0.5 against |v| ~ 3 already cost 2^-9 * 3 = 6e-3
//               before the output's own rounding, and the strip-wise
//               arithmetic in plain PyTorch (strip_attention_emulation,
//               tests/test_torch_attention.py) reads two output ulps with
//               one bf16 P (1.56e-2 at |x| ~ 1.5) against one ulp (7.8e-3)
//               with the pair, which equals an f32 P. So the pair it is;
//               the kernel is bound by bytes, not by these products.
// Keys come in blocks of KT16 * 16; with more than one block the running
// max, sum and output are rescaled between blocks (online softmax).
// attn_strip_two_pass keeps kPNormBf16's cast point over any number of key
// blocks: a first pass takes each row's max and sum, a second recomputes
// the scores and multiplies the normalised, rounded P by V.
//
// f32 operands run on the same tensor cores in split TF32
// (attn_strip_block_f32, and the helpers the spatial-table kernel's f32
// products use). A TF32 operand keeps 11 significant bits, so one TF32
// product is off by ~2^-11 relative, far outside the f32 kernels' 2e-5.
// The split rule: x = hi + lo with hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi) (x - hi is exact in f32; |lo| <= 2^-11 |x|, and lo's
// own rounding leaves ~2^-22 |x|). a b = hi_a hi_b + hi_a lo_b + lo_a hi_b
// + lo_a lo_b; the kernels run the first three (the small two first) as
// mma.sync.m16n8k8 products with f32 sums and drop lo_a lo_b (<= 2^-22 |a
// b|), so each term is off by ~2^-21 relative, the order of f32
// summation noise, and the products differ from a plain f32 product by
// summation order and that. The sums: the MMA does not round its f32
// accumulator to nearest (it truncates), so a running sum kept in the
// accumulator across k steps drifts toward zero by up to an ulp of the sum
// at every MMA, three MMAs a k step. A score is the exponent of a
// probability, so that drift becomes P's relative error: with |s| up to 80
// over 64 columns at N 80 the fused-attention kernel sat 2.5e-5 from an
// f64 softmax where the plain f32 version sits 1.5e-5 (H100; the f64 test
// of tests/test_torch_cuda_kernels.py allows the plain version's distance
// plus 1e-5). attn_strip_block_f32 therefore (kStepSums) sums each k step
// from zero on the tensor core and adds it to the running score with an
// f32 add, which rounds to nearest; so summed, the kernel passes that test.
// Fragments come from f32 shared memory as 16-byte
// loads: within a block of 16 columns lane t holds columns 4t .. 4t + 3 of
// its rows, and k step s (0, 1) of the block takes columns 4t + 2s and 4t +
// 2s + 1 as its k indices t and t + 4. Both operands follow the same map, so
// the product is the sum over all 16 columns, and A and B are float4 loads
// (ldmatrix moves 16-bit elements: an f32 fragment would need the b16-pairs
// trick and two loads where one float4 does). Rows read this way have a
// stride of 16 mod 32 floats, so the two rows of a quarter warp fill all 32
// banks. P V takes P from the score fragments in registers, keys 2t and 2t
// + 1 of an 8-key tile as its k indices t and t + 4, so V's B fragment is
// rows 2t and 2t + 1 of a row-major V: single words, conflict-free at a
// stride of 4 mod 32 floats. P stays unnormalised (online softmax) and is
// split like any operand.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 tiles: lane i gives the address of row i % 8 of tile i / 8;
// register j holds tile j, this lane's row lane / 4, columns 2 * (lane % 4)
// and the next (transposed: column lane / 4, rows 2 * (lane % 4) and next).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane offsets (in elements) into a row-major bf16 tile with row stride ld
// for ldmatrix.x4: A operand (16 rows x 16 k), B operand from rows = output
// columns with k contiguous (16 n x 16 k), and B operand from rows = k with
// the output columns contiguous, through ldmatrix.trans (16 k x 16 n). An
// m16n8k16 accumulator fragment holds, in element i, row lane / 4 + 8 *
// (i / 2) and column 2 * (lane % 4) + i % 2 of its 16 x 8 tile.
__device__ __forceinline__ int lane_off_a(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int lane_off_b(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_off_bt(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

enum PMode { kPNormBf16, kPHiLo };

// The strip's Q fragments: 16 rows at qs (stride ld), DH columns.
template <int DH>
__device__ __forceinline__ void attn_load_q(uint32_t (&qf)[DH / 16][4], const bf16* qs,
                                            int ld) {
  const bf16* p = qs + lane_off_a(threadIdx.x & 31, ld);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) ldsm4(qf[kk], p + kk * 16);
}

// One block of keys for one 16-query strip. ks and vs point at the block's
// first key row; n_keys (>= 1) of its KT16 * 16 rows are real, the rest are
// masked out of the softmax (their V rows must be finite, up to the next
// multiple of 16; 16-key tiles wholly past n_keys are skipped, or, with
// kAllTiles, the caller promises n_keys > (KT16 - 1) * 16 and the loops
// carry no branch). m, l and o
// carry the running max, sum and output of the strip's two rows per lane
// (lane / 4 and lane / 4 + 8): start them at -inf, 0, 0. kPHiLo leaves o
// unnormalised (divide by l at the end); kPNormBf16 takes one block only
// and leaves the final output in o.
template <int DH, int KT16, PMode kMode, bool kAllTiles = false>
__device__ __forceinline__ void attn_strip_block(const uint32_t (&qf)[DH / 16][4],
                                                 const bf16* ks, const bf16* vs, int ld,
                                                 int n_keys, float scale, float (&m)[2],
                                                 float (&l)[2], float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2;
  float s[2 * KT16][4];
  const bf16* kp = ks + lane_off_b(lane, ld);
#pragma unroll
  for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[t][i] = 0.f;
  // k step outside, key tile inside: neighbouring MMAs add to different
  // accumulators, so they do not wait for each other
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int kt = 0; kt < KT16; ++kt) {
      if (kAllTiles || kt * 16 < n_keys) {
        uint32_t b[4];
        ldsm4(b, kp + kt * 16 * ld + kk * 16);
        mma_bf16(s[2 * kt], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * kt + 1], qf[kk], b[2], b[3]);
      }
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[t][i] = t * 8 + c2 + (i & 1) < n_keys ? s[t][i] * scale : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[t][i]);
    }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));   // finite: n_keys >= 1
    corr[r] = __expf(m[r] - m_new);                     // 0 for the first block
    m[r] = m_new;
  }
#pragma unroll
  for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[t][i] = __expf(s[t][i] - m[i >> 1]);
      sum[i >> 1] += s[t][i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = quad_sum(sum[r]);
    l[r] = l[r] * corr[r] + sum[r];
  }
  if (kMode == kPNormBf16) {
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
    for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[t][i] *= inv[i >> 1];
  } else {
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[t][i] *= corr[i >> 1];
  }

  const bf16* vp = vs + lane_off_bt(lane, ld);
#pragma unroll
  for (int kt = 0; kt < KT16; ++kt) {
    if (kAllTiles || kt * 16 < n_keys) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // A fragment j: rows lane/4 + 8*(j%2), keys kt*16 + 8*(j/2) + c2, +1
        const float p0 = s[2 * kt + (j >> 1)][(j & 1) * 2];
        const float p1 = s[2 * kt + (j >> 1)][(j & 1) * 2 + 1];
        hi[j] = pack_bf16(p0, p1);
        if (kMode == kPHiLo) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[j]);
          lo[j] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
        }
      }
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t b[4];
        ldsm4_t(b, vp + kt * 16 * ld + dn * 16);
        mma_bf16(o[2 * dn], hi, b[0], b[1]);
        mma_bf16(o[2 * dn + 1], hi, b[2], b[3]);
        if (kMode == kPHiLo) {
          mma_bf16(o[2 * dn], lo, b[0], b[1]);
          mma_bf16(o[2 * dn + 1], lo, b[2], b[3]);
        }
      }
    }
  }
}

// Scaled scores of one 16-query strip against the KT16 key tiles at ks:
// s = q k^T * scale, -inf for keys at or past n_keys (>= 1); tiles wholly
// past n_keys are not multiplied.
template <int DH, int KT16>
__device__ __forceinline__ void attn_scores(const uint32_t (&qf)[DH / 16][4], const bf16* ks,
                                            int ld, int n_keys, float scale,
                                            float (&s)[2 * KT16][4]) {
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2;
  const bf16* kp = ks + lane_off_b(lane, ld);
#pragma unroll
  for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[t][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int kt = 0; kt < KT16; ++kt) {
      if (kt * 16 < n_keys) {
        uint32_t b[4];
        ldsm4(b, kp + kt * 16 * ld + kk * 16);
        mma_bf16(s[2 * kt], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * kt + 1], qf[kk], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[t][i] = t * 8 + c2 + (i & 1) < n_keys ? s[t][i] * scale : -INFINITY;
}

// softmax(q k^T * scale) v for one 16-query strip against n_keys (>= 1)
// keys at ks and vs, in blocks of KT16 key tiles, with P normalised and
// rounded to bf16 before P V as kPNormBf16 does (the V rows up to the next
// multiple of 16 must be finite). Pass one keeps each row's running max
// and its sum of exponentials, rescaled when the max grows; pass two
// recomputes the scores, divides by the sum and multiplies by V, so the
// products Q K^T run twice and no score leaves the registers. The
// normalised output is left in o.
template <int DH, int KT16>
__device__ __forceinline__ void attn_strip_two_pass(const uint32_t (&qf)[DH / 16][4],
                                                    const bf16* ks, const bf16* vs, int ld,
                                                    int n_keys, float scale,
                                                    float (&o)[DH / 8][4]) {
  constexpr int kKeys = KT16 * 16;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    float s[2 * KT16][4];
    attn_scores<DH, KT16>(qf, ks + k0 * ld, ld, n_keys - k0, scale, s);
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[t][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], quad_max(mx[r]));   // finite
#pragma unroll
    for (int t = 0; t < 2 * KT16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i >> 1] += __expf(s[t][i] - mx[i >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * __expf(m[r] - mx[r]) + quad_sum(sum[r]);   // 0 * 0 for the first block
      m[r] = mx[r];
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[t][i] = 0.f;
  const bf16* vp = vs + lane_off_bt(threadIdx.x & 31, ld);
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    float s[2 * KT16][4];
    attn_scores<DH, KT16>(qf, ks + k0 * ld, ld, n_keys - k0, scale, s);
#pragma unroll
    for (int kt = 0; kt < KT16; ++kt) {
      if (k0 + kt * 16 < n_keys) {
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // A fragment j: rows lane/4 + 8*(j%2), keys kt*16 + 8*(j/2) + c2, +1
          const float* sj = s[2 * kt + (j >> 1)];
          const float r = inv[j & 1];
          p[j] = pack_bf16(__expf(sj[(j & 1) * 2] - m[j & 1]) * r,
                           __expf(sj[(j & 1) * 2 + 1] - m[j & 1]) * r);
        }
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t b[4];
          ldsm4_t(b, vp + (k0 + kt * 16) * ld + dn * 16);
          mma_bf16(o[2 * dn], p, b[0], b[1]);
          mma_bf16(o[2 * dn + 1], p, b[2], b[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 operands in split TF32 (see the header)
// ---------------------------------------------------------------------------

// x rounded to TF32: nearest, ties away from zero; the low 13 bits are 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Four f32 values split into TF32 pairs, value = hi + lo (+ ~2^-22 |value|)
struct Split4 {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ Split4 split4(const float4& v) {
  Split4 r;
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.hi[i] = tf32_rna(x[i]);
    r.lo[i] = tf32_rna(x[i] - __uint_as_float(r.hi[i]));
  }
  return r;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c += a b on mma.sync.m16n8k8 with TF32 operands and f32 sums. a[0] is
// row g = lane / 4, k index t = lane % 4; a[1] row g + 8, k t; a[2] row g,
// k t + 4; a[3] row g + 8, k t + 4; b0 k t, column g; b1 k t + 4, column g;
// c as an m16n8k16 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32: lo_a hi_b, hi_a lo_b, then hi_a hi_b
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// k step s (0 or 1) of a 16-column block: the A fragment from the split
// float4s of rows g (r0) and g + 8 (r1), and the product with the B
// fragment of the split float4 of output column g (b)
__device__ __forceinline__ void mma_k16_step(float (&c)[4], const Split4& r0, const Split4& r1,
                                             const Split4& b, int s) {
  const uint32_t ah[4] = {r0.hi[2 * s], r1.hi[2 * s], r0.hi[2 * s + 1], r1.hi[2 * s + 1]};
  const uint32_t al[4] = {r0.lo[2 * s], r1.lo[2 * s], r0.lo[2 * s + 1], r1.lo[2 * s + 1]};
  mma_tf32x3(c, ah, al, b.hi[2 * s], b.hi[2 * s + 1], b.lo[2 * s], b.lo[2 * s + 1]);
}

// o += P V for one 16-query strip, f32 operands in split TF32: s holds the
// strip's probabilities (of any scale) for the KT16 * 16 keys whose value
// rows are at vs (stride ldv: 4 mod 32); 8-key tiles wholly past n_keys are
// skipped unless kAllTiles. Keys 2t, 2t + 1 of tile j are the MMA's k
// indices t, t + 4, so V's B fragment is single words of two rows.
template <int DH, int KT16, bool kAllTiles>
__device__ __forceinline__ void attn_pv_f32(const float (&s)[2 * KT16][4], const float* vs,
                                            int ldv, int n_keys, float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  const float* vp = vs + c2 * ldv + g;
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j) {
    if (kAllTiles || j * 8 < n_keys) {
      const Split4 p = split4(make_float4(s[j][0], s[j][2], s[j][1], s[j][3]));
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        const float* v = vp + j * 8 * ldv + dn * 8;
        const float v0 = v[0], v1 = v[ldv];
        const uint32_t h0 = tf32_rna(v0), h1 = tf32_rna(v1);
        mma_tf32x3(o[dn], p.hi, p.lo, h0, h1, tf32_rna(v0 - __uint_as_float(h0)),
                   tf32_rna(v1 - __uint_as_float(h1)));
      }
    }
  }
}

// attn_pv_f32 with V stored transposed: row c of vt (stride ldvt: 16 mod 32
// floats) holds column c of V over the keys, the keys of each 16-key tile in
// the order 2t, 2t + 1, 8 + 2t, 9 + 2t for t = 0 .. 3 (attn_vt_slot), so
// that a lane's B fragments for both 8-key halves of a tile are one float4.
// 16-key tiles wholly past n_keys are skipped unless kAllTiles; the rows of
// the tiles taken must be finite. Each tile's P V is summed from zero on the
// tensor core and added to o in f32, so that o does not stay in the MMA's
// truncating accumulator however many keys a strip takes.
__host__ __device__ constexpr int attn_vt_slot(int key) {
  return (key & ~15) + 4 * ((key & 7) >> 1) + 2 * ((key >> 3) & 1) + (key & 1);
}
template <int DH, int KT16, bool kAllTiles>
__device__ __forceinline__ void attn_pv_f32_t(const float (&s)[2 * KT16][4], const float* vt,
                                              int ldvt, int n_keys, float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* vp = vt + g * ldvt + 4 * t;
#pragma unroll
  for (int kt = 0; kt < KT16; ++kt) {
    if (kAllTiles || kt * 16 < n_keys) {
      const float* sa = s[2 * kt];
      const float* sb = s[2 * kt + 1];
      const Split4 pa = split4(make_float4(sa[0], sa[2], sa[1], sa[3]));
      const Split4 pb = split4(make_float4(sb[0], sb[2], sb[1], sb[3]));
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        const Split4 b = split4(ld4(vp + dn * 8 * ldvt + kt * 16));
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32x3(c, pa.hi, pa.lo, b.hi[0], b.hi[1], b.lo[0], b.lo[1]);
        mma_tf32x3(c, pb.hi, pb.lo, b.hi[2], b.hi[3], b.lo[2], b.lo[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[dn][i] += c[i];
      }
    }
  }
}

// One block of keys for one 16-query strip, f32 operands in split TF32:
// the contract of attn_strip_block's kPHiLo mode (o unnormalised, m, l the
// running max and sum; start them at -inf, 0, 0). qs: the strip's 16 query
// rows, ks: the block's key rows (strides ldq, ldk: 16 mod 32 floats), vs:
// its value rows (stride ldv: 4 mod 32). n_keys (>= 1) of the KT16 * 16 rows
// are real, the rest masked (their V rows up to the next multiple of 16
// must be finite); 8-key tiles wholly past n_keys are skipped unless
// kAllTiles (then all rows must be finite). kStepSums: each k step of the
// scores is summed from zero on the tensor core and added to the running
// score in f32 (the header's summation rule); without it the running score
// stays in the MMA's accumulator, two f32 registers fewer a score. kVT: vs
// is V stored transposed (attn_pv_f32_t, which sums P V a 16-key tile at a
// time; ldv its row stride); without it P V adds to o in the MMA's
// accumulator (attn_pv_f32).
template <int DH, int KT16, bool kAllTiles = false, bool kStepSums = true, bool kVT = false>
__device__ __forceinline__ void attn_strip_block_f32(const float* qs, int ldq, const float* ks,
                                                     int ldk, const float* vs, int ldv,
                                                     int n_keys, float scale, float (&m)[2],
                                                     float (&l)[2], float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, c2 = t * 2;
  float s[2 * KT16][4];
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  const float* q0 = qs + g * ldq + 4 * t;
  const float* kp = ks + g * ldk + 4 * t;
#pragma unroll
  for (int kb = 0; kb < DH / 16; ++kb) {
    const Split4 a0 = split4(ld4(q0 + kb * 16)), a1 = split4(ld4(q0 + 8 * ldq + kb * 16));
#pragma unroll
    for (int j = 0; j < 2 * KT16; ++j) {
      if (kAllTiles || j * 8 < n_keys) {
        const Split4 b = split4(ld4(kp + j * 8 * ldk + kb * 16));
        if constexpr (kStepSums) {
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_k16_step(c0, a0, a1, b, 0);
          mma_k16_step(c1, a0, a1, b, 1);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] += c0[i] + c1[i];
        } else {
          mma_k16_step(s[j], a0, a1, b, 0);
          mma_k16_step(s[j], a0, a1, b, 1);
        }
      }
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = j * 8 + c2 + (i & 1) < n_keys ? s[j][i] * scale : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));   // finite: n_keys >= 1
    corr[r] = expf(m[r] - m_new);                       // 0 for the first block
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - m[i >> 1]);
      sum[i >> 1] += s[j][i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
  for (int t8 = 0; t8 < DH / 8; ++t8)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[t8][i] *= corr[i >> 1];
  if constexpr (kVT)
    attn_pv_f32_t<DH, KT16, kAllTiles>(s, vs, ldv, n_keys, o);
  else
    attn_pv_f32<DH, KT16, kAllTiles>(s, vs, ldv, n_keys, o);
}
