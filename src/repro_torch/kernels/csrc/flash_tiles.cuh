// Tile helpers shared by the float32 instances of the flash attention
// kernels for Hopper (sm_90a): the forward (flash_attention.cu) and its
// gradient (flash_attention_bwd.cu), whose bf16 instances take the wgmma
// tiles of flash_wgmma.cuh instead. Operands are read through element
// strides into shared-memory tiles by cp.async, and products run on the
// tensor cores as mma.sync m16n8k8 TF32 with float32 accumulators
// (3xTF32: every product split into hi and lo TF32 parts, see
// flash_attention.cu's note). Also the operands' layout, the bf16 store
// and the alignment test, which both designs use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tiles {

// element strides of one operand: between sequences, heads and positions
struct Layout {
  long long batch, head, seq;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [pos0, pos0 + R) of one program's (positions, D) operand into a
// (R, RS) tile by `threads` threads, zero past position n and column d
template <typename T, int DP, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int pos0, int n,
                                          int d, bool vec, int tid,
                                          int threads) {
  constexpr int RS = DP + 16 / (int)sizeof(T);
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kChunks = DP / kVec;
    for (int i = tid; i < R * kChunks; i += threads) {
      const int r = i / kChunks;
      const int col = (i - r * kChunks) * kVec;
      const int pos = pos0 + r;
      const bool in = pos < n && col < d;
      cp_async16(dst + r * RS + col, in ? src + pos * stride + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < R * DP; i += threads) {
      const int r = i / DP;
      const int col = i - r * DP;
      const int pos = pos0 + r;
      dst[r * RS + col] =
          pos < n && col < d ? src[pos * stride + col] : zero<T>();
    }
  }
}

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's result, in two full-rate integer
// operations (cvt runs on the conversion unit at a fraction of the rate)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// Fragment coordinates below: lane = 4 * g + t; a C fragment c[0..3]
// holds rows (g, g, g + 8, g + 8) and columns (2t, 2t + 1, 2t, 2t + 1).

// s[j] = Q(16, DP) . K(keys 8j .. 8j + 7, DP)^T. The tensor cores add
// into their accumulator rounding toward zero, so the hi.hi terms and the
// small lo terms are summed apart and added once, rounding to nearest.
template <int DP, int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4],
                                        const float* sq, const float* sk,
                                        int g, int t) {
  constexpr int RS = DP + 4;
  float small[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP; kk += 8) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(sq[g * RS + kk + t], a_hi[0], a_lo[0]);
    split_tf32(sq[(g + 8) * RS + kk + t], a_hi[1], a_lo[1]);
    split_tf32(sq[g * RS + kk + t + 4], a_hi[2], a_lo[2]);
    split_tf32(sq[(g + 8) * RS + kk + t + 4], a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* kr = sk + (j * 8 + g) * RS + kk;
      uint32_t b_hi[2], b_lo[2];
      split_tf32(kr[t], b_hi[0], b_lo[0]);
      split_tf32(kr[t + 4], b_hi[1], b_lo[1]);
      mma_tf32(small[j], a_lo, b_hi);
      mma_tf32(small[j], a_hi, b_lo);
      mma_tf32(s[j], a_hi, b_hi);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];
}

// dim blocks of 8 whose P.V sums one pass keeps in registers
template <int DP>
constexpr int kDimBlocks = DP / 8 < 4 ? DP / 8 : 4;

// o[n] = o[n] * corr + P(16, BK) . V(BK, dims 8n .. 8n + 7); p holds the
// softmax weights in the QK^T C-fragment layout, corr each row's rescale.
// Each tile's products are summed from zero on the tensor cores (the lo
// terms apart) and added to o in float32 with one rounding to nearest,
// so the running sum never sees the tensor cores' truncation. NO (DP by
// default) is the number of V's columns that o holds: sv may point at
// column c0 of a (BK, DP)-wide tile, and o then gets columns c0 .. c0 +
// NO - 1 (the gradient at D = 256 splits its outputs so).
template <int DP, int BK, int NO = DP>
__device__ __forceinline__ void pv_tile(float (&o)[NO / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const float* sv, int g, int t,
                                        const float (&corr)[2]) {
  constexpr int RS = DP + 4;
  // A column t is key 8j + 2t, column t + 4 is key 8j + 2t + 1
  uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    split_tf32(p[j][0], a_hi[j][0], a_lo[j][0]);
    split_tf32(p[j][2], a_hi[j][1], a_lo[j][1]);
    split_tf32(p[j][1], a_hi[j][2], a_lo[j][2]);
    split_tf32(p[j][3], a_hi[j][3], a_lo[j][3]);
  }
  // NB dim blocks at a time, keys outermost: 2 NB independent chains of
  // products in flight instead of two
#pragma unroll
  for (int n0 = 0; n0 < NO / 8; n0 += kDimBlocks<NO>) {
    constexpr int NB = kDimBlocks<NO>;
    float big[NB][4], small[NB][4];
#pragma unroll
    for (int nn = 0; nn < NB; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[nn][e] = small[nn][e] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* v0 = sv + (j * 8 + 2 * t) * RS + n0 * 8 + g;
#pragma unroll
      for (int nn = 0; nn < NB; ++nn) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(v0[nn * 8], b_hi[0], b_lo[0]);
        split_tf32(v0[RS + nn * 8], b_hi[1], b_lo[1]);
        mma_tf32(small[nn], a_lo[j], b_hi);
        mma_tf32(small[nn], a_hi[j], b_lo);
        mma_tf32(big[nn], a_hi[j], b_hi);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NB; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n0 + nn][e] = fmaf(o[n0 + nn][e], corr[e >> 1],
                             big[nn][e] + small[nn][e]);
  }
}

inline bool aligned16(const void* ptr, const Layout& l, size_t elem) {
  const size_t a = 16 / elem;  // elements in 16 bytes
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && l.batch % a == 0 &&
         l.head % a == 0 && l.seq % a == 0;
}

}  // namespace flash_tiles
