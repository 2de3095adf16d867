// The stages that the Mamba-2 SSD forward (csrc/ssd.cu) and its gradient
// (csrc/ssd_bwd.cu) share, for Hopper (sm_90a). Notation per (b, h) and
// chunk, as in csrc/ssd_bwd.cu: cum the running sum of dt * A within the
// chunk, cum_L its last value, e_l = exp(cum_l), ex_l = exp(cum_L - cum_l).
//   - stage 1, chunk states (``chunk_states``): a CTA per (b, h, chunk)
//     and, along blockIdx.y, per block of the state's (P, N) entries:
//        S_c = sum_l ex_l dt_l x_l B_l^T  (and Q_c = sum_l e_l dy_l C_l^T
//     for the gradient), and the chunk's cum, into scratch;
//   - stage 2, the pass over the chunks (``walk_chunks``): a thread per
//     run of V (b, h, p, n) entries, h_in(c + 1) = exp(cum_L) h_in(c) +
//     S_c, each chunk's entering state written over S_c (the gradient's
//     reverse pass walks its Q_c the other way);
// and what they are built from: ``mma3``, a tile product on the tensor
// cores as 3xTF32, ``stage_tile``, cp.async copies of a strided operand
// into a shared tile, and ``chunk_cum``. Every function here is used by
// both sources and compiled with each library's own flags.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace ssd_stages {

using flash_tiles::mma_tf32;
using flash_tiles::to_tf32;

constexpr int kStateThreads = 256;   // stage 1: 8 warps, two CTAs an SM
constexpr int kThreads = 512;        // stage 2 (and the gradient's sums)
constexpr int kMaxChunk = 64;
constexpr int kSmemLimit = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// the bits of the arguments' ``vec``: which operands move in 16-byte pieces
constexpr int kVecX = 1, kVecDy = 2, kVecB = 4, kVecC = 8, kVecState = 16;

__host__ __device__ __forceinline__ int up(int v, int m) {
  return (v + m - 1) / m * m;
}

// the tiles' extents, rounded up to the fragments' multiples, and their
// row lengths in shared memory (4 mod 16 floats)
struct Tiles {
  int Lp, Pp, Nq, ldl, ldp, ldn;
};

__host__ __device__ __forceinline__ Tiles tiles(int L, int P, int N) {
  Tiles t;
  t.Lp = up(L, 16);
  t.Pp = up(P, 16);
  t.Nq = up(N, 32);
  t.ldl = t.Lp + 4;
  t.ldp = t.Pp + 4;
  t.ldn = t.Nq + 4;
  return t;
}

// floats of stage 1's shared memory at the block extents ``t``: x (L, P)
// and B (L, N), with Q also dy (L, P) and C (L, N); cum, dt and the row
// scales
__host__ __device__ __forceinline__ long long states_floats(const Tiles& t,
                                                            bool q) {
  const int k = q ? 2 : 1;
  return (long long)k * t.Lp * t.ldp + (long long)k * t.Lp * t.ldn +
         (2LL + k) * t.Lp;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (rows, cols) of a strided operand into a (R, W) shared tile whose rows
// are ``ld`` floats apart, zero past rows and cols: 16-byte cp.async
// pieces (zero-filled past cols) when ``vec`` (unit column stride,
// 16-byte aligned rows), else each thread's own loads
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src,
                                           int rows, int cols, int R, int W,
                                           long long rs, long long cs,
                                           bool vec, int threads) {
  if (vec) {
    const int q = W / 4;
    for (int i = threadIdx.x; i < R * q; i += threads) {
      const int r = i / q;
      const int c = (i - r * q) * 4;
      const int n = r < rows ? min(max(cols - c, 0), 4) : 0;
      flash_tiles::cp_async16(dst + r * ld + c, n ? src + r * rs + c : src,
                              4 * n);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += threads) {
      const int r = i / W;
      const int c = i - r * W;
      dst[r * ld + c] = r < rows && c < cols ? src[r * rs + c * cs] : 0.f;
    }
  }
}

// x as a TF32 hi part, rounded to nearest, and the rest: the tensor cores
// read only lo's top 19 bits (lo is at most 2^-11 |x|, so what they drop
// is at most 2^-21 |x|, of either sign)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc (16 x 8 NT) = A (16 x K) . B (K x 8 NT) on the tensor cores as
// 3xTF32, K a multiple of 16. A(i, k) is a[i * lda + k] (a[k * lda + i]
// when AR), B(k, j) is b[j * ldb + k] (b[k * ldb + j] when BR). When B is
// read down its columns, the K slots of a fragment take the order 0, 2,
// 4, 6, 1, 3, 5, 7 (A's as B's): its rows 2 t and 2 t + 1 then hit 32
// banks at a row length of 4 mod 16. The tensor cores truncate the sums
// they accumulate, so the hi.hi products are summed 16 of K at a time
// and each such sum added to acc in float32, rounding to nearest; the
// small lo.hi + hi.lo terms run the whole of K. Given ``ks``, A(i, k) is
// scaled by ks[k] (in float32, before the split). C fragment: lane 4 g + t
// holds rows g, g + 8 and columns 2 t, 2 t + 1 of each 8-column block.
template <int NT, bool AR, bool BR>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], const float* a,
                                     int lda, const float* b, int ldb, int K,
                                     const float* ks = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = BR ? 2 * t : t, k1 = BR ? 2 * t + 1 : t + 4;
  const float* a0 = a + (AR ? k0 * lda + g : g * lda + k0);
  const float* a1 = a + (AR ? k1 * lda + g : g * lda + k1);
  const int a8 = AR ? 8 : 8 * lda;   // row g + 8
  const int ak = AR ? 8 * lda : 8;   // the next 8 of K
  const float* b0 = b + (BR ? k0 * ldb + g : g * ldb + k0);
  const float* b1 = b + (BR ? k1 * ldb + g : g * ldb + k1);
  const int bj = BR ? 8 : 8 * ldb;   // the next 8 columns
  const int bk = BR ? 8 * ldb : 8;
  float small[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
  for (int kc = 0; kc < K; kc += 16) {
    float big[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 16; kk += 8) {
      const float s0 = ks ? ks[kc + kk + k0] : 1.f;
      const float s1 = ks ? ks[kc + kk + k1] : 1.f;
      uint32_t ah[4], al[4];
      split(a0[0] * s0, ah[0], al[0]);
      split(a0[a8] * s0, ah[1], al[1]);
      split(a1[0] * s1, ah[2], al[2]);
      split(a1[a8] * s1, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        split(b0[j * bj], bh[0], bl[0]);
        split(b1[j * bj], bh[1], bl[1]);
        mma_tf32(small[j], al, bh); mma_tf32(small[j], ah, bl);  // the split's corrections
        mma_tf32(big[j], ah, bh);
      }
      a0 += ak;
      a1 += ak;
      b0 += bk;
      b1 += bk;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += big[j][e];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// cum_l = sum_{k <= l} dt_k A in order by one thread, into shared memory
// and, given ``cum``, global memory. Summed in order, cum_l and cum_m
// share the rounding of their common prefix, so the differences cum_l -
// cum_m in w_lm and ex_l keep float32's accuracy (a tree scan rounds each
// prefix on its own path and loses it: the gradient's dx then fell
// further from float64 than chip_smoke.py's phase 3 allows). The later
// stages read what stage 1 wrote.
__device__ __forceinline__ void chunk_cum(float* s_cum, float* cum,
                                          const float* dt, int L, float A) {
  float c = 0.f;
#pragma unroll 8
  for (int l = 0; l < L; ++l) {
    c = __fadd_rn(c, __fmul_rn(dt[l], A));
    s_cum[l] = c;
    if (cum) cum[l] = c;
  }
}

// a C fragment's two columns of one row, v0 at q[0] and v1 at q[1] where
// in0 and in1 say they are inside the result: one 8-byte store when
// ``pair`` (the row's length and start even, so both are in or out)
__device__ __forceinline__ void store2(float* q, float v0, float v1, bool in0,
                                       bool in1, bool pair) {
  if (pair) {
    if (in0) *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
  } else {
    if (in0) q[0] = v0;
    if (in1) q[1] = v1;
  }
}

// the (b, h, chunk) of a CTA of a per-chunk stage, blockIdx.x in (b, h,
// chunk) order, and h's group
struct Where {
  int bi, hi, gi, ci, bh, nc;
};

template <class Args>
__device__ __forceinline__ Where where(const Args& a) {
  Where w;
  w.nc = a.seq / a.chunk;
  w.bh = blockIdx.x / w.nc;
  w.ci = blockIdx.x - w.bh * w.nc;
  w.bi = w.bh / a.heads;
  w.hi = w.bh - w.bi * a.heads;
  w.gi = w.hi / (a.heads / a.groups);
  return w;
}

// the chunk's operands: x, dy (the head's; dy only given kDy), B and C
// (its group's) at row l = 0, and dt into ``s_dt`` (zero past L)
struct Chunk {
  const float *x, *dy, *B, *C;
};

template <bool kDy, class Args>
__device__ __forceinline__ Chunk chunk_ptrs(const Args& a, const Where& w,
                                            const Tiles& t, float* s_dt,
                                            int threads) {
  const long long base = (long long)w.ci * a.chunk;
  for (int l = threadIdx.x; l < t.Lp; l += threads)
    s_dt[l] = l < a.chunk ? a.dt[w.bi * a.sdt[0] + (base + l) * a.sdt[1] +
                                 w.hi * a.sdt[2]]
                          : 0.f;
  const float* dy = nullptr;
  if constexpr (kDy) dy = a.dy + w.bi * a.sdy[0] + base * a.sdy[1] + w.hi * a.sdy[2];
  return {a.x + w.bi * a.sx[0] + base * a.sx[1] + w.hi * a.sx[2], dy,
          a.Bm + w.bi * a.sb[0] + base * a.sb[1] + w.gi * a.sb[2],
          a.Cm + w.bi * a.sc[0] + base * a.sc[1] + w.gi * a.sc[2]};
}

// ---------------------------------------------------------------- stage 1
// One CTA of kStateThreads: S (and, given kQ, Q) for the (b, h, chunk) of
// blockIdx.x, restricted to the block blockIdx.y of pbk x nbk entries of
// (P, N) (the gradient takes the whole state, pbk = P and nbk = N, one
// block), and the chunk's cum, written by the block 0. ``smem`` holds
// states_floats(tiles(L, pbk, nbk), kQ) floats.
template <bool kQ, class Args>
__device__ __forceinline__ void chunk_states(const Args& a, float* smem,
                                             int pbk, int nbk) {
  const int L = a.chunk, P = a.p, N = a.n;
  const Tiles t = tiles(L, pbk, nbk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Where w = where(a);
  const int nblk = (N + nbk - 1) / nbk;
  const int p_off = blockIdx.y / nblk * pbk, n_off = blockIdx.y % nblk * nbk;
  const int prows = min(P - p_off, pbk), ncols = min(N - n_off, nbk);
  float* s_x = smem;                              // (Lp, ldp); row l weighs ex_l dt_l
  float* s_dy = s_x + t.Lp * t.ldp;               // (Lp, ldp); row l weighs e_l
  float* s_b = s_dy + (kQ ? t.Lp * t.ldp : 0);    // (Lp, ldn)
  float* s_c = s_b + t.Lp * t.ldn;                // (Lp, ldn)
  float* s_cum = s_c + (kQ ? t.Lp * t.ldn : 0);   // (Lp)
  float* s_dt = s_cum + t.Lp;
  float* s_sx = s_dt + t.Lp;                      // ex_l dt_l
  float* s_sy = s_sx + t.Lp;                      // e_l
  // dt, then x and B in one group and dy and C in another: S forms while
  // dy and C arrive, cum while both do
  const Chunk ch = chunk_ptrs<kQ>(a, w, t, s_dt, kStateThreads);
  stage_tile(s_x, t.ldp, ch.x + p_off * a.sx[3], L, prows, t.Lp, t.Pp,
             a.sx[1], a.sx[3], a.vec & kVecX, kStateThreads);
  stage_tile(s_b, t.ldn, ch.B + n_off * a.sb[3], L, ncols, t.Lp, t.Nq,
             a.sb[1], a.sb[3], a.vec & kVecB, kStateThreads);
  flash_tiles::cp_async_commit();
  if constexpr (kQ) {
    stage_tile(s_dy, t.ldp, ch.dy + p_off * a.sdy[3], L, prows, t.Lp, t.Pp,
               a.sdy[1], a.sdy[3], a.vec & kVecDy, kStateThreads);
    stage_tile(s_c, t.ldn, ch.C + n_off * a.sc[3], L, ncols, t.Lp, t.Nq,
               a.sc[1], a.sc[3], a.vec & kVecC, kStateThreads);
    flash_tiles::cp_async_commit();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    chunk_cum(s_cum, blockIdx.y == 0 ? a.cum + (size_t)blockIdx.x * L : nullptr,
              s_dt, L, a.A[w.hi]);
  __syncthreads();
  for (int l = threadIdx.x; l < t.Lp; l += kStateThreads) {
    s_sx[l] = l < L ? expf(s_cum[L - 1] - s_cum[l]) * s_dt[l] : 0.f;
    if constexpr (kQ) s_sy[l] = l < L ? expf(s_cum[l]) : 0.f;
  }
  // S (then Q) in 16 x 32 tiles, a warp a tile: S(p, n) = sum_l ex_l dt_l
  // x(l, p) B(l, n), A read down its columns and scaled by its row's factor
  const int g = lane >> 2, tq = lane & 3;
  const int cols = t.Nq / 32, jobs = (t.Pp / 16) * cols;
  const bool pair = N % 2 == 0;
#pragma unroll 1
  for (int q = 0; q < (kQ ? 2 : 1); ++q) {
    if (q == 0 && kQ) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    for (int j = warp; j < jobs; j += kStateThreads / 32) {
      const int p0 = j / cols * 16, n0 = (j % cols) * 32;
      float acc[4][4];
      mma3<4, true, true>(acc, (q ? s_dy : s_x) + p0, t.ldp,
                          (q ? s_c : s_b) + n0, t.ldn, t.Lp,
                          q ? s_sy : s_sx);
      float* out = (q ? a.grads : a.states) + (size_t)blockIdx.x * P * N +
                   (size_t)p_off * N + n_off;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + g + 8 * r, n = n0 + 8 * jj + 2 * tq;
          store2(out + p * N + n, acc[jj][2 * r], acc[jj][2 * r + 1],
                 p < prows && n < ncols, p < prows && n + 1 < ncols, pair);
        }
    }
  }
}

// ---------------------------------------------------------------- stage 2
// V neighbouring entries a thread (4, in 16-byte pieces, where P N is a
// multiple of 4 and the buffers are aligned). Each thread issues the
// loads of eight chunks at a time before their multiply-adds (the
// compiler may not move one chunk's store past the next one's load).
constexpr int kPassBatch = 8;

template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// h (V entries, the initial state on entry) walked through the chunks:
// chunk c's X (at X + c pn) replaced by the state entering it (forward,
// c ascending) or leaving it (reverse, c descending), h = exp(cum_L) h +
// X; ``cum_last`` is chunk 0's cum_L, chunk c's at c ``chunk`` past it.
// On return h is the state past the last chunk walked.
template <int V>
__device__ __forceinline__ void walk_chunks(float (&h)[V], float* X,
                                            const float* cum_last, int nc,
                                            long long pn, int chunk,
                                            bool reverse) {
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float v[kPassBatch][V], d[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k < nc) {
        const int c = reverse ? nc - 1 - c0 - k : c0 + k;
        load_v(v[k], X + c * pn);
        d[k] = expf(cum_last[(long long)c * chunk]);
      }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k < nc) {
        store_v(X + (reverse ? nc - 1 - c0 - k : c0 + k) * pn, h);
#pragma unroll
        for (int u = 0; u < V; ++u) h[u] = d[k] * h[u] + v[k][u];
      }
  }
}

// ------------------------------------------------------------------- host
inline long long blocks_for(long long threads) {
  return (threads + kThreads - 1) / kThreads;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;   // null passes
}

// whether a (b, s, h or g, last) view moves in 16-byte pieces: a 16-byte
// aligned start, unit last stride and the other strides multiples of 4
inline bool vec16(const float* p, const long long (&s)[4]) {
  return aligned16(p) && s[3] == 1 && s[0] % 4 == 0 && s[1] % 4 == 0 &&
         s[2] % 4 == 0;
}

template <typename K>
int allow_smem(K kernel, long long bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace ssd_stages
