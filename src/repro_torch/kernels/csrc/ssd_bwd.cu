// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a) --
// mamba2 training.
//
// Replaces the gradient of the TPU kernel
// src/repro/kernels/ssd.py::ssd_bhcp (_ssd_kernel): the JAX package trains
// through its plain scan (ops.ssd under attention_impl "xla" is ref.ssd)
// and differentiates that; the Pallas kernel has no backward. With the
// forward's notation (csrc/ssd.cu) per (b, h) and chunk: cum the running
// sum of dt * A within the chunk, cum_L its last value, e_l = exp(cum_l),
// ex_l = exp(cum_L - cum_l), w_lm = exp(cum_l - cum_m) for m <= l,
// s_lm = C_l . B_m and D_lm = dy_l . x_m. Four stages, four launches, one
// call:
//   1. chunk states, a CTA per (b, h, chunk):
//        S_c = sum_l ex_l dt_l x_l B_l^T,  Q_c = sum_l e_l dy_l C_l^T
//      (P x N each) and the chunk's cum, into scratch;
//   2. the passes over the chunks, a thread per (b, h, p, n) entry and
//      pass:
//        forward  h_in(c + 1) = exp(cum_L) h_in(c) + S_c from h0 (or 0),
//        reverse  dH_{c-1} = exp(cum_L) dH_c + Q_c from dh_last (or 0),
//      dH_c the gradient of chunk c's exit state, written over S_c and
//      Q_c; dh0 = dH_{-1};
//   3. per-chunk gradients, a CTA per (b, h, chunk), the chunk's tiles,
//      h_in and dH staged in shared memory and the intra-chunk terms
//      recomputed:
//        dx_m  = sum_{l>=m} s_lm w_lm dt_m dy_l + ex_m dt_m dH B_m
//        dC_l  = sum_{m<=l} w_lm dt_m D_lm B_m + e_l h_in^T dy_l
//        dB_m  = sum_{l>=m} w_lm dt_m D_lm C_l + ex_m dt_m dH^T x_m
//        ddt_m = sum_{l>=m} s_lm w_lm D_lm + ex_m x_m^T dH B_m + A da_m
//      where da_k = sum_{l>=k} dcum_l is the gradient through cum:
//        dcum_l = sum_{m<=l} s_lm w_lm dt_m D_lm
//               - dt_l sum_{j>=l} s_jl w_jl D_jl
//               + e_l dy_l . h_in C_l - ex_l dt_l x_l . dH B_l
//               (+ exp(cum_L) <h_in, dH> + sum_m ex_m dt_m x_m . dH B_m
//                  at l = L - 1),
//      and this chunk's share of dA is sum_k dt_k da_k; dB and dC are
//      this head's shares;
//   4. one launch of ordered sums: dB and dC summed over the H / G heads
//      of a group in head order, and dA over b, then the chunks.
// No floating-point atomics anywhere: a rerun gives the same bits. cum is
// formed once, by stage 1, summed in order with no contraction, and read
// by stages 2 and 3 (csrc/ssd.cu sums it in another order, so the
// gradient is held to tolerances against kernels/ref.py::ssd_bwd, not to
// bits).
//
// Bound: operations. Per (b, h, chunk), with T = L (L + 1) / 2 entries of
// a triangle: 5 L P N multiply-adds (S, Q, dH B_m, h_in^T dy_l,
// dH^T x_m) and T (3 N + 2 P) (s, D, the triangle's sums of dx, dC and
// dB): at mamba2's training shape (B 4, S 512, H 32, P 64, G 1, N 128,
// chunk 64) 7.5 GFLOP: 0.046 ms as 3xTF32 on the tensor cores (three
// TF32 products each, 495 TFLOP/s), 0.112 ms at float32's 67 TFLOP/s on
// the CUDA cores, against 55 MB of operands and results, 0.016 ms at
// 3.35 TB/s.
//
// Design. Every product is a tile product on the tensor cores, mma.sync
// m16n8k8 TF32 as 3xTF32 (mma3 below): each float32 operand is split in
// registers into a TF32 hi part and a lo part, and the product sums
// lo.hi + hi.lo apart from hi.hi (the tensor cores truncate their sums),
// as csrc/flash_tiles.cuh's tiles do; one TF32 pass (10 mantissa bits)
// would not hold dt's cancelling gradient to float32's rule. The tiles
// stay float32 in shared memory, rows of 4 mod 16 floats: a fragment read
// along a row (lanes 4 g + t at row g, column t) and one read down the
// columns (row 2 t, column g: the products whose B operand is read down
// its columns take the K slots in the order 0, 2, 4, 6, 1, 3, 5, 7) both
// hit 32 banks. Every tile is zero-filled to the fragments' multiples (L
// and P to 16, N to 32). What this does about the three causes that held
// the CUDA-core kernel back:
//   - shared-memory loads: each loaded element feeds 2 or 4 products (a
//     warp tile of 16 x 16 or 16 x 32), not one FFMA; the triangles s and
//     D are full 16 x 16 tile products (the blocks wholly above the
//     diagonal skipped), masked to m <= l and weighted by w_lm dt_m in
//     registers, their exponentials in float32 on the CUDA cores, and the
//     products by M and E skip the 16-blocks of K that the triangle
//     leaves zero;
//   - the serial segments: the triangle's row and column sums are
//     shuffles within a warp's tile and then a sum over the tiles in tile
//     order, and the reverse running sum da, ddt and dA's share are a
//     warp's scan and shuffles, every order fixed by the shape; cum stays
//     a sum in order (a scan loses the accuracy of cum_l - cum_m, see
//     chunk_cum), but once, in stage 1, where two CTAs share an SM;
//   - scratch traffic: as before (states and grads, each head's dB and
//     dC, now also cum, 1 MB), a launch fewer with stage 4's two sums in
//     one; stage 2 walks the two passes in threads of their own and
//     issues each batch of eight chunks' loads before its chain.
// Operands move into shared memory by cp.async in 16-byte pieces where
// a view allows it (unit last stride, 16-byte aligned rows: the entry
// point works that out into ``vec``), else by each thread's own loads
// through the strides (a dt broadcast over heads, the all-zero strides of
// a missing y-cotangent, P or N not a multiple of 4). Stage 3 holds x,
// dy, B, C, h_in, dH, M and E: 205 KB at L = 64, P = 64, N = 128, one CTA
// of 16 warps an SM (two would need half these tiles); h_in and dH
// arrive while the triangle is formed.
// Stage 1 holds x, dy, B and C: 101 KB, two CTAs of 8 warps an SM. The
// wrapper refuses shapes whose stage-3 tiles exceed the 227 KB a CTA may
// hold (kernels/ssd.py::grad_smem_bytes is grads_floats below in bytes)
// before the forward runs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

// SsdBwdArgs in the wrapper's struct format: pointers, then element
// strides in (b, s, h, last) order (dt has no last dimension), then the
// sizes. x, dt, Bm, Cm and dy are read through their strides (a zero
// cotangent of y is a view of one zero with zero strides); the results
// and the scratch are contiguous.
struct SsdBwdArgs {
  const float* x;        // (B, S, H, P)
  const float* dt;       // (B, S, H)
  const float* A;        // (H,)
  const float* Bm;       // (B, S, G, N)
  const float* Cm;       // (B, S, G, N)
  const float* h0;       // (B, H, P, N) contiguous, or null for a zero state
  const float* dy;       // (B, S, H, P)
  const float* dh_last;  // (B, H, P, N) contiguous, or null for zero
  float* dx;             // (B, S, H, P)
  float* ddt;            // (B, S, H)
  float* dA;             // (H,)
  float* dB;             // (B, S, G, N)
  float* dC;             // (B, S, G, N)
  float* dh0;            // (B, H, P, N), or null (h0 null)
  float* states;         // (B, H, NC, P, N) scratch: S_c, then h_in(c)
  float* grads;          // (B, H, NC, P, N) scratch: Q_c, then dH_c
  float* cum;            // (B, H, S) scratch: cum of each chunk
  float* dB_heads;       // (B, S, H, N) scratch: each head's share of dB
  float* dC_heads;       // (B, S, H, N) scratch: each head's share of dC
  float* dA_part;        // (B, H, NC) scratch: each chunk's share of dA
  long long sx[4], sdt[3], sb[4], sc[4], sdy[4];
  int batch, heads, seq, p, groups, n, chunk;
  int vec;  // the entry point's: which operands move in 16-byte pieces
};
static_assert(sizeof(SsdBwdArgs) == 344, "SsdBwdArgs must match <20Q19q8i");

namespace {

using flash_tiles::mma_tf32;
using flash_tiles::to_tf32;

constexpr int kStateThreads = 256;   // stage 1: 8 warps, two CTAs an SM
constexpr int kGradThreads = 512;    // stage 3: 16 warps, one CTA an SM
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kThreads = 512;        // stages 2 and 4
constexpr int kMaxChunk = 64;
constexpr int kSmemLimit = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// the bits of SsdBwdArgs::vec
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

// floats of stage 3's shared memory: x and dy (L, P), B and C (L, N),
// h_in and dH (P, N), M and E (L, L), cum, dt, ex and e (L), the
// triangle's row and column sums by tile, x_m . dH B_m by column tile of
// dx, e_l dy_l . h_in C_l by column tile of dC, and a slot a warp
__host__ __device__ __forceinline__ long long grads_floats(int L, int P, int N) {
  const Tiles t = tiles(L, P, N);
  return 2LL * t.Lp * t.ldp + 2LL * t.Lp * t.ldn + 2LL * t.Pp * t.ldn +
         2LL * t.Lp * t.ldl + 4LL * t.Lp + 2LL * (t.Lp / 16) * t.Lp +
         (long long)(t.Pp / 16) * t.Lp + (long long)(t.Nq / 32) * t.Lp +
         kGradWarps;
}

// floats of stage 1's: x and dy (L, P), B and C (L, N), cum, dt and the
// two row scales
__host__ __device__ __forceinline__ long long states_floats(int L, int P, int N) {
  const Tiles t = tiles(L, P, N);
  return 2LL * t.Lp * t.ldp + 2LL * t.Lp * t.ldn + 4LL * t.Lp;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
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

// cum_l = sum_{k <= l} dt_k A in order by one thread, into shared and
// global memory. Summed in order, cum_l and cum_m share the rounding of
// their common prefix, so the differences cum_l - cum_m in w_lm and ex_l
// keep float32's accuracy (a tree scan rounds each prefix on its own path
// and loses it: dx then fell further from float64 than chip_smoke.py's
// phase 3 allows). Stage 3 reads what stage 1 wrote.
__device__ __forceinline__ void chunk_cum(float* s_cum, float* cum,
                                          const float* dt, int L, float A) {
  float c = 0.f;
#pragma unroll 8
  for (int l = 0; l < L; ++l) {
    c = __fadd_rn(c, __fmul_rn(dt[l], A));
    s_cum[l] = c;
    cum[l] = c;
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

struct Where {
  int bi, hi, gi, ci, bh, nc;
};

__device__ __forceinline__ Where where(const SsdBwdArgs& a) {
  Where w;
  w.nc = a.seq / a.chunk;
  w.bh = blockIdx.x / w.nc;
  w.ci = blockIdx.x - w.bh * w.nc;
  w.bi = w.bh / a.heads;
  w.hi = w.bh - w.bi * a.heads;
  w.gi = w.hi / (a.heads / a.groups);
  return w;
}

// the chunk's operands: x, dy (the head's), B and C (its group's) at row
// l = 0, and dt into ``s_dt`` (zero past L)
struct Chunk {
  const float *x, *dy, *B, *C;
};

__device__ __forceinline__ Chunk chunk_ptrs(const SsdBwdArgs& a,
                                            const Where& w, const Tiles& t,
                                            float* s_dt, int threads) {
  const long long base = (long long)w.ci * a.chunk;
  for (int l = threadIdx.x; l < t.Lp; l += threads)
    s_dt[l] = l < a.chunk ? a.dt[w.bi * a.sdt[0] + (base + l) * a.sdt[1] +
                                 w.hi * a.sdt[2]]
                          : 0.f;
  return {a.x + w.bi * a.sx[0] + base * a.sx[1] + w.hi * a.sx[2],
          a.dy + w.bi * a.sdy[0] + base * a.sdy[1] + w.hi * a.sdy[2],
          a.Bm + w.bi * a.sb[0] + base * a.sb[1] + w.gi * a.sb[2],
          a.Cm + w.bi * a.sc[0] + base * a.sc[1] + w.gi * a.sc[2]};
}

// ---------------------------------------------------------------- stage 1
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_bwd_states_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int L = a.chunk, P = a.p, N = a.n;
  const Tiles t = tiles(L, P, N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Where w = where(a);
  float* s_x = smem;                  // (Lp, ldp); row l weighs ex_l dt_l
  float* s_dy = s_x + t.Lp * t.ldp;   // (Lp, ldp); row l weighs e_l
  float* s_b = s_dy + t.Lp * t.ldp;   // (Lp, ldn)
  float* s_c = s_b + t.Lp * t.ldn;    // (Lp, ldn)
  float* s_cum = s_c + t.Lp * t.ldn;  // (Lp)
  float* s_dt = s_cum + t.Lp;
  float* s_sx = s_dt + t.Lp;          // ex_l dt_l
  float* s_sy = s_sx + t.Lp;          // e_l
  // dt, then x and B in one group and dy and C in another: S forms while
  // dy and C arrive, cum while both do
  const Chunk ch = chunk_ptrs(a, w, t, s_dt, kStateThreads);
  stage_tile(s_x, t.ldp, ch.x, L, P, t.Lp, t.Pp, a.sx[1], a.sx[3],
             a.vec & kVecX, kStateThreads);
  stage_tile(s_b, t.ldn, ch.B, L, N, t.Lp, t.Nq, a.sb[1], a.sb[3],
             a.vec & kVecB, kStateThreads);
  flash_tiles::cp_async_commit();
  stage_tile(s_dy, t.ldp, ch.dy, L, P, t.Lp, t.Pp, a.sdy[1], a.sdy[3],
             a.vec & kVecDy, kStateThreads);
  stage_tile(s_c, t.ldn, ch.C, L, N, t.Lp, t.Nq, a.sc[1], a.sc[3],
             a.vec & kVecC, kStateThreads);
  flash_tiles::cp_async_commit();
  __syncthreads();
  if (threadIdx.x == 0)
    chunk_cum(s_cum, a.cum + (size_t)blockIdx.x * L, s_dt, L, a.A[w.hi]);
  __syncthreads();
  for (int l = threadIdx.x; l < t.Lp; l += kStateThreads) {
    s_sx[l] = l < L ? expf(s_cum[L - 1] - s_cum[l]) * s_dt[l] : 0.f;
    s_sy[l] = l < L ? expf(s_cum[l]) : 0.f;
  }
  // S (then Q) in 16 x 32 tiles, a warp a tile: S(p, n) = sum_l ex_l dt_l
  // x(l, p) B(l, n), A read down its columns and scaled by its row's factor
  const int g = lane >> 2, tq = lane & 3;
  const int cols = t.Nq / 32, jobs = (t.Pp / 16) * cols;
  const bool pair = N % 2 == 0;
#pragma unroll 1
  for (int q = 0; q < 2; ++q) {
    if (q == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    for (int j = warp; j < jobs; j += kStateThreads / 32) {
      const int p0 = j / cols * 16, n0 = (j % cols) * 32;
      float acc[4][4];
      mma3<4, true, true>(acc, (q ? s_dy : s_x) + p0, t.ldp,
                          (q ? s_c : s_b) + n0, t.ldn, t.Lp,
                          q ? s_sy : s_sx);
      float* out = (q ? a.grads : a.states) + (size_t)blockIdx.x * P * N;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + g + 8 * r, n = n0 + 8 * jj + 2 * tq;
          store2(out + p * N + n, acc[jj][2 * r], acc[jj][2 * r + 1],
                 p < P && n < N, p < P && n + 1 < N, pair);
        }
    }
  }
}

// ---------------------------------------------------------------- stage 2
// The forward pass and the reverse pass in threads of their own, V
// neighbouring entries a thread (4, in 16-byte pieces, where P N is a
// multiple of 4 and the buffers are aligned): the first B H P N / V
// threads walk h_in, the next walk dH. Each thread issues the loads of
// eight chunks at a time before their multiply-adds (the compiler may not
// move one chunk's store past the next one's load).
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

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_passes_kernel(const SsdBwdArgs a) {
  const long long pn = (long long)a.p * a.n;
  const long long entries = (long long)a.batch * a.heads * pn;
  long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  const bool reverse = i >= entries;
  if (reverse) i -= entries;
  if (i >= entries) return;
  const long long bh = i / pn;
  const int nc = a.seq / a.chunk;
  // chunk c's cum_L at c L
  const float* cum_last = a.cum + bh * a.seq + a.chunk - 1;
  float* X = (reverse ? a.grads : a.states) + bh * nc * pn + (i - bh * pn);
  const float* init = reverse ? a.dh_last : a.h0;
  float h[V];
  if (init)
    load_v(h, init + i);
  else
#pragma unroll
    for (int u = 0; u < V; ++u) h[u] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float v[kPassBatch][V], d[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k < nc) {
        const int c = reverse ? nc - 1 - c0 - k : c0 + k;
        load_v(v[k], X + c * pn);
        d[k] = expf(cum_last[(long long)c * a.chunk]);
      }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k)
      if (c0 + k < nc) {
        store_v(X + (reverse ? nc - 1 - c0 - k : c0 + k) * pn, h);
#pragma unroll
        for (int u = 0; u < V; ++u) h[u] = d[k] * h[u] + v[k][u];
      }
  }
  if (reverse && a.dh0) store_v(a.dh0 + i, h);
}

// ---------------------------------------------------------------- stage 3
__global__ void __launch_bounds__(kGradThreads, 1)
ssd_bwd_grads_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int L = a.chunk, P = a.p, N = a.n, H = a.heads;
  const Tiles t = tiles(L, P, N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Where w = where(a);
  const int nb = t.Lp / 16, pb = t.Pp / 16, qb = t.Nq / 32;
  float* s_x = smem;                   // (Lp, ldp)
  float* s_dy = s_x + t.Lp * t.ldp;    // (Lp, ldp)
  float* s_b = s_dy + t.Lp * t.ldp;    // (Lp, ldn)
  float* s_c = s_b + t.Lp * t.ldn;     // (Lp, ldn)
  float* s_h = s_c + t.Lp * t.ldn;     // (Pp, ldn) h_in
  float* s_g = s_h + t.Pp * t.ldn;     // (Pp, ldn) dH
  float* s_m = s_g + t.Pp * t.ldn;     // (Lp, ldl) M = s w dt_m (0 for m > l)
  float* s_e = s_m + t.Lp * t.ldl;     // (Lp, ldl) E = w dt_m D (0 for m > l)
  float* s_cum = s_e + t.Lp * t.ldl;   // the per-row vectors (Lp each)
  float* s_dt = s_cum + t.Lp;
  float* s_ex = s_dt + t.Lp;           // exp(cum_L - cum_l)
  float* s_el = s_ex + t.Lp;           // exp(cum_l)
  float* s_row = s_el + t.Lp;          // (nb, Lp): row sums by column tile
  float* s_col = s_row + nb * t.Lp;    // (nb, Lp): column sums by row tile
  float* s_gm = s_col + nb * t.Lp;     // (pb, Lp): x_m . dH B_m by tile
  float* s_u = s_gm + pb * t.Lp;       // (qb, Lp): e_l dy_l . h_in C_l
  float* s_red = s_u + qb * t.Lp;      // kGradWarps

  // the chunk's tiles and stage 1's cum, then h_in and dH in a second
  // group, which lands while the triangle is formed
  const Chunk ch = chunk_ptrs(a, w, t, s_dt, kGradThreads);
  for (int l = threadIdx.x; l < t.Lp; l += kGradThreads)
    s_cum[l] = l < L ? a.cum[(size_t)blockIdx.x * L + l] : 0.f;
  stage_tile(s_x, t.ldp, ch.x, L, P, t.Lp, t.Pp, a.sx[1], a.sx[3],
             a.vec & kVecX, kGradThreads);
  stage_tile(s_dy, t.ldp, ch.dy, L, P, t.Lp, t.Pp, a.sdy[1], a.sdy[3],
             a.vec & kVecDy, kGradThreads);
  stage_tile(s_b, t.ldn, ch.B, L, N, t.Lp, t.Nq, a.sb[1], a.sb[3],
             a.vec & kVecB, kGradThreads);
  stage_tile(s_c, t.ldn, ch.C, L, N, t.Lp, t.Nq, a.sc[1], a.sc[3],
             a.vec & kVecC, kGradThreads);
  flash_tiles::cp_async_commit();
  const bool vs = a.vec & kVecState;
  stage_tile(s_g, t.ldn, a.grads + (size_t)blockIdx.x * P * N, P, N, t.Pp,
             t.Nq, N, 1, vs, kGradThreads);
  stage_tile(s_h, t.ldn, a.states + (size_t)blockIdx.x * P * N, P, N, t.Pp,
             t.Nq, N, 1, vs, kGradThreads);
  flash_tiles::cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const float A = a.A[w.hi];
  const float last = s_cum[L - 1];
  for (int l = threadIdx.x; l < t.Lp; l += kGradThreads) {
    s_ex[l] = l < L ? expf(last - s_cum[l]) : 0.f;
    s_el[l] = l < L ? expf(s_cum[l]) : 0.f;
  }
  __syncthreads();

  // the triangle in 16 x 16 tiles (l, m), a warp a tile: s = C B^T and
  // D = dy x^T, then M = s w dt_m and E = w dt_m D on m <= l, the row
  // sums sum_m s w D dt_m and the column sums sum_l s w D of the tile
  for (int job = warp; job < nb * nb; job += kGradWarps) {
    const int l0 = job / nb * 16, m0 = (job % nb) * 16;
    float sv[2][4], dv[2][4];
    if (m0 <= l0) {
      mma3<2, false, false>(sv, s_c + l0 * t.ldn, t.ldn, s_b + m0 * t.ldn,
                            t.ldn, t.Nq);
      mma3<2, false, false>(dv, s_dy + l0 * t.ldp, t.ldp, s_x + m0 * t.ldp,
                            t.ldp, t.Pp);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[j][e] = dv[j][e] = 0.f;
    }
    float row[2] = {0.f, 0.f}, col[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = l0 + g + (e >> 1) * 8, m = m0 + 8 * j + 2 * tq + (e & 1);
        const bool in = m <= l && l < L;
        const float wt = in ? expf(s_cum[l] - s_cum[m]) : 0.f;
        const float sw = sv[j][e] * wt;
        const float pr = sw * dv[j][e];
        s_m[l * t.ldl + m] = sw * s_dt[m];
        s_e[l * t.ldl + m] = wt * s_dt[m] * dv[j][e];
        row[e >> 1] += pr * s_dt[m];
        col[j][e & 1] += pr;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // over the quad's four lanes
      row[r] += __shfl_xor_sync(kFull, row[r], 1);
      row[r] += __shfl_xor_sync(kFull, row[r], 2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)   // over the eight row groups
        for (int d = 4; d < 32; d <<= 1)
          col[j][c] += __shfl_xor_sync(kFull, col[j][c], d);
    if (tq == 0) {
      s_row[(m0 / 16) * t.Lp + l0 + g] = row[0];
      s_row[(m0 / 16) * t.Lp + l0 + g + 8] = row[1];
    }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          s_col[(l0 / 16) * t.Lp + m0 + 8 * j + 2 * tq + c] = col[j][c];
  }
  cp_async_wait<0>();
  __syncthreads();

  const long long row0 = (long long)w.bi * a.seq + (long long)w.ci * L;
  const bool pair_p = P % 2 == 0, pair_n = N % 2 == 0;
  const int nx = nb * pb, nq = nb * qb;
  for (int job = warp; job < nx + 2 * nq; job += kGradWarps) {
    if (job < nx) {
      // dx in 16 x 16 tiles (m, p): M^T dy + ex_m dt_m (dH B_m), and the
      // tile's x_m . dH B_m; M^T's rows m take l >= m only, so K starts at
      // the tile's first row (the triangle's other products likewise)
      const int m0 = job / pb * 16, p0 = (job % pb) * 16;
      float mdy[2][4], hb[2][4];
      mma3<2, true, true>(mdy, s_m + m0 * t.ldl + m0, t.ldl,
                          s_dy + m0 * t.ldp + p0, t.ldp, t.Lp - m0);
      mma3<2, false, false>(hb, s_b + m0 * t.ldn, t.ldn, s_g + p0 * t.ldn,
                            t.ldn, t.Nq);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + g + 8 * r, p = p0 + 8 * j + 2 * tq;
          const float* hv = &hb[j][2 * r];
          part[r] += s_x[m * t.ldp + p] * hv[0] +
                     s_x[m * t.ldp + p + 1] * hv[1];
          const float f = s_ex[m] * s_dt[m];
          store2(a.dx + ((row0 + m) * H + w.hi) * P + p,
                 mdy[j][2 * r] + f * hv[0], mdy[j][2 * r + 1] + f * hv[1],
                 m < L && p < P, m < L && p + 1 < P, pair_p);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] += __shfl_xor_sync(kFull, part[r], 1);
        part[r] += __shfl_xor_sync(kFull, part[r], 2);
      }
      if (tq == 0) {
        s_gm[(p0 / 16) * t.Lp + m0 + g] = part[0];
        s_gm[(p0 / 16) * t.Lp + m0 + g + 8] = part[1];
      }
    } else if (job < nx + nq) {
      // dC (this head's share) in 16 x 32 tiles (l, n): E B + e_l dy
      // h_in, and the tile's e_l dy_l . h_in C_l
      const int jb = job - nx;
      const int l0 = jb / qb * 16, n0 = (jb % qb) * 32;
      float eb[4][4], dh[4][4];
      mma3<4, false, true>(eb, s_e + l0 * t.ldl, t.ldl, s_b + n0, t.ldn,
                           l0 + 16);   // m <= l
      mma3<4, false, true>(dh, s_dy + l0 * t.ldp, t.ldp, s_h + n0, t.ldn,
                           t.Pp);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int l = l0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
          const float hd0 = s_el[l] * dh[j][2 * r];
          const float hd1 = s_el[l] * dh[j][2 * r + 1];
          part[r] += s_c[l * t.ldn + n] * hd0 + s_c[l * t.ldn + n + 1] * hd1;
          store2(a.dC_heads + ((row0 + l) * H + w.hi) * N + n,
                 eb[j][2 * r] + hd0, eb[j][2 * r + 1] + hd1,
                 l < L && n < N, l < L && n + 1 < N, pair_n);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] += __shfl_xor_sync(kFull, part[r], 1);
        part[r] += __shfl_xor_sync(kFull, part[r], 2);
      }
      if (tq == 0) {
        s_u[(n0 / 32) * t.Lp + l0 + g] = part[0];
        s_u[(n0 / 32) * t.Lp + l0 + g + 8] = part[1];
      }
    } else {
      // dB (this head's share) in 16 x 32 tiles (m, n): E^T C + ex_m
      // dt_m x dH
      const int jb = job - nx - nq;
      const int m0 = jb / qb * 16, n0 = (jb % qb) * 32;
      float ec[4][4], xg[4][4];
      mma3<4, true, true>(ec, s_e + m0 * t.ldl + m0, t.ldl,
                          s_c + m0 * t.ldn + n0, t.ldn, t.Lp - m0);   // l >= m
      mma3<4, false, true>(xg, s_x + m0 * t.ldp, t.ldp, s_g + n0, t.ldn,
                           t.Pp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
          const float f = s_ex[m] * s_dt[m];
          store2(a.dB_heads + ((row0 + m) * H + w.hi) * N + n,
                 ec[j][2 * r] + f * xg[j][2 * r],
                 ec[j][2 * r + 1] + f * xg[j][2 * r + 1], m < L && n < N,
                 m < L && n + 1 < N, pair_n);
        }
    }
  }
  // <h_in, dH>: each thread's entries, then the warps', then in warp order
  float part = 0.f;
  for (int i = threadIdx.x; i < t.Pp * t.Nq; i += kGradThreads) {
    const int p = i / t.Nq;
    const int n = i - p * t.Nq;
    part += s_h[p * t.ldn + n] * s_g[p * t.ldn + n];
  }
  part = warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();

  // dcum, its reverse running sum da, ddt and this chunk's share of dA:
  // warp 0, lanes k and k + 32, every sum in an order fixed by the shape
  if (warp == 0) {
    float hg = 0.f;
    for (int i = 0; i < kGradWarps; ++i) hg += s_red[i];
    float dcum[2], col[2], exgm[2], r[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int k = lane + 32 * hf;
      float row = 0.f, gm = 0.f, u = 0.f;
      col[hf] = exgm[hf] = r[hf] = dcum[hf] = 0.f;
      if (k < L) {
        for (int j = 0; j < nb; ++j) row += s_row[j * t.Lp + k];
        for (int j = 0; j < nb; ++j) col[hf] += s_col[j * t.Lp + k];
        for (int j = 0; j < pb; ++j) gm += s_gm[j * t.Lp + k];
        for (int j = 0; j < qb; ++j) u += s_u[j * t.Lp + k];
        exgm[hf] = s_ex[k] * gm;
        r[hf] = s_dt[k] * exgm[hf];
        dcum[hf] = row - s_dt[k] * col[hf] + u - r[hf];
      }
    }
    const float rsum = warp_sum(r[0] + r[1]);
    const int lastk = L - 1;
    if (lane == (lastk & 31)) {
      const float extra = expf(last) * hg + rsum;
      if (lastk < 32) dcum[0] += extra; else dcum[1] += extra;
    }
    // suffix sums within each half, then the upper half's total added
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u0 = __shfl_down_sync(kFull, dcum[0], d);
      const float u1 = __shfl_down_sync(kFull, dcum[1], d);
      if (lane + d < 32) {
        dcum[0] += u0;
        dcum[1] += u1;
      }
    }
    dcum[0] += __shfl_sync(kFull, dcum[1], 0);
    float dA = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int k = lane + 32 * hf;
      if (k < L) {
        a.ddt[(row0 + k) * H + w.hi] = col[hf] + exgm[hf] + A * dcum[hf];
        dA += s_dt[k] * dcum[hf];
      }
    }
    dA = warp_sum(dA);
    if (lane == 0) a.dA_part[blockIdx.x] = dA;
  }
}

// ---------------------------------------------------------------- stage 4
// One launch of ordered sums. Its first ``group_blocks`` blocks sum dB and
// dC: each (b, s, g, n) its group's heads in head order; the rest sum dA:
// each head its (b, chunk) shares, b outer, in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sums_kernel(const SsdBwdArgs a, unsigned group_blocks) {
  if (blockIdx.x >= group_blocks) {
    const int h = (blockIdx.x - group_blocks) * kThreads + threadIdx.x;
    if (h >= a.heads) return;
    const int nc = a.seq / a.chunk;
    float acc = 0.f;
    for (int b = 0; b < a.batch; ++b)
      for (int c = 0; c < nc; ++c)
        acc += a.dA_part[((long long)b * a.heads + h) * nc + c];
    a.dA[h] = acc;
    return;
  }
  const long long total = (long long)a.batch * a.seq * a.groups * a.n;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int n = (int)(i % a.n);
  const long long bsg = i / a.n;
  const int g = (int)(bsg % a.groups);
  const long long bs = bsg / a.groups;
  const int rep = a.heads / a.groups;
  const long long first = (bs * a.heads + (long long)g * rep) * a.n + n;
  float sb = 0.f, sc = 0.f;
#pragma unroll 8
  for (int j = 0; j < rep; ++j) {
    sb += a.dB_heads[first + (long long)j * a.n];
    sc += a.dC_heads[first + (long long)j * a.n];
  }
  a.dB[i] = sb;
  a.dC[i] = sc;
}

template <typename K>
int allow_smem(K kernel, long long bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

long long blocks_for(long long threads) {
  return (threads + kThreads - 1) / kThreads;
}

bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;   // null passes
}

// whether a (b, s, h or g, last) view moves in 16-byte pieces: a 16-byte
// aligned start, unit last stride and the other strides multiples of 4
bool vec16(const float* p, const long long (&s)[4]) {
  return aligned16(p) && s[3] == 1 && s[0] % 4 == 0 && s[1] % 4 == 0 &&
         s[2] % 4 == 0;
}

}  // namespace

// The four launches of one gradient call on ``stream``. Returns
// cudaGetLastError() after each; the caller raises if it is not
// cudaSuccess.
extern "C" int ssd_bwd(const SsdBwdArgs* args, void* stream) {
  SsdBwdArgs a = *args;
  if (a.batch <= 0 || a.heads <= 0 || a.seq <= 0 || a.p <= 0 ||
      a.groups <= 0 || a.n <= 0 || a.heads % a.groups != 0 || a.chunk <= 0 ||
      a.chunk > kMaxChunk || a.seq % a.chunk != 0 ||
      (a.h0 == nullptr) != (a.dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)a.batch * a.heads * (a.seq / a.chunk);
  const long long entries = (long long)a.batch * a.heads * a.p * a.n;
  const long long rows = (long long)a.batch * a.seq * a.groups * a.n;
  const long long g_bytes = grads_floats(a.chunk, a.p, a.n) * sizeof(float);
  const long long s_bytes = states_floats(a.chunk, a.p, a.n) * sizeof(float);
  if (g_bytes > kSmemLimit || ctas > INT_MAX ||
      blocks_for(2 * entries) > INT_MAX ||
      blocks_for(rows) + blocks_for(a.heads) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a.vec = (vec16(a.x, a.sx) ? kVecX : 0) | (vec16(a.dy, a.sdy) ? kVecDy : 0) |
          (vec16(a.Bm, a.sb) ? kVecB : 0) | (vec16(a.Cm, a.sc) ? kVecC : 0) |
          (a.n % 4 == 0 && aligned16(a.states) && aligned16(a.grads)
               ? kVecState
               : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const int attr = allow_smem(ssd_bwd_grads_kernel, kSmemLimit) |
                          allow_smem(ssd_bwd_states_kernel, kSmemLimit);
  if (attr != 0) return attr;
  const unsigned group_blocks = (unsigned)blocks_for(rows);
  int err;
  ssd_bwd_states_kernel<<<(unsigned)ctas, kStateThreads, s_bytes, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  // the passes four entries a thread where every buffer they touch allows
  const bool v4 = entries % 4 == 0 && (long long)a.p * a.n % 4 == 0 &&
                  aligned16(a.states) && aligned16(a.grads) &&
                  aligned16(a.h0) && aligned16(a.dh_last) && aligned16(a.dh0);
  if (v4)
    ssd_bwd_passes_kernel<4>
        <<<(unsigned)blocks_for(2 * entries / 4), kThreads, 0, s>>>(a);
  else
    ssd_bwd_passes_kernel<1>
        <<<(unsigned)blocks_for(2 * entries), kThreads, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_grads_kernel<<<(unsigned)ctas, kGradThreads, g_bytes, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_sums_kernel<<<group_blocks + (unsigned)blocks_for(a.heads),
                        kThreads, 0, s>>>(a, group_blocks);
  return (int)cudaGetLastError();
}
