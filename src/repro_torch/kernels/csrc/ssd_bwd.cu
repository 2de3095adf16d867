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
//   3. per-chunk gradients, a CTA per (b, chunk) and K consecutive heads
//      of one group, one head after another, the chunk's tiles, h_in and
//      dH staged in shared memory and the intra-chunk terms recomputed:
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
//      this head's shares, which the CTA sums over its K heads in head
//      order into one partial;
//   4. one launch of ordered sums: dB and dC summed over the H / (G K)
//      partials of a group in order, and dA over b, then the chunks.
// No floating-point atomics anywhere: a rerun gives the same bits. cum is
// formed once, by stage 1, summed in order with no contraction, and read
// by stages 2 and 3. Stages 1 and 2 are the forward's (csrc/ssd.cu), in
// csrc/ssd_stages.cuh; the gradient is held to tolerances against
// kernels/ref.py::ssd_bwd, not to bits.
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
// m16n8k8 TF32 as 3xTF32 (ssd_stages.cuh's mma3): each float32 operand
// is split in registers into a TF32 hi part and a lo part, and the
// product sums lo.hi + hi.lo apart from hi.hi (the tensor cores truncate
// their sums), as csrc/flash_tiles.cuh's tiles do; one TF32 pass (10
// mantissa bits) would not hold dt's cancelling gradient to float32's
// rule. The tiles stay float32 in shared memory, rows of 4 mod 16
// floats: a fragment read
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
//   - scratch traffic: states and grads, cum (1 MB) and one partial of
//     dB and of dC a CTA of stage 3, a launch fewer with stage 4's two
//     sums in one; stage 2 walks the two passes in threads of their own
//     and issues each batch of eight chunks' loads before its chain.
// Operands move into shared memory by cp.async in 16-byte pieces where
// a view allows it (unit last stride, 16-byte aligned rows: the entry
// point works that out into ``vec``), else by each thread's own loads
// through the strides (a dt broadcast over heads, the all-zero strides of
// a missing y-cotangent, P or N not a multiple of 4). Stage 3 holds x,
// dy, B, C, h_in, dH, M and E: 205 KB at L = 64, P = 64, N = 128, one CTA
// of 16 warps an SM (two would need half these tiles); h_in and dH
// arrive while the triangle is formed.
// Heads a CTA: a CTA of stage 3 takes K consecutive heads of a group in
// turn. B and C, the group's, are staged once for all K; each head's dB
// and dC shares go to the CTA's partial in the scratch, stored by the
// first head and added to by the others in head order (each entry by the
// same thread, so the adds need no barrier, and they hit L2: a CTA's
// partial is 64 KB at mamba2's shape), every load of a tile issued before
// its first store. K is the largest divisor of H / G up to 8 that adds no
// wave of CTAs on the card's 132 SMs (``cta_heads``): at mamba2's
// training shape 8 (128 CTAs, one wave of 8 heads each where 1,024 CTAs
// took 8 waves), 4 partials a (b, s), 2 x 4.2 MB of scratch where each
// head's shares took 2 x 33.5 MB; where every divisor adds a wave, 1,
// each head its own partial.
// Stage 1 holds x, dy, B and C: 101 KB, two CTAs of 8 warps an SM. The
// wrapper refuses shapes whose stage-3 tiles exceed the 227 KB a CTA may
// hold (kernels/ssd.py::grad_smem_bytes is grads_floats below in bytes)
// before the forward runs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_stages.cuh"

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
  float* dB_part;        // (B, S, H / K, N) scratch: a CTA's K heads' dB
  float* dC_part;        // (B, S, H / K, N) scratch: a CTA's K heads' dC
  float* dA_part;        // (B, H, NC) scratch: each chunk's share of dA
  long long sx[4], sdt[3], sb[4], sc[4], sdy[4];
  int batch, heads, seq, p, groups, n, chunk;
  int vec;  // the entry point's: which operands move in 16-byte pieces
};
static_assert(sizeof(SsdBwdArgs) == 344, "SsdBwdArgs must match <20Q19q8i");

namespace {

using namespace ssd_stages;

constexpr int kGradThreads = 512;    // stage 3: 16 warps, one CTA an SM
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kMaxCtaHeads = 8;      // heads one CTA of stage 3 takes
constexpr long long kWave = 132;     // the H100 SXM's SMs: one CTA each

// K, the heads a CTA of stage 3 takes in turn: of the divisors of H / G up
// to kMaxCtaHeads (a CTA's heads share a group), the one whose waves of
// CTAs times K is least (the head-times its SMs take), the largest of
// those that tie; by the shape alone (kernels/ssd.py::cta_heads)
__host__ __device__ __forceinline__ int cta_heads(int batch, int seq,
                                                  int heads, int groups,
                                                  int chunk) {
  const long long chunks = (long long)batch * (seq / chunk);
  const int rep = heads / groups;
  int best = 1;
  long long least = (chunks * heads + kWave - 1) / kWave;
  for (int k = 2; k <= kMaxCtaHeads; ++k) {
    if (rep % k != 0) continue;
    const long long t = (chunks * (heads / k) + kWave - 1) / kWave * k;
    if (t <= least) {
      least = t;
      best = k;
    }
  }
  return best;
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// ---------------------------------------------------------------- stage 1
// S and Q of the whole state (ssd_stages.cuh's chunk_states, one block)
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_bwd_states_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  chunk_states<true>(a, smem, a.p, a.n);
}

// ---------------------------------------------------------------- stage 2
// The forward pass and the reverse pass in threads of their own
// (ssd_stages.cuh's walk_chunks): the first B H P N / V threads walk
// h_in, the next walk dH.
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
  walk_chunks(h, X, cum_last, nc, pn, a.chunk, reverse);
  if (reverse && a.dh0) store_v(a.dh0 + i, h);
}

// ---------------------------------------------------------------- stage 3
// the two floats at q that store2 writes (one 8-byte load where ``pair``),
// 0 where they lie outside the result
__device__ __forceinline__ float2 load2(const float* q, bool in0, bool in1,
                                        bool pair) {
  if (pair) return in0 ? *reinterpret_cast<const float2*>(q)
                       : make_float2(0.f, 0.f);
  return make_float2(in0 ? q[0] : 0.f, in1 ? q[1] : 0.f);
}

// A job's 16 x 32 tile of a head's dB or dC share (``v``: the fragments of
// rows r0 + g and r0 + g + 8 and columns n0 + 8 j + 2 tq) into the CTA's
// partial ``part`` of ``parts`` a (b, s) in ``out``: stored by the CTA's
// first head; after it (``add``) each entry's earlier heads' sum is added,
// every load of the tile issued before its first store
__device__ __forceinline__ void to_partial(float (&v)[4][4], float* out,
                                           long long row0, int r0, int n0,
                                           int parts, int part, int L, int N,
                                           int g, int tq, bool pair,
                                           bool add) {
  if (add) {
    float2 prev[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = r0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
        prev[j][r] = load2(out + ((row0 + l) * parts + part) * N + n,
                           l < L && n < N, l < L && n + 1 < N, pair);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)   // the earlier heads' sum, then this head's
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        v[j][2 * r] = prev[j][r].x + v[j][2 * r];
        v[j][2 * r + 1] = prev[j][r].y + v[j][2 * r + 1];
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = r0 + g + 8 * r, n = n0 + 8 * j + 2 * tq;
      store2(out + ((row0 + l) * parts + part) * N + n, v[j][2 * r],
             v[j][2 * r + 1], l < L && n < N, l < L && n + 1 < N, pair);
    }
}

// A CTA of stage 3: (b, chunk) and the K heads blockIdx.x / nc of one
// group (blockIdx.x in (b, head block, chunk) order), one head after
// another; kTurns false: K = 1, the loop and the adds compiled out
template <bool kTurns>
__global__ void __launch_bounds__(kGradThreads, 1)
ssd_bwd_grads_kernel(const SsdBwdArgs a, int K) {
  if (!kTurns) K = 1;
  extern __shared__ __align__(16) float smem[];
  const int L = a.chunk, P = a.p, N = a.n, H = a.heads;
  const Tiles t = tiles(L, P, N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
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

  Where w;
  w.nc = a.seq / a.chunk;
  const int blk = (int)blockIdx.x / w.nc;   // b (H / K) + head block
  w.ci = (int)blockIdx.x - blk * w.nc;
  w.bi = blk / (H / K);
  // the CTA's partial, of H / K a (b, s), and its heads' group
  const int slot = blk - w.bi * (H / K), slots = H / K;
  w.gi = slot * K / (H / a.groups);
  const long long row0 = (long long)w.bi * a.seq + (long long)w.ci * L;
  const bool pair_p = P % 2 == 0, pair_n = N % 2 == 0;
  const int nx = nb * pb, nq = nb * qb;
  for (int head = 0; head < K; ++head) {
    w.hi = slot * K + head;
    w.bh = w.bi * H + w.hi;
    const size_t bhc = (size_t)w.bh * w.nc + w.ci;
    // the partial holds the earlier heads' sum
    const bool add = kTurns && head > 0;
    // the last head's reads of shared memory are done
    if (add) __syncthreads();

    // the chunk's tiles (B and C, the group's, for the first head only)
    // and stage 1's cum, then h_in and dH in a second group, which lands
    // while the triangle is formed
    const Chunk ch = chunk_ptrs<true>(a, w, t, s_dt, kGradThreads);
    for (int l = threadIdx.x; l < t.Lp; l += kGradThreads)
      s_cum[l] = l < L ? a.cum[bhc * L + l] : 0.f;
    stage_tile(s_x, t.ldp, ch.x, L, P, t.Lp, t.Pp, a.sx[1], a.sx[3],
               a.vec & kVecX, kGradThreads);
    stage_tile(s_dy, t.ldp, ch.dy, L, P, t.Lp, t.Pp, a.sdy[1], a.sdy[3],
               a.vec & kVecDy, kGradThreads);
    if (!add) {
      stage_tile(s_b, t.ldn, ch.B, L, N, t.Lp, t.Nq, a.sb[1], a.sb[3],
                 a.vec & kVecB, kGradThreads);
      stage_tile(s_c, t.ldn, ch.C, L, N, t.Lp, t.Nq, a.sc[1], a.sc[3],
                 a.vec & kVecC, kGradThreads);
    }
    flash_tiles::cp_async_commit();
    const bool vs = a.vec & kVecState;
    stage_tile(s_g, t.ldn, a.grads + bhc * P * N, P, N, t.Pp, t.Nq, N, 1, vs,
               kGradThreads);
    stage_tile(s_h, t.ldn, a.states + bhc * P * N, P, N, t.Pp, t.Nq, N, 1,
               vs, kGradThreads);
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
          const int l = l0 + g + (e >> 1) * 8;
          const int m = m0 + 8 * j + 2 * tq + (e & 1);
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

    for (int job = warp; job < nx + 2 * nq; job += kGradWarps) {
      if (job < nx) {
        // dx in 16 x 16 tiles (m, p): M^T dy + ex_m dt_m (dH B_m), and the
        // tile's x_m . dH B_m; M^T's rows m take l >= m only, so K starts
        // at the tile's first row (the triangle's other products likewise)
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
        // h_in, and the tile's e_l dy_l . h_in C_l; into the partial
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
            part[r] += s_c[l * t.ldn + n] * hd0 +
                       s_c[l * t.ldn + n + 1] * hd1;
            eb[j][2 * r] += hd0;
            eb[j][2 * r + 1] += hd1;
          }
        to_partial(eb, a.dC_part, row0, l0, n0, slots, slot, L, N, g, tq,
                   pair_n, add);
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
        // dt_m x dH; into the partial
        const int jb = job - nx - nq;
        const int m0 = jb / qb * 16, n0 = (jb % qb) * 32;
        float ec[4][4], xg[4][4];
        mma3<4, true, true>(ec, s_e + m0 * t.ldl + m0, t.ldl,
                            s_c + m0 * t.ldn + n0, t.ldn, t.Lp - m0);  // l >= m
        mma3<4, false, true>(xg, s_x + m0 * t.ldp, t.ldp, s_g + n0, t.ldn,
                             t.Pp);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int m = m0 + g + 8 * r;
            const float f = s_ex[m] * s_dt[m];
            ec[j][2 * r] += f * xg[j][2 * r];
            ec[j][2 * r + 1] += f * xg[j][2 * r + 1];
          }
        to_partial(ec, a.dB_part, row0, m0, n0, slots, slot, L, N, g, tq,
                   pair_n, add);
      }
    }
    // <h_in, dH>: each thread's entries, then the warps', then in warp
    // order
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
      if (lane == 0) a.dA_part[bhc] = dA;
    }
  }
}

// ---------------------------------------------------------------- stage 4
// One launch of ordered sums. Its first ``group_blocks`` blocks sum dB and
// dC: each (b, s, g, n) its group's ``parts`` partials (each K heads' sum)
// in head order; the rest sum dA: each head its (b, chunk) shares, b
// outer, in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sums_kernel(const SsdBwdArgs a, unsigned group_blocks, int parts) {
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
  const long long bsg = i / a.n;   // (b, s) G + g
  const long long first = bsg * parts * a.n + n;
  float sb = 0.f, sc = 0.f;
#pragma unroll 8
  for (int j = 0; j < parts; ++j) {
    sb += a.dB_part[first + (long long)j * a.n];
    sc += a.dC_part[first + (long long)j * a.n];
  }
  a.dB[i] = sb;
  a.dC[i] = sc;
}

}  // namespace

// The partials of dB and of dC a (b, s) that a call at these sizes
// writes, H / K (K the heads a CTA of stage 3 takes), so that the caller
// sizes their scratch; -1 for sizes the entry point refuses
extern "C" int ssd_bwd_parts(int batch, int seq, int heads, int groups,
                             int chunk) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || chunk <= 0 || chunk > kMaxChunk ||
      seq % chunk != 0)
    return -1;
  return heads / cta_heads(batch, seq, heads, groups, chunk);
}

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
  const long long s_bytes =
      states_floats(tiles(a.chunk, a.p, a.n), true) * sizeof(float);
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
  static const int attr =
      allow_smem(ssd_bwd_grads_kernel<false>, kSmemLimit) |
      allow_smem(ssd_bwd_grads_kernel<true>, kSmemLimit) |
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
  const int K = cta_heads(a.batch, a.seq, a.heads, a.groups, a.chunk);
  if (K == 1)
    ssd_bwd_grads_kernel<false>
        <<<(unsigned)ctas, kGradThreads, g_bytes, s>>>(a, 1);
  else
    ssd_bwd_grads_kernel<true>
        <<<(unsigned)(ctas / K), kGradThreads, g_bytes, s>>>(a, K);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_sums_kernel<<<group_blocks + (unsigned)blocks_for(a.heads),
                        kThreads, 0, s>>>(a, group_blocks,
                                          a.heads / a.groups / K);
  return (int)cudaGetLastError();
}
