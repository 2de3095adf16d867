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
// s_lm = C_l . B_m and D_lm = dy_l . x_m. Four stages, five launches, one
// call:
//   1. chunk states, a CTA per (b, h, chunk):
//        S_c = sum_l ex_l dt_l x_l B_l^T,  Q_c = sum_l e_l dy_l C_l^T
//      (P x N each) and cum_L, into scratch;
//   2. the passes over the chunks, a thread per (b, h, p, n) entry:
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
//   4. an ordered reduction: dB and dC summed over the H / G heads of a
//      group in head order, dA over b, then the chunks.
// No floating-point atomics anywhere: a rerun gives the same bits. cum is
// summed in order by one thread, with no contraction, in stages 1 and 3
// alike (the same bits; csrc/ssd.cu's warp scan sums in another order, so
// the gradient is held to tolerances against kernels/ref.py::ssd_bwd, not
// to bits). The library is built without --fmad=false: multiply-adds are
// contracted (dt's gradient is a difference of large terms either way).
//
// Bound: operations. Per (b, h, chunk), with T = L (L + 1) / 2 entries of
// a triangle: 5 L P N multiply-adds (S, Q, dH B_m, h_in^T dy_l,
// dH^T x_m) and T (3 N + 2 P) (s, D, the triangle's sums of dx, dC and
// dB): at mamba2's training shape (B 4, S 512, H 32, P 64, G 1, N 128,
// chunk 64) 7.5 GFLOP, 0.112 ms at float32's 67 TFLOP/s, against 55 MB
// of operands and results, 0.016 ms at 3.35 TB/s.
//
// Design: float32 on the CUDA cores, 512 threads a CTA. Stage 3's shared
// rows are padded to an odd number of floats, so lanes that walk a
// column (different rows, one column) hit 32 different banks; the
// contractions are laid out so that the lanes of a warp read one row of a
// tile at consecutive addresses and the other operand as a broadcast: a
// warp owns a row m (or l) of dx, dB or dC and its lanes its columns,
// which also lets the warp reduce x_m . dH B_m and dy_l . h_in C_l by
// shuffles in a fixed order. Shared memory at L = 64, P = 64, N = 128:
// 196 KB, one CTA of 16 warps an SM; the wrapper refuses shapes whose tiles
// exceed the 227 KB a CTA may hold (kernels/ssd.py::grad_smem_bytes is
// grads_floats below in bytes) before the forward runs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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
  float* cum_last;       // (B, H, NC) scratch
  float* dB_heads;       // (B, S, H, N) scratch: each head's share of dB
  float* dC_heads;       // (B, S, H, N) scratch: each head's share of dC
  float* dA_part;        // (B, H, NC) scratch: each chunk's share of dA
  long long sx[4], sdt[3], sb[4], sc[4], sdy[4];
  int batch, heads, seq, p, groups, n, chunk, pad;
};
static_assert(sizeof(SsdBwdArgs) == 344, "SsdBwdArgs must match <20Q19q8i");

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr int kSmemLimit = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int odd(int d) { return d | 1; }

// floats of stage 3's shared memory: x and dy (L, P), B and C (L, N),
// h_in and dH (P, N), the two (L, L) triangles, eight per-row vectors and
// the block reduction's slots; every row padded to an odd length
__host__ __device__ __forceinline__ long long grads_floats(int L, int P, int N) {
  return 2LL * L * odd(P) + 2LL * L * odd(N) + 2LL * P * odd(N) +
         2LL * L * odd(L) + 8LL * L + kWarps;
}

// floats of stage 1's: x and dy (L, P), B and C (L, N), cum and dt
__host__ __device__ __forceinline__ long long states_floats(int L, int P, int N) {
  return 2LL * L * P + 2LL * L * N + 2LL * L;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// (rows, cols) of a strided operand into a shared tile whose rows are
// ``ld`` floats apart; neighbouring threads take neighbouring columns
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int rows, int cols, long long rs,
                                          long long cs) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[r * ld + c] = src[r * rs + c * cs];
  }
}

// cum_l = sum_{k <= l} dt_k A in order by thread 0, with no contraction:
// stages 1 and 3 get the same bits
__device__ __forceinline__ void chunk_cum(float* cum, const float* dt, int L,
                                          float A) {
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int l = 0; l < L; ++l) {
      c = __fadd_rn(c, __fmul_rn(dt[l], A));
      cum[l] = c;
    }
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

// ---------------------------------------------------------------- stage 1
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const SsdBwdArgs a) {
  extern __shared__ float smem[];
  const int L = a.chunk, P = a.p, N = a.n;
  const Where w = where(a);
  float* s_x = smem;           // (L, P), scaled by ex_l dt_l
  float* s_dy = s_x + L * P;   // (L, P), scaled by e_l
  float* s_b = s_dy + L * P;   // (L, N)
  float* s_c = s_b + L * N;    // (L, N)
  float* s_cum = s_c + L * N;  // (L)
  float* s_dt = s_cum + L;     // (L)
  const long long base = (long long)w.ci * L;
  load_tile(s_x, P, a.x + w.bi * a.sx[0] + base * a.sx[1] + w.hi * a.sx[2],
            L, P, a.sx[1], a.sx[3]);
  load_tile(s_dy, P, a.dy + w.bi * a.sdy[0] + base * a.sdy[1] + w.hi * a.sdy[2],
            L, P, a.sdy[1], a.sdy[3]);
  load_tile(s_b, N, a.Bm + w.bi * a.sb[0] + base * a.sb[1] + w.gi * a.sb[2],
            L, N, a.sb[1], a.sb[3]);
  load_tile(s_c, N, a.Cm + w.bi * a.sc[0] + base * a.sc[1] + w.gi * a.sc[2],
            L, N, a.sc[1], a.sc[3]);
  for (int l = threadIdx.x; l < L; l += kThreads)
    s_dt[l] = a.dt[w.bi * a.sdt[0] + (base + l) * a.sdt[1] + w.hi * a.sdt[2]];
  __syncthreads();
  chunk_cum(s_cum, s_dt, L, a.A[w.hi]);
  __syncthreads();
  const float last = s_cum[L - 1];
  for (int i = threadIdx.x; i < L * P; i += kThreads) {
    const int l = i / P;
    s_x[i] *= expf(last - s_cum[l]) * s_dt[l];
    s_dy[i] *= expf(s_cum[l]);
  }
  if (threadIdx.x == 0) a.cum_last[blockIdx.x] = last;
  __syncthreads();
  float* S = a.states + (size_t)blockIdx.x * P * N;
  float* Q = a.grads + (size_t)blockIdx.x * P * N;
  for (int i = threadIdx.x; i < P * N; i += kThreads) {
    const int p = i / N;
    const int n = i - p * N;
    float s = 0.f, q = 0.f;
    for (int l = 0; l < L; ++l) {
      s += s_x[l * P + p] * s_b[l * N + n];
      q += s_dy[l * P + p] * s_c[l * N + n];
    }
    S[i] = s;
    Q[i] = q;
  }
}

// ---------------------------------------------------------------- stage 2
__global__ void __launch_bounds__(kThreads)
ssd_bwd_passes_kernel(const SsdBwdArgs a) {
  const long long pn = (long long)a.p * a.n;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)a.batch * a.heads * pn) return;
  const long long bh = i / pn;
  const long long e = i - bh * pn;
  const int nc = a.seq / a.chunk;
  const float* decay = a.cum_last + bh * nc;
  float* S = a.states + bh * nc * pn + e;
  float* Q = a.grads + bh * nc * pn + e;
  float h = a.h0 ? a.h0[i] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const float s = S[c * pn];
    S[c * pn] = h;
    h = expf(decay[c]) * h + s;
  }
  float g = a.dh_last ? a.dh_last[i] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float q = Q[c * pn];
    Q[c * pn] = g;
    g = expf(decay[c]) * g + q;
  }
  if (a.dh0) a.dh0[i] = g;
}

// ---------------------------------------------------------------- stage 3
__global__ void __launch_bounds__(kThreads)
ssd_bwd_grads_kernel(const SsdBwdArgs a) {
  extern __shared__ float smem[];
  const int L = a.chunk, P = a.p, N = a.n, H = a.heads;
  const int lp = odd(P), ln = odd(N), ll = odd(L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Where w = where(a);
  float* s_x = smem;             // (L, P)
  float* s_dy = s_x + L * lp;    // (L, P)
  float* s_b = s_dy + L * lp;    // (L, N)
  float* s_c = s_b + L * ln;     // (L, N)
  float* s_h = s_c + L * ln;     // (P, N) h_in
  float* s_g = s_h + P * ln;     // (P, N) dH
  float* s_m = s_g + P * ln;     // (L, L) s, then M = s w dt_m
  float* s_e = s_m + L * ll;     // (L, L) D, then E = w dt_m D
  float* s_cum = s_e + L * ll;   // the per-row vectors
  float* s_dt = s_cum + L;
  float* s_ex = s_dt + L;        // exp(cum_L - cum_l)
  float* s_el = s_ex + L;        // exp(cum_l)
  float* s_row = s_el + L;       // sum_{m<=l} s w dt_m D
  float* s_col = s_row + L;      // sum_{j>=m} s w D
  float* s_gm = s_col + L;       // x_m . dH B_m
  float* s_u = s_gm + L;         // e_l dy_l . h_in C_l
  float* s_red = s_u + L;        // kWarps

  const long long base = (long long)w.ci * L;
  load_tile(s_x, lp, a.x + w.bi * a.sx[0] + base * a.sx[1] + w.hi * a.sx[2],
            L, P, a.sx[1], a.sx[3]);
  load_tile(s_dy, lp, a.dy + w.bi * a.sdy[0] + base * a.sdy[1] + w.hi * a.sdy[2],
            L, P, a.sdy[1], a.sdy[3]);
  load_tile(s_b, ln, a.Bm + w.bi * a.sb[0] + base * a.sb[1] + w.gi * a.sb[2],
            L, N, a.sb[1], a.sb[3]);
  load_tile(s_c, ln, a.Cm + w.bi * a.sc[0] + base * a.sc[1] + w.gi * a.sc[2],
            L, N, a.sc[1], a.sc[3]);
  load_tile(s_h, ln, a.states + (size_t)blockIdx.x * P * N, P, N, N, 1);
  load_tile(s_g, ln, a.grads + (size_t)blockIdx.x * P * N, P, N, N, 1);
  for (int l = threadIdx.x; l < L; l += kThreads)
    s_dt[l] = a.dt[w.bi * a.sdt[0] + (base + l) * a.sdt[1] + w.hi * a.sdt[2]];
  __syncthreads();
  const float A = a.A[w.hi];
  chunk_cum(s_cum, s_dt, L, A);
  __syncthreads();
  const float last = s_cum[L - 1];
  for (int l = threadIdx.x; l < L; l += kThreads) {
    s_ex[l] = expf(last - s_cum[l]);
    s_el[l] = expf(s_cum[l]);
  }

  // s_lm = C_l . B_m and D_lm = dy_l . x_m on the triangle m <= l (0 above)
  for (int i = threadIdx.x; i < L * L; i += kThreads) {
    const int l = i / L;
    const int m = i - l * L;
    float sc = 0.f, d = 0.f;
    if (m <= l) {
      for (int n = 0; n < N; ++n) sc += s_c[l * ln + n] * s_b[m * ln + n];
      for (int p = 0; p < P; ++p) d += s_dy[l * lp + p] * s_x[m * lp + p];
    }
    s_m[l * ll + m] = sc;
    s_e[l * ll + m] = d;
  }
  __syncthreads();

  // the triangle's row sums (d/dcum_l) and column sums (d/ddt_m), each a
  // thread's, in index order
  if (threadIdx.x < L) {
    const int l = threadIdx.x;
    float acc = 0.f;
    for (int m = 0; m <= l; ++m)
      acc += s_m[l * ll + m] * expf(s_cum[l] - s_cum[m]) * s_dt[m] *
             s_e[l * ll + m];
    s_row[l] = acc;
  } else if (threadIdx.x < 2 * L) {
    const int m = threadIdx.x - L;
    float acc = 0.f;
    for (int l = m; l < L; ++l)
      acc += s_m[l * ll + m] * expf(s_cum[l] - s_cum[m]) * s_e[l * ll + m];
    s_col[m] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * L; i += kThreads) {
    const int l = i / L;
    const int m = i - l * L;
    if (m <= l) {
      const float wd = expf(s_cum[l] - s_cum[m]) * s_dt[m];
      s_m[l * ll + m] *= wd;
      s_e[l * ll + m] *= wd;
    }
  }
  __syncthreads();

  const long long row0 = (long long)w.bi * a.seq + base;  // (b, s) row of l = 0
  // dx_m and x_m . dH B_m: a warp a row m, its lanes the columns p
  for (int m = warp; m < L; m += kWarps) {
    float part = 0.f;
    for (int p = lane; p < P; p += 32) {
      float acc = 0.f, hb = 0.f;
      for (int l = m; l < L; ++l) acc += s_m[l * ll + m] * s_dy[l * lp + p];
      for (int n = 0; n < N; ++n) hb += s_g[p * ln + n] * s_b[m * ln + n];
      a.dx[((row0 + m) * H + w.hi) * P + p] = acc + s_ex[m] * s_dt[m] * hb;
      part += s_x[m * lp + p] * hb;
    }
    part = warp_sum(part);
    if (lane == 0) s_gm[m] = part;
  }
  // dC_l (this head's share) and e_l dy_l . h_in C_l: a warp a row l
  for (int l = warp; l < L; l += kWarps) {
    float part = 0.f;
    for (int n = lane; n < N; n += 32) {
      float acc = 0.f, hd = 0.f;
      for (int m = 0; m <= l; ++m) acc += s_e[l * ll + m] * s_b[m * ln + n];
      for (int p = 0; p < P; ++p) hd += s_dy[l * lp + p] * s_h[p * ln + n];
      hd *= s_el[l];
      a.dC_heads[((row0 + l) * H + w.hi) * N + n] = acc + hd;
      part += s_c[l * ln + n] * hd;
    }
    part = warp_sum(part);
    if (lane == 0) s_u[l] = part;
  }
  // dB_m (this head's share): a warp a row m
  for (int m = warp; m < L; m += kWarps) {
    for (int n = lane; n < N; n += 32) {
      float acc = 0.f, xg = 0.f;
      for (int l = m; l < L; ++l) acc += s_e[l * ll + m] * s_c[l * ln + n];
      for (int p = 0; p < P; ++p) xg += s_x[m * lp + p] * s_g[p * ln + n];
      a.dB_heads[((row0 + m) * H + w.hi) * N + n] =
          acc + s_ex[m] * s_dt[m] * xg;
    }
  }
  // <h_in, dH>: each thread's entries, then the warps', then in warp order
  float part = 0.f;
  for (int i = threadIdx.x; i < P * N; i += kThreads) {
    const int p = i / N;
    const int n = i - p * N;
    part += s_h[p * ln + n] * s_g[p * ln + n];
  }
  part = warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();

  // dcum, its reverse running sum da, ddt and this chunk's share of dA, in
  // order by one thread
  if (threadIdx.x == 0) {
    float hg = 0.f;
    for (int i = 0; i < kWarps; ++i) hg += s_red[i];
    float rsum = 0.f;
    for (int l = 0; l < L; ++l) rsum += s_dt[l] * s_ex[l] * s_gm[l];
    float da = 0.f, dA = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      float dcum = s_row[k] - s_dt[k] * s_col[k] + s_u[k] -
                   s_dt[k] * s_ex[k] * s_gm[k];
      if (k == L - 1) dcum += expf(last) * hg + rsum;
      da += dcum;
      a.ddt[(row0 + k) * H + w.hi] = s_col[k] + s_ex[k] * s_gm[k] + A * da;
      dA += s_dt[k] * da;
    }
    a.dA_part[blockIdx.x] = dA;
  }
}

// ---------------------------------------------------------------- stage 4
// dB and dC: each (b, s, g, n) sums its group's heads in head order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_kernel(const SsdBwdArgs a) {
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
  for (int j = 0; j < rep; ++j) {
    sb += a.dB_heads[first + (long long)j * a.n];
    sc += a.dC_heads[first + (long long)j * a.n];
  }
  a.dB[i] = sb;
  a.dC[i] = sc;
}

// dA: each head sums its (b, chunk) shares, b outer, in order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_da_kernel(const SsdBwdArgs a) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= a.heads) return;
  const int nc = a.seq / a.chunk;
  float acc = 0.f;
  for (int b = 0; b < a.batch; ++b)
    for (int c = 0; c < nc; ++c)
      acc += a.dA_part[((long long)b * a.heads + h) * nc + c];
  a.dA[h] = acc;
}

template <typename K>
int allow_smem(K kernel, long long bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

long long blocks_for(long long threads) {
  return (threads + kThreads - 1) / kThreads;
}

}  // namespace

// The five launches of one gradient call on ``stream``. Returns
// cudaGetLastError() after each; the caller raises if it is not
// cudaSuccess.
extern "C" int ssd_bwd(const SsdBwdArgs* a, void* stream) {
  if (a->batch <= 0 || a->heads <= 0 || a->seq <= 0 || a->p <= 0 ||
      a->groups <= 0 || a->n <= 0 || a->heads % a->groups != 0 ||
      a->chunk <= 0 || a->chunk > kMaxChunk || a->seq % a->chunk != 0 ||
      (a->h0 == nullptr) != (a->dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)a->batch * a->heads * (a->seq / a->chunk);
  const long long entries = (long long)a->batch * a->heads * a->p * a->n;
  const long long rows = (long long)a->batch * a->seq * a->groups * a->n;
  const long long g_bytes = grads_floats(a->chunk, a->p, a->n) * sizeof(float);
  const long long s_bytes = states_floats(a->chunk, a->p, a->n) * sizeof(float);
  if (g_bytes > kSmemLimit || ctas > INT_MAX ||
      blocks_for(entries) > INT_MAX || blocks_for(rows) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const int attr = allow_smem(ssd_bwd_grads_kernel, kSmemLimit) |
                          allow_smem(ssd_bwd_states_kernel, kSmemLimit);
  if (attr != 0) return attr;
  int err;
  ssd_bwd_states_kernel<<<(unsigned)ctas, kThreads, s_bytes, s>>>(*a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_passes_kernel<<<(unsigned)blocks_for(entries), kThreads, 0, s>>>(*a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_grads_kernel<<<(unsigned)ctas, kThreads, g_bytes, s>>>(*a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_group_kernel<<<(unsigned)blocks_for(rows), kThreads, 0, s>>>(*a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_bwd_da_kernel<<<(unsigned)blocks_for(a->heads), kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
