// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_bhcp (_ssd_kernel).
// For each (b, h), chunk by chunk, with cum the running sum of dt * A
// within the chunk and cum_L its last value:
//   y_l  = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) dt_m x_m
//        + exp(cum_l) (C_l . h_in)
//   h    = exp(cum_L) h + sum_l exp(cum_L - cum_l) dt_l x_l B_l^T
// B and C belong to group h / (H / G). The state h (P x N) is float32.
// Two designs, one entry point: P = N = 4 (the text predicate's SSD
// scorer) takes a warp per (b, h); every other shape (mamba2's scan,
// P = 64 and N = 128) takes three stages on the tensor cores.
//
// P = N = 4. Bound: latency. At the predicate's shapes (B <= 32, H = 2,
// S = 64, one chunk) a (b, h) pair moves ~3.6 KB and does ~50 K flops, so
// the time is the chain of dependent steps of one program plus the
// launch; at many rows it tends to bytes: x, dt, B and C are streamed
// once. One warp per (b, h), four warps to a CTA; the warp walks the
// chunks in order, so the TPU kernel's sequential chunk axis is a loop
// and there is no block barrier at all. Per chunk:
//   * loads: every lane issues its share of x, B, C and dt as cp.async
//     copies into the warp's shared tiles (16 bytes a copy where a row is
//     contiguous and 16-byte aligned, 4 otherwise), all before any compute,
//     and reads each operand through its own strides: the model's
//     (B, S, H, P) views, a dt broadcast over heads (stride 0) and the
//     kernel's own (B, H, S, P) layout are all read as they are;
//   * cum: a warp scan with shuffles. Lane i adds elements 2i and 2i + 1,
//     a Hillis-Steele scan over the 32 pair sums follows, and element 2i
//     is the exclusive prefix plus its own value: an order fixed by the
//     chunk length alone;
//   * y: lane i owns rows i and L-1-i, so every lane walks exactly L + 1
//     (row, m) steps of the triangle in lockstep (a row's steps by m in
//     index order). exp(cum_l - cum_m) is taken only for m <= l: above
//     the diagonal it could overflow and give inf * 0 = NaN. exp(cum_l)
//     is taken once a row;
//   * state: each lane sums its two rows' share of every (p, n) entry,
//     with the end weight dt_l exp(cum_L - cum_l) formed once a row, and a
//     butterfly of xor-shuffles (16, 8, 4, 2, 1) adds the 32 lanes, as a
//     reduce-scatter (each step keeps half the entries: 16 shuffles for 16
//     entries) whose sums are those of the full all-reduce. The order is
//     fixed by the shapes alone, never by B.
// What bounds it: at B <= 32 one warp's chain of L + 1 dependent (row, m)
// steps (~90 cycles each: a shared read, the dot, expf), with the launch;
// two steps are formed together so their latencies overlap. Tensor cores
// do not pay there: the contractions are K = N = 4 deep, below an mma's
// depth, and one TF32 product would move the predicate's scores past
// their decision margins (~1e-7); everything is float32 on the CUDA
// cores, and this instance's order of sums is kept bit for bit
// (tests/test_torch_ssd_layout.py::emulate_kernel).
//
// Every other shape. Bound: operations. At mamba2-370m's scan (B 4, S 512,
// H 32, P 64, G 1, N 128, chunk 64) the call moves 40.1 MB (x and y 16.8
// MB each, B and C 1.05 MB each, dt 0.26 MB, h_last 4.2 MB; 0.0120 ms at
// 3.35 TB/s) and does 3.22 GFLOP (kernels/ssd.py::flops): 0.0195 ms as
// 3xTF32 on the tensor cores (three TF32 products each at 495 TFLOP/s),
// 0.0481 ms at float32's 67 TFLOP/s on the CUDA cores. A warp per (b, h)
// cannot reach either: its tiles (115 KB) leave one warp an SM, 128 warps
// for 132 SMs, and every product is a scalar dot from shared memory. So
// the work is cut by chunk, as the gradient (csrc/ssd_bwd.cu) cuts it,
// with its stages 1 and 2 (csrc/ssd_stages.cuh): three launches, one call,
// scratch from the wrapper (the chunk states, B H (S / L) P N floats, and
// cum, B H S):
//   1. chunk states, a CTA of 8 warps per (b, h, chunk) and block of 64 x
//      128 entries of the state: S_c = sum_l ex_l dt_l x_l B_l^T and the
//      chunk's cum, summed in order by one thread (a warp scan loses the
//      accuracy of cum_l - cum_m, see chunk_cum);
//   2. the pass over the chunks, a thread per four (b, h, p, n) entries:
//      h_in(c + 1) = exp(cum_L) h_in(c) + S_c from h0 (or 0), each chunk's
//      entering state written over S_c, and h_last;
//   3. per-chunk outputs, a CTA of 16 warps per (b, h, chunk) and block
//      of 64 columns of P: x, B, C and h_in staged in shared memory (B, C
//      and h_in 128 columns of N at a time), then
//        y = (s o W) x + diag(e) C h_in^T,  s = C B^T,
//      W_lm = exp(cum_l - cum_m) dt_m for m <= l and 0 above, e_l =
//      exp(cum_l): a warp forms one 16 x 16 tile of the triangle s (the
//      tiles wholly above the diagonal are not formed) and one 16 x 16
//      tile of C h_in^T, then writes its tile of s o W to shared memory
//      (exp only for m <= l, as above); a warp's tile of y is (s o W) x
//      over the 16-blocks of m <= l and e_l C h_in^T added in registers,
//      written through y's strides.
// Every product is mma.sync m16n8k8 TF32 as 3xTF32 (ssd_stages.cuh's
// mma3: each float32 operand split into a TF32 hi part and a lo part,
// lo.hi + hi.lo summed apart from hi.hi): one TF32 product a pair would
// miss the float32 rule (TOL_TIGHT) at P = 64, N = 128. The tiles stay
// float32 in shared memory, rows of 4 mod 16 floats, zero-filled to the
// fragments' multiples (L and P to 16, N to 32). Stage 3 holds 117 KB at
// mamba2's shape, one CTA an SM, 1,024 CTAs; stage 1 holds 51 KB. No
// floating-point atomics: a rerun gives the same bits.
//
// The build passes --fmad=false, so no multiply-add is contracted.
// Padding tokens have dt = 0: their columns weigh nothing and the state
// passes through them unchanged. A null h0 is a zero state.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_stages.cuh"

// SsdArgs in the wrapper's struct format: pointers, then element strides
// in (b, s, h, last) order (dt has no last dimension), then the sizes.
// vec (ignored on entry; the entry point sets it): which operands move in
// 16-byte pieces.
struct SsdArgs {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* h0;  // (B, H, P, N) contiguous, or null for a zero state
  float* y;
  float* h_last;    // (B, H, P, N) contiguous
  long long sx[4], sdt[3], sb[4], sc[4], sy[4];
  int batch, heads, seq, p, groups, n, chunk, vec;
};
static_assert(sizeof(SsdArgs) == 248, "SsdArgs must match <8Q19q8i");

// the stages' arguments: SsdArgs with the scratch, under the names the
// stages share with the gradient's (dy and grads are the gradient's, null
// here)
struct FwdArgs {
  const float *x, *dt, *A, *Bm, *Cm, *h0, *dy;
  float *y, *h_last, *states, *grads, *cum;
  long long sx[4], sdt[3], sb[4], sc[4], sdy[4], sy[4];
  int batch, heads, seq, p, groups, n, chunk, vec;
};

namespace {

using namespace ssd_stages;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// ------------------------------------------------- P = N = 4: a warp per (b, h)
constexpr int kWarps = 4;           // programs (warps) a CTA, at most
constexpr int kStateTile = 16;      // state entries one butterfly carries
constexpr int kUnroll = 2;          // triangle steps formed together

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// floats of one warp's shared tiles: x (L, 4), B and C (L, 4), (cum, dt)
// pairs (kMaxChunk) and the state (4, 4); 16-byte aligned pieces
__host__ __device__ __forceinline__ int warp_floats(int L) {
  return round4(L * 4) + 2 * round4(L * 4) + 2 * kMaxChunk + 16;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// (rows, 4) of a strided operand into a dense shared tile, the warp's
// lanes taking neighbouring pieces
__device__ __forceinline__ void load_tile(float* dst, const float* src, int rows,
                                          long long rs, long long cs, bool vec,
                                          int lane) {
  if (vec) {
    for (int r = lane; r < rows; r += 32) cp_async16(dst + r * 4, src + r * rs);
  } else {
    for (int i = lane; i < rows * 4; i += 32) {
      const int r = i / 4;
      const int c = i - r * 4;
      cp_async4(dst + i, src + r * rs + c * cs);
    }
  }
}

// one (row, m) step of a lane's triangle: which of its rows, the weight
// (C_row . B_m) exp(cum_row - cum_m) dt_m, and the x row it scales
struct Step {
  bool first;
  float att;
  float x[4];
};

__device__ __forceinline__ Step step(int k, int r0, int r1, float cl0, float cl1,
                                     const float* s_x, const float* s_b,
                                     const float* s_c, const float2* s_cd) {
  Step st;
  st.first = k <= r0;
  const int row = st.first ? r0 : r1;
  const int m = st.first ? k : k - r0 - 1;
  float sc = 0.f;
  const float4 cr = *reinterpret_cast<const float4*>(s_c + row * 4);
  const float4 br = *reinterpret_cast<const float4*>(s_b + m * 4);
  sc = sc + cr.x * br.x;
  sc = sc + cr.y * br.y;
  sc = sc + cr.z * br.z;
  sc = sc + cr.w * br.w;
  const float2 cd = s_cd[m];
  st.att = sc * expf((st.first ? cl0 : cl1) - cd.x) * cd.y;
  const float4 xr = *reinterpret_cast<const float4*>(s_x + m * 4);
  st.x[0] = xr.x; st.x[1] = xr.y; st.x[2] = xr.z; st.x[3] = xr.w;
  return st;
}

// the step's share into its row's sums (selects, no branch)
__device__ __forceinline__ void accumulate(const Step& st, float (&acc0)[4],
                                           float (&acc1)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float t = st.att * st.x[q];
    acc0[q] = st.first ? acc0[q] + t : acc0[q];
    acc1[q] = st.first ? acc1[q] : acc1[q] + t;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ssd_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = 4, N = 4;
  const int L = a.chunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int prog = blockIdx.x * (blockDim.x >> 5) + warp;  // B * H < 2^31
  if (prog >= a.batch * a.heads) return;  // a whole warp
  const int bi = prog / a.heads;
  const int hi = prog - bi * a.heads;
  const int gi = hi / (a.heads / a.groups);

  float* s_x = smem + (size_t)warp * warp_floats(L);
  float* s_b = s_x + round4(L * P);
  float* s_c = s_b + round4(L * N);
  float2* s_cd = reinterpret_cast<float2*>(s_c + round4(L * N));  // (cum, dt)
  float* s_h = reinterpret_cast<float*>(s_cd + kMaxChunk);

  const float A = a.A[hi];
  const float* xb = a.x + bi * a.sx[0] + hi * a.sx[2];
  const float* db = a.dt + bi * a.sdt[0] + hi * a.sdt[2];
  const float* bb = a.Bm + bi * a.sb[0] + gi * a.sb[2];
  const float* cb = a.Cm + bi * a.sc[0] + gi * a.sc[2];
  float* yb = a.y + bi * a.sy[0] + hi * a.sy[2];
  constexpr int pn = P * N;
  const size_t state = (size_t)prog * pn;
  for (int i = lane; i < pn; i += 32) s_h[i] = a.h0 ? a.h0[state + i] : 0.f;

  // the rows of this lane: r0 = lane and r1 = L-1-lane, so the triangle's
  // (row, m) steps are L + 1 for every lane; r0 alone for the middle row
  // of an odd chunk; none past the chunk
  const bool own0 = lane < (L + 1) / 2;
  const bool own1 = lane < L / 2;
  const int r0 = own0 ? lane : 0;
  const int r1 = own1 ? L - 1 - lane : r0;
  const int steps = own1 ? L + 1 : (own0 ? r0 + 1 : 0);

  for (int base = 0; base < a.seq; base += L) {
    __syncwarp();  // the previous chunk's tiles and state reads are done
    load_tile(s_x, xb + base * a.sx[1], L, a.sx[1], a.sx[3], a.vec & 1, lane);
    load_tile(s_b, bb + base * a.sb[1], L, a.sb[1], a.sb[3], a.vec & 2, lane);
    load_tile(s_c, cb + base * a.sc[1], L, a.sc[1], a.sc[3], a.vec & 4, lane);
    for (int i = lane; i < L; i += 32) cp_async4(&s_cd[i].y, db + (base + i) * a.sdt[1]);
    cp_async_wait_all();
    __syncwarp();

    // cum: the warp scan (see the note)
    const int i0 = 2 * lane;
    const int i1 = i0 + 1;
    const float e0 = i0 < L ? s_cd[i0].y * A : 0.f;
    const float e1 = i1 < L ? s_cd[i1].y * A : 0.f;
    float v = e0 + e1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = v + t;
    }
    float ex = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) ex = 0.f;
    if (i0 < L) s_cd[i0].x = ex + e0;
    if (i1 < L) s_cd[i1].x = v;
    __syncwarp();

    // y: the (row, m) steps of rows r0 and r1
    const float cl0 = s_cd[r0].x;
    const float cl1 = s_cd[r1].x;
    const float ec0 = expf(cl0);
    const float ec1 = expf(cl1);
    float acc0[4], acc1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc0[q] = acc1[q] = 0.f;
    // kUnroll steps at a time: their weights are independent, so their
    // loads and exp chains overlap; they are added in step order
    int k = 0;
    for (; k + kUnroll <= steps; k += kUnroll) {
      Step st[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        st[u] = step(k + u, r0, r1, cl0, cl1, s_x, s_b, s_c, s_cd);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate(st[u], acc0, acc1);
    }
    for (; k < steps; ++k)
      accumulate(step(k, r0, r1, cl0, cl1, s_x, s_b, s_c, s_cd), acc0, acc1);
    // the entering state's share, then the stores
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? own1 : own0)) continue;
      const int row = half ? r1 : r0;
      const float ec = half ? ec1 : ec0;
      const float* crow = s_c + row * N;
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* hrow = s_h + q * N;
        float ch = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) ch = ch + crow[j] * hrow[j];
        out[q] = (half ? acc1[q] : acc0[q]) + ec * ch;
      }
      float* yrow = yb + (long long)(base + row) * a.sy[1];
      if (a.vec & 8) {
        *reinterpret_cast<float4*>(yrow) = make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) yrow[q * a.sy[3]] = out[q];
      }
    }
    __syncwarp();  // every lane's reads of the entering state are done

    // state: each lane's two rows, then the butterfly (see the note)
    const float last = s_cd[L - 1].x;
    const float el = expf(last);
    const float w0 = own0 ? s_cd[r0].y * expf(last - cl0) : 0.f;
    const float w1 = own1 ? s_cd[r1].y * expf(last - cl1) : 0.f;
    float part[kStateTile];
#pragma unroll
    for (int t = 0; t < kStateTile; ++t) {
      const int p = t / N;
      const int j = t - p * N;
      part[t] = 0.f;
      if (own0) part[t] = (s_x[r0 * P + p] * w0) * s_b[r0 * N + j];
      if (own1) part[t] = part[t] + (s_x[r1 * P + p] * w1) * s_b[r1 * N + j];
    }
    // reduce-scatter: each xor step keeps half the entries (the lane's
    // bit picks which) and adds the partner's share of them, so lane i
    // ends with entry 8 b4 + 4 b3 + 2 b2 + b1 of its bits; each sum is
    // the one a full xor all-reduce forms, bit for bit
    float v8[8], v4[4], v2[2];
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float keep = b4 ? part[t + 8] : part[t];
      v8[t] = keep + __shfl_xor_sync(kFull, b4 ? part[t] : part[t + 8], 16);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float keep = b3 ? v8[t + 4] : v8[t];
      v4[t] = keep + __shfl_xor_sync(kFull, b3 ? v8[t] : v8[t + 4], 8);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float keep = b2 ? v4[t + 2] : v4[t];
      v2[t] = keep + __shfl_xor_sync(kFull, b2 ? v4[t] : v4[t + 2], 4);
    }
    float mine = (b1 ? v2[1] : v2[0]) + __shfl_xor_sync(kFull, b1 ? v2[0] : v2[1], 2);
    mine = mine + __shfl_xor_sync(kFull, mine, 1);
    const int entry = (b4 ? 8 : 0) + (b3 ? 4 : 0) + (b2 ? 2 : 0) + (b1 ? 1 : 0);
    if ((lane & 1) == 0) s_h[entry] = el * s_h[entry] + mine;
  }
  __syncwarp();
  for (int i = lane; i < pn; i += 32) a.h_last[state + i] = s_h[i];
}

// whether a (b, s, h, last) operand's rows of 4 can move in 16-byte
// pieces: a contiguous last dimension, every row 16-byte aligned
bool rows16(const void* ptr, const long long (&st)[4]) {
  return st[3] == 1 && st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0 &&
         reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

int launch_p4n4(const SsdArgs& in, cudaStream_t s) {
  SsdArgs a = in;
  a.vec = rows16(a.x, a.sx) | rows16(a.Bm, a.sb) << 1 | rows16(a.Cm, a.sc) << 2 |
          rows16(a.y, a.sy) << 3;
  const size_t bytes = (size_t)kWarps * warp_floats(a.chunk) * sizeof(float);
  const int blocks = (a.batch * a.heads + kWarps - 1) / kWarps;
  ssd_kernel<<<blocks, kWarps * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------ every other shape: three stages
constexpr int kOutThreads = 512;   // stage 3: 16 warps, one CTA an SM
constexpr int kOutWarps = kOutThreads / 32;
constexpr int kPBlock = 64;        // P a CTA of stages 1 and 3 takes
constexpr int kNBlock = 128;       // N a CTA of stage 1 takes, and stage 3 at a time
constexpr int kVecY = 32;          // y's pairs of columns move as 8-byte pieces

// stage 3's tiles: the chunk's rows, a block of P and a slice of N
__host__ __device__ __forceinline__ Tiles out_tiles(int L, int P, int N) {
  return tiles(L, imin(P, kPBlock), imin(N, kNBlock));
}

// floats of stage 3's shared memory: x (L, P block), B's slice (L, N
// slice; then the weighted triangle (L, L) over it), C's slice (L, N
// slice), h_in's (P block, N slice), cum and dt (L)
__host__ __device__ __forceinline__ long long out_floats(int L, int P, int N) {
  const Tiles t = out_tiles(L, P, N);
  return (long long)t.Lp * t.ldp + (long long)t.Lp * imax(t.ldn, t.ldl) +
         (long long)t.Lp * t.ldn + (long long)t.Pp * t.ldn + 2LL * t.Lp;
}

// ---------------------------------------------------------------- stage 1
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_fwd_states_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  chunk_states<false>(a, smem, imin(a.p, kPBlock), imin(a.n, kNBlock));
}

// ---------------------------------------------------------------- stage 2
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_pass_kernel(const FwdArgs a) {
  const long long pn = (long long)a.p * a.n;
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (i >= (long long)a.batch * a.heads * pn) return;
  const long long bh = i / pn;
  const int nc = a.seq / a.chunk;
  float h[V];
  if (a.h0)
    load_v(h, a.h0 + i);
  else
#pragma unroll
    for (int u = 0; u < V; ++u) h[u] = 0.f;
  walk_chunks(h, a.states + bh * nc * pn + (i - bh * pn),
              a.cum + bh * a.seq + a.chunk - 1, nc, pn, a.chunk, false);
  store_v(a.h_last + i, h);
}

// ---------------------------------------------------------------- stage 3
template <int R, int C>
__device__ __forceinline__ void add_to(float (&acc)[R][C], const float (&v)[R][C]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < C; ++e) acc[j][e] += v[j][e];
}

__global__ void __launch_bounds__(kOutThreads, 1)
ssd_fwd_out_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int L = a.chunk, P = a.p, N = a.n;
  const Tiles t = out_tiles(L, P, N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Where w = where(a);
  const int p_off = blockIdx.y * kPBlock, prows = imin(P - p_off, kPBlock);
  const int nb = t.Lp / 16, pb = t.Pp / 16;
  float* s_x = smem;                              // (Lp, ldp): x's P block
  float* s_b = s_x + t.Lp * t.ldp;                // (Lp, ldn): B's N slice
  float* s_m = s_b;                               // (Lp, ldl): then s o W
  float* s_c = s_b + t.Lp * imax(t.ldn, t.ldl);   // (Lp, ldn): C's N slice
  float* s_h = s_c + t.Lp * t.ldn;                // (Pp, ldn): h_in's block
  float* s_cum = s_h + t.Pp * t.ldn;              // (Lp)
  float* s_dt = s_cum + t.Lp;                     // (Lp)

  // this warp's 16 x 16 tiles: (l0s, m0s) of the triangle s, the tiles
  // with m0s <= l0s row by row, and (l0y, p0y) of y; at most 10 and 16
  // (L <= 64, a P block of 64), one each for the 16 warps
  int si = 0, sj = warp;
  while (sj > si) sj -= ++si;
  const bool has_s = warp < nb * (nb + 1) / 2;
  const int l0s = 16 * si, m0s = 16 * sj;
  const bool has_y = warp < nb * pb;
  const int l0y = warp / pb * 16, p0y = warp % pb * 16;

  // dt, cum (stage 1's), then per slice of N: C and B in one group, x (at
  // the first) and h_in in another, which lands while s is formed
  const Chunk ch = chunk_ptrs<false>(a, w, t, s_dt, kOutThreads);
  for (int l = threadIdx.x; l < t.Lp; l += kOutThreads)
    s_cum[l] = l < L ? a.cum[(size_t)blockIdx.x * L + l] : 0.f;
  const float* h_in = a.states + ((size_t)blockIdx.x * P + p_off) * N;
  float sv[2][4] = {}, hv[2][4] = {}, part[2][4];
  for (int n0 = 0; n0 < N; n0 += kNBlock) {
    const int ncols = imin(N - n0, kNBlock);
    if (n0) __syncthreads();   // the previous slice's tiles are read
    stage_tile(s_c, t.ldn, ch.C + n0 * a.sc[3], L, ncols, t.Lp, t.Nq,
               a.sc[1], a.sc[3], a.vec & kVecC, kOutThreads);
    stage_tile(s_b, t.ldn, ch.B + n0 * a.sb[3], L, ncols, t.Lp, t.Nq,
               a.sb[1], a.sb[3], a.vec & kVecB, kOutThreads);
    flash_tiles::cp_async_commit();
    if (n0 == 0)
      stage_tile(s_x, t.ldp, ch.x + p_off * a.sx[3], L, prows, t.Lp, t.Pp,
                 a.sx[1], a.sx[3], a.vec & kVecX, kOutThreads);
    stage_tile(s_h, t.ldn, h_in + n0, prows, ncols, t.Pp, t.Nq, N, 1,
               a.vec & kVecState, kOutThreads);
    flash_tiles::cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (has_s) {   // s(l, m) = C_l . B_m
      mma3<2, false, false>(part, s_c + l0s * t.ldn, t.ldn,
                            s_b + m0s * t.ldn, t.ldn, t.Nq);
      add_to(sv, part);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (has_y) {   // (C h_in^T)(l, p) = C_l . h_in(p)
      mma3<2, false, false>(part, s_c + l0y * t.ldn, t.ldn,
                            s_h + p0y * t.ldn, t.ldn, t.Nq);
      add_to(hv, part);
    }
  }
  // s o W over B's slice (every read of it is done): 0 above the
  // diagonal and past L
  if (has_s)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = l0s + g + (e >> 1) * 8, m = m0s + 8 * j + 2 * tq + (e & 1);
        const bool in = m <= l && l < L;
        const float wt = in ? expf(s_cum[l] - s_cum[m]) : 0.f;
        s_m[l * t.ldl + m] = sv[j][e] * wt * s_dt[m];
      }
  __syncthreads();
  if (!has_y) return;
  // y = (s o W) x over m < l0y + 16, + e_l (C h_in^T)
  mma3<2, false, true>(part, s_m + l0y * t.ldl, t.ldl, s_x + p0y, t.ldp,
                       l0y + 16);
  const bool pair = a.vec & kVecY;
  float* yb = a.y + w.bi * a.sy[0] + (long long)w.ci * L * a.sy[1] +
              w.hi * a.sy[2] + p_off * a.sy[3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = l0y + g + 8 * r;
    if (l >= L) continue;
    const float el = expf(s_cum[l]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = p0y + 8 * j + 2 * tq;
      const float v0 = part[j][2 * r] + el * hv[j][2 * r];
      const float v1 = part[j][2 * r + 1] + el * hv[j][2 * r + 1];
      float* q = yb + l * a.sy[1] + p * a.sy[3];
      if (pair) {
        if (p < prows) *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
      } else {
        if (p < prows) q[0] = v0;
        if (p + 1 < prows) q[a.sy[3]] = v1;
      }
    }
  }
}

int launch_stages(const SsdArgs& in, float* scratch, cudaStream_t s) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  FwdArgs a{in.x, in.dt, in.A, in.Bm, in.Cm, in.h0, nullptr,
            in.y, in.h_last, nullptr, nullptr, nullptr};
  for (int k = 0; k < 4; ++k) {
    a.sx[k] = in.sx[k], a.sb[k] = in.sb[k], a.sc[k] = in.sc[k];
    a.sy[k] = in.sy[k], a.sdy[k] = 0;
  }
  for (int k = 0; k < 3; ++k) a.sdt[k] = in.sdt[k];
  a.batch = in.batch, a.heads = in.heads, a.seq = in.seq, a.p = in.p;
  a.groups = in.groups, a.n = in.n, a.chunk = in.chunk;
  const int L = a.chunk, pbk = imin(a.p, kPBlock), nbk = imin(a.n, kNBlock);
  const long long ctas = (long long)a.batch * a.heads * (a.seq / L);
  const long long pn = (long long)a.p * a.n;
  const long long entries = (long long)a.batch * a.heads * pn;
  const long long state_blocks =
      (long long)((a.p + pbk - 1) / pbk) * ((a.n + nbk - 1) / nbk);
  const long long out_blocks = (a.p + kPBlock - 1) / kPBlock;
  if (ctas > INT_MAX || state_blocks > 65535 || out_blocks > 65535 ||
      blocks_for(entries) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a.states = scratch;             // (B, H, S / L, P, N): S_c, then h_in(c)
  a.cum = scratch + ctas * pn;    // (B, H, S)
  const bool pair_y = a.sy[3] == 1 && a.p % 2 == 0 && a.sy[0] % 2 == 0 &&
                      a.sy[1] % 2 == 0 && a.sy[2] % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(a.y) % 8 == 0;
  a.vec = (vec16(a.x, a.sx) ? kVecX : 0) | (vec16(a.Bm, a.sb) ? kVecB : 0) |
          (vec16(a.Cm, a.sc) ? kVecC : 0) |
          (a.n % 4 == 0 && aligned16(a.states) ? kVecState : 0) |
          (pair_y ? kVecY : 0);
  static const int attr = allow_smem(ssd_fwd_states_kernel, kSmemLimit) |
                          allow_smem(ssd_fwd_out_kernel, kSmemLimit);
  if (attr != 0) return attr;
  const long long s_bytes =
      states_floats(tiles(L, pbk, nbk), false) * sizeof(float);
  const long long o_bytes = out_floats(L, a.p, a.n) * sizeof(float);
  int err;
  ssd_fwd_states_kernel<<<dim3((unsigned)ctas, (unsigned)state_blocks),
                          kStateThreads, s_bytes, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  // the pass four entries a thread where the buffers it touches allow
  if (pn % 4 == 0 && aligned16(a.states) && aligned16(a.h0) &&
      aligned16(a.h_last))
    ssd_fwd_pass_kernel<4>
        <<<(unsigned)blocks_for(entries / 4), kThreads, 0, s>>>(a);
  else
    ssd_fwd_pass_kernel<1><<<(unsigned)blocks_for(entries), kThreads, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ssd_fwd_out_kernel<<<dim3((unsigned)ctas, (unsigned)out_blocks),
                       kOutThreads, o_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, G, N); each
// addressed by the element strides in SsdArgs; h0 (or null) and h_last:
// (B, H, P, N) contiguous; all float32 on the card. G divides H,
// 1 <= chunk <= 64 and chunk divides S. ``scratch``: null when P = N = 4,
// else B H (S / chunk) P N + B H S floats on the card (kernels/ssd.py::
// scratch_floats). One launch at P = N = 4, three otherwise. Returns
// cudaGetLastError() after each launch; the caller raises if it is not
// cudaSuccess.
extern "C" int ssd_scan(const SsdArgs* a, float* scratch, void* stream) {
  if (a->batch <= 0 || a->heads <= 0 || a->seq <= 0 || a->p <= 0 ||
      a->groups <= 0 || a->n <= 0 || a->heads % a->groups != 0 ||
      a->chunk <= 0 || a->chunk > kMaxChunk || a->seq % a->chunk != 0 ||
      (long long)a->batch * a->heads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->p == 4 && a->n == 4) return launch_p4n4(*a, s);
  return launch_stages(*a, scratch, s);
}
