// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_bhcp (_ssd_kernel).
// For each (b, h), chunk by chunk, with cum the running sum of dt * A
// within the chunk and cum_L its last value:
//   y_l  = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) dt_m x_m
//        + exp(cum_l) (C_l . h_in)
//   h    = exp(cum_L) h + sum_l exp(cum_L - cum_l) dt_l x_l B_l^T
// B and C belong to group h / (H / G). The state h (P x N) is float32.
//
// Bound: at the predicate's shapes (B <= 32, H = 2, S = 64, P = N = 4, one
// chunk) latency: a (b, h) pair moves ~3.6 KB and does ~50 K flops, so the
// time is the chain of dependent steps of one program plus the launch. At
// many rows it tends to bytes: x, dt, B and C are streamed once.
//
// Design. One warp per (b, h), four warps to a CTA (fewer when a warp's
// tiles outgrow shared memory); the warp walks the chunks in order, so
// the TPU kernel's sequential chunk axis is a loop and there is no block
// barrier at all. Per chunk:
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
//     index order, as before). exp(cum_l - cum_m) is taken only for
//     m <= l: above the diagonal it could overflow and give inf * 0 = NaN.
//     exp(cum_l) is taken once a row;
//   * state: each lane sums its two rows' share of every (p, n) entry,
//     with the end weight dt_l exp(cum_L - cum_l) formed once a row, and a
//     butterfly of xor-shuffles (16, 8, 4, 2, 1) adds the 32 lanes, as a
//     reduce-scatter (each step keeps half the entries: 16 shuffles for 16
//     entries) whose sums are those of the full all-reduce: the 16
//     threads x 64 serial steps of the first kernel become 2 steps and 5
//     shuffle rounds. The order is fixed by the shapes alone, never by B.
// What bounds it now: at B <= 32 one warp's chain of L + 1 dependent
// (row, m) steps (~90 cycles each: a shared read, the dot, expf), with the
// launch; two steps are formed together so their latencies overlap. At
// B = 4096 the same steps' instructions (~40 a step) on all SMs.
// Tensor cores do not pay here: the contractions are K = N = 4 deep,
// below an mma's depth, and one TF32 product would move the predicate's
// scores past their decision margins (~1e-7); everything is float32 on
// the CUDA cores. The build passes --fmad=false, so no multiply-add is
// contracted. Padding tokens have dt = 0: their columns weigh nothing and
// the state passes through them unchanged. A null h0 is a zero state.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// SsdArgs in the wrapper's struct format: pointers, then element strides
// in (b, s, h, last) order (dt has no last dimension), then the sizes.
// vec (ignored on entry; the entry point sets it): bit 0 x, bit 1 B, bit
// 2 C, bit 3 y can move in 16-byte pieces.
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

namespace {

constexpr int kWarps = 4;           // programs (warps) a CTA, at most
constexpr int kMaxChunk = 64;       // two rows a lane
constexpr int kStateTile = 16;      // state entries one butterfly carries
constexpr int kUnroll = 2;          // triangle steps formed together
constexpr int kSmemLimit = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// floats of one warp's shared tiles: x (L, P), B and C (L, N), (cum, dt)
// pairs (kMaxChunk) and the state (P, N); 16-byte aligned pieces
__host__ __device__ __forceinline__ int warp_floats(int L, int p, int n) {
  return round4(L * p) + 2 * round4(L * n) + 2 * kMaxChunk + round4(p * n);
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

// (rows, cols) of a strided operand into a dense shared tile, the warp's
// lanes taking neighbouring pieces
__device__ __forceinline__ void load_tile(float* dst, const float* src, int rows,
                                          int cols, long long rs, long long cs,
                                          bool vec, int lane) {
  if (vec) {
    const int q = cols >> 2;
    for (int i = lane; i < rows * q; i += 32) {
      const int r = i / q;
      const int c = (i - r * q) << 2;
      cp_async16(dst + r * cols + c, src + r * rs + c);
    }
  } else {
    for (int i = lane; i < rows * cols; i += 32) {
      const int r = i / cols;
      const int c = i - r * cols;
      cp_async4(dst + i, src + r * rs + c * cs);
    }
  }
}

// one (row, m) step of a lane's triangle: which of its rows, the weight
// (C_row . B_m) exp(cum_row - cum_m) dt_m, and the x row it scales
template <int PT>
struct Step {
  bool first;
  float att;
  float x[PT];
};

template <int PC, int NC, int PT>
__device__ __forceinline__ Step<PT> step(int k, int r0, int r1, float cl0, float cl1,
                                         const float* s_x, const float* s_b,
                                         const float* s_c, const float2* s_cd,
                                         int P, int N, int p0) {
  Step<PT> st;
  st.first = k <= r0;
  const int row = st.first ? r0 : r1;
  const int m = st.first ? k : k - r0 - 1;
  float sc = 0.f;
  if constexpr (PC == 4 && NC == 4) {  // 16-byte rows: one read each
    const float4 cr = *reinterpret_cast<const float4*>(s_c + row * 4);
    const float4 br = *reinterpret_cast<const float4*>(s_b + m * 4);
    sc = sc + cr.x * br.x;
    sc = sc + cr.y * br.y;
    sc = sc + cr.z * br.z;
    sc = sc + cr.w * br.w;
  } else {
    const float* crow = s_c + row * N;
    const float* brow = s_b + m * N;
#pragma unroll 4
    for (int j = 0; j < N; ++j) sc = sc + crow[j] * brow[j];
  }
  const float2 cd = s_cd[m];
  st.att = sc * expf((st.first ? cl0 : cl1) - cd.x) * cd.y;
  if constexpr (PC == 4) {
    const float4 xr = *reinterpret_cast<const float4*>(s_x + m * 4);
    st.x[0] = xr.x; st.x[1] = xr.y; st.x[2] = xr.z; st.x[3] = xr.w;
  } else {
#pragma unroll
    for (int q = 0; q < PT; ++q) st.x[q] = p0 + q < P ? s_x[m * P + p0 + q] : 0.f;
  }
  return st;
}

// the step's share into its row's sums (selects, no branch)
template <int PC, int PT>
__device__ __forceinline__ void accumulate(const Step<PT>& st, float (&acc0)[PT],
                                           float (&acc1)[PT], int P, int p0) {
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    if (PC || p0 + q < P) {
      const float t = st.att * st.x[q];
      acc0[q] = st.first ? acc0[q] + t : acc0[q];
      acc1[q] = st.first ? acc1[q] : acc1[q] + t;
    }
  }
}

// PC, NC: P and N when fixed at compile time (the predicate's 4 and 4),
// 0 when read from the arguments; y is formed PT columns at a time.
template <int PC, int NC>
__global__ void __launch_bounds__(kWarps * 32)
ssd_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PT = PC ? PC : 8;
  const int P = PC ? PC : a.p;
  const int N = NC ? NC : a.n;
  const int L = a.chunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int prog = blockIdx.x * (blockDim.x >> 5) + warp;  // B * H < 2^31
  if (prog >= a.batch * a.heads) return;  // a whole warp
  const int bi = prog / a.heads;
  const int hi = prog - bi * a.heads;
  const int gi = hi / (a.heads / a.groups);

  float* s_x = smem + (size_t)warp * warp_floats(L, P, N);
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
  const int pn = P * N;
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
    load_tile(s_x, xb + base * a.sx[1], L, P, a.sx[1], a.sx[3], a.vec & 1, lane);
    load_tile(s_b, bb + base * a.sb[1], L, N, a.sb[1], a.sb[3], a.vec & 2, lane);
    load_tile(s_c, cb + base * a.sc[1], L, N, a.sc[1], a.sc[3], a.vec & 4, lane);
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

    // y: the (row, m) steps of rows r0 and r1, P columns PT at a time
    const float cl0 = s_cd[r0].x;
    const float cl1 = s_cd[r1].x;
    const float ec0 = expf(cl0);
    const float ec1 = expf(cl1);
    for (int p0 = 0; p0 < P; p0 += PT) {
      float acc0[PT], acc1[PT];
#pragma unroll
      for (int q = 0; q < PT; ++q) acc0[q] = acc1[q] = 0.f;
      // kUnroll steps at a time: their weights are independent, so their
      // loads and exp chains overlap; they are added in step order
      int k = 0;
      for (; k + kUnroll <= steps; k += kUnroll) {
        Step<PT> st[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          st[u] = step<PC, NC, PT>(k + u, r0, r1, cl0, cl1, s_x, s_b, s_c, s_cd, P, N, p0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) accumulate<PC, PT>(st[u], acc0, acc1, P, p0);
      }
      for (; k < steps; ++k)
        accumulate<PC, PT>(step<PC, NC, PT>(k, r0, r1, cl0, cl1, s_x, s_b, s_c, s_cd, P, N, p0),
                           acc0, acc1, P, p0);
      // the entering state's share, then the stores
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? own1 : own0)) continue;
        const int row = half ? r1 : r0;
        const float ec = half ? ec1 : ec0;
        const float* crow = s_c + row * N;
        float out[PT];
#pragma unroll
        for (int q = 0; q < PT; ++q) {
          out[q] = 0.f;
          if (PC || p0 + q < P) {
            const float* hrow = s_h + (p0 + q) * N;
            float ch = 0.f;
#pragma unroll 4
            for (int j = 0; j < N; ++j) ch = ch + crow[j] * hrow[j];
            out[q] = (half ? acc1[q] : acc0[q]) + ec * ch;
          }
        }
        float* yrow = yb + (long long)(base + row) * a.sy[1];
        if (PC == 4 && (a.vec & 8)) {
          *reinterpret_cast<float4*>(yrow) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
          for (int q = 0; q < PT; ++q)
            if (PC || p0 + q < P) yrow[(p0 + q) * a.sy[3]] = out[q];
        }
      }
    }
    __syncwarp();  // every lane's reads of the entering state are done

    // state: each lane's two rows, then the butterfly (see the note)
    const float last = s_cd[L - 1].x;
    const float el = expf(last);
    const float w0 = own0 ? s_cd[r0].y * expf(last - cl0) : 0.f;
    const float w1 = own1 ? s_cd[r1].y * expf(last - cl1) : 0.f;
    for (int e0 = 0; e0 < pn; e0 += kStateTile) {
      float part[kStateTile];
#pragma unroll
      for (int t = 0; t < kStateTile; ++t) {
        part[t] = 0.f;
        const int e = e0 + t;
        if (e < pn) {
          const int p = e / N;
          const int j = e - p * N;
          if (own0) part[t] = (s_x[r0 * P + p] * w0) * s_b[r0 * N + j];
          if (own1) part[t] = part[t] + (s_x[r1 * P + p] * w1) * s_b[r1 * N + j];
        }
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
      if ((lane & 1) == 0 && e0 + entry < pn)
        s_h[e0 + entry] = el * s_h[e0 + entry] + mine;
    }
  }
  __syncwarp();
  for (int i = lane; i < pn; i += 32) a.h_last[state + i] = s_h[i];
}

// whether a (b, s, h, last) operand's rows can move in 16-byte pieces: a
// contiguous last dimension of a multiple of 4 floats, every row 16-byte
// aligned
bool rows16(const void* ptr, const long long (&st)[4], int last) {
  return st[3] == 1 && last % 4 == 0 && st[0] % 4 == 0 && st[1] % 4 == 0 &&
         st[2] % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int PC, int NC>
int launch(const SsdArgs& a, int warps, size_t bytes, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<PC, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.batch * a.heads + warps - 1) / warps;
  ssd_kernel<PC, NC><<<blocks, warps * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, G, N); each
// addressed by the element strides in SsdArgs; h0 (or null) and h_last:
// (B, H, P, N) contiguous; all float32 on the card. G divides H,
// 1 <= chunk <= 64 and chunk divides S. Returns cudaGetLastError() after
// the launch; the caller raises if it is not cudaSuccess.
extern "C" int ssd_scan(const SsdArgs* a, void* stream) {
  if (a->batch <= 0 || a->heads <= 0 || a->seq <= 0 || a->p <= 0 ||
      a->groups <= 0 || a->n <= 0 || a->heads % a->groups != 0 ||
      a->chunk <= 0 || a->chunk > kMaxChunk || a->seq % a->chunk != 0 ||
      (long long)a->batch * a->heads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)warp_floats(a->chunk, a->p, a->n) * sizeof(float);
  if (per_warp > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int warps = (int)(kSmemLimit / per_warp < (size_t)kWarps
                              ? kSmemLimit / per_warp : kWarps);
  const size_t bytes = warps * per_warp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  SsdArgs k = *a;
  k.vec = rows16(k.x, k.sx, k.p) | rows16(k.Bm, k.sb, k.n) << 1 |
          rows16(k.Cm, k.sc, k.n) << 2 | rows16(k.y, k.sy, k.p) << 3;
  if (k.p == 4 && k.n == 4) return launch<4, 4>(k, warps, bytes, s);
  return launch<0, 0>(k, warps, bytes, s);
}
