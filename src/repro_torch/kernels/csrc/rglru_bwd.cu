// The gradient of the RG-LRU linear recurrence for Hopper (sm_90a) --
// recurrentgemma / Griffin training.
//
// Replaces the gradient of the TPU kernel
// src/repro/kernels/rglru.py::rglru_bsw (_rglru_kernel): the JAX package
// trains through its plain scan (ops.rglru under attention_impl "xla")
// and differentiates that; the Pallas kernel has no backward. With the
// forward's notation (csrc/rglru.cu) and sr = sigmoid(r_t), si =
// sigmoid(i_t), a_t = exp(-c softplus(L) sr), g_t = si x_t, m_t =
// sqrt(max(1 - a_t^2, 1e-12)), per channel (b, w), walking t down from
// S - 1:
//   dh_t = dout_t + a_{t+1} dh_{t+1}          (dh_last at t = S - 1)
//   dx_t = dh_t m_t si
//   di_t = dh_t m_t x_t si (1 - si)
//   da_t = dh_t h_{t-1} - dh_t g_t a_t / m_t   (the second term 0 where
//                                               the clamp binds)
//   dr_t = da_t a_t (-c softplus(L)) sr (1 - sr)
//   dL   = sigmoid(L) sum over b, t of da_t a_t (-c sr)
//   dh0  = a_0 dh_0
// h_{t-1} is read from the forward's float32 h sequence, which the
// autograd function keeps (in a bf16 model the returned output is
// rounded, and rebuilding h from it would carry that rounding into da).
//
// Bound: bytes. Each (t, w) reads x, r, i, h and dout and writes dx, dr
// and di after a few dozen flops: 32 B in float32, 18 B in a bf16 model
// (x, r, i, dout, dx, dr, di in bf16 beside the float32 h), over the
// memory rate once B * W channels fill the card.
//
// Two instances: float32 throughout, and bf16 x, r, i and dout in with
// bf16 dx, dr and di out (a bf16 model's tensors as they are: no float32
// copies, no casts back). The bf16 instance stages its inputs as bf16
// and widens each element to float32 where it reads it (exact), keeps h,
// dh0 and dL in float32, and rounds dx, dr and di once to nearest even:
// the float32 instance's results rounded as torch's cast rounds them, bit
// for bit.
//
// Design: a CTA per (row b, tile of up to 32 channels), walking S in
// chunks of 32 steps from the end, as the forward (csrc/rglru.cu) does.
// Eight warps form the terms, a ninth walks dh, and the two overlap: at
// step j of the walk
//   - the walker (one lane a channel) walks chunk j backwards from shared
//     memory, writing dh_t (over dout_t in float32, beside it in bf16)
//     and carrying a_t dh_t in a register across chunks;
//   - the other 256 threads form dx, dr and di of chunk j - 1 (walked at
//     step j - 1), store them (neighbouring lanes to neighbouring
//     addresses) and add its da_t a_t (-c sr) to a register of their
//     own, then form a_t and sigmoid(r_t) of chunk j + 1 for the walker
//     (thread tid takes channel tid % tile at every (256 / tile)-th step,
//     its steps unrolled so their chains overlap);
//   - they also copy chunk j + 2's x, r, i, h_{t-1} and dout rows into
//     shared memory with cp.async (16-byte pieces where W is a multiple
//     of 16 bytes' elements and the arrays are 16-byte aligned; else 4
//     bytes, or a bf16 element by a plain load; h_{-1} is h0 or 0), four
//     chunks of tiles in flight;
// and one barrier a step hands the chunks on.
// No floating-point atomics: at the end the threads of a channel add
// their partial sums of dL in a fixed order into a (B, W) buffer, and a
// second kernel adds the rows b = 0 .. B - 1 in order and multiplies by
// sigmoid(L). The same inputs give the same bits, and each thread sums
// its steps in the order of a walk that takes one phase at a time (the
// terms' thread of a step is fixed), so dL has those bits too. The
// library is built with --fmad=false, as the forward's: every term takes
// the plain version's operations in its order (the plain version sums dL
// in another order).
// What bounds it now: not bytes (the float32 and bf16 instances take the
// same time, ~64 G elements/s, the forward kernel's rate too), and
// neither the walk's chain nor the loads' latency alone (timed by
// clock64, each fills the whole step; a deeper ring, a walk fed from
// registers and twice the workers each left the time where it was). The
// grid is B * W / 32 CTAs, two an SM; each reads 64-byte row pieces
// 8 KB apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

// RglruBwdArgs in the wrapper's struct format. x, r, i, dout, dx, dr and
// di are float32 (bf16 == 0) or bfloat16 (bf16 == 1); the rest float32.
struct RglruBwdArgs {
  const void* x;         // (B, S, W)
  const void* r;         // (B, S, W)
  const void* i;         // (B, S, W)
  const float* a_param;  // (W,)
  const float* h0;       // (B, W), or null for a zero state
  const float* hs;       // (B, S, W): the forward's float32 h sequence
  const void* dout;      // (B, S, W)
  const float* dh_last;  // (B, W), or null for a zero cotangent
  void* dx;              // (B, S, W)
  void* dr;              // (B, S, W)
  void* di;              // (B, S, W)
  float* dh0;            // (B, W), or null (h0 null)
  float* dl_part;        // (B, W) scratch: each row's share of dL
  float* dl;             // (W,)
  int b, s, w;
  float c;
  int bf16, pad;
};
static_assert(sizeof(RglruBwdArgs) == 136,
              "RglruBwdArgs must match <14Q3if2i");

namespace {

constexpr int kThreads = 256;  // stage and form the terms; one more warp walks
constexpr int kTile = 32;   // channels a CTA walks: the walker's lanes
constexpr int kChunk = 32;  // steps staged at a time
constexpr int kElems = kChunk * kTile;

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

struct Params {
  RglruBwdArgs a;
  bool vec;  // rows move in 16-byte pieces
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // to nearest even, as torch's cast
}

// one element (or a 16-byte piece of them, vec) of a staged row
__device__ __forceinline__ void copy(float* dst, const float* src, bool vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}
__device__ __forceinline__ void copy(__nv_bfloat16* dst,
                                     const __nv_bfloat16* src, bool vec) {
  if (vec) {
    cp_async16(reinterpret_cast<float*>(dst),
               reinterpret_cast<const float*>(src));
  } else {
    *dst = *src;  // 2 bytes: below cp.async's smallest piece
  }
}

// rows t0 .. t0 + steps - 1 of channels w0 .. w0 + tw - 1 of a (B, S, W)
// array into a dense (steps, tw) tile, row `lag` steps earlier (lag 1:
// h_{t-1}; such a row before t = 0 is left to the caller)
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           const Params& p, int b, int w0,
                                           int tw, int t0, int steps,
                                           int lag) {
  const RglruBwdArgs& a = p.a;
  constexpr int kPiece = 16 / (int)sizeof(E);
  const int q = p.vec ? tw / kPiece : tw;  // pieces a row
  const int rows = kThreads / q;           // rows a pass
  if ((int)threadIdx.x >= rows * q) return;
  const int col = p.vec ? (threadIdx.x % q) * kPiece : threadIdx.x % q;
  for (int t = threadIdx.x / q; t < steps; t += rows) {
    if (t0 + t - lag < 0) continue;
    const size_t at = ((size_t)b * a.s + t0 + t - lag) * a.w + w0 + col;
    copy(dst + t * tw + col, src + at, p.vec);
  }
}

// steps t0 .. t0 + steps - 1 of channels w0 .. w0 + tw - 1 of x, r, i,
// dout and h_{t-1} (row t0 + t - 1 of hs; h0 or 0 for t0 + t = 0) into
// the dense (steps, tw) tiles
template <typename T>
__device__ __forceinline__ void stage(const Params& p, T* sx, T* sr, T* si,
                                      float* shp, T* sdo, int b, int w0,
                                      int tw, int t0, int steps) {
  const RglruBwdArgs& a = p.a;
  stage_rows(sx, static_cast<const T*>(a.x), p, b, w0, tw, t0, steps, 0);
  stage_rows(sr, static_cast<const T*>(a.r), p, b, w0, tw, t0, steps, 0);
  stage_rows(si, static_cast<const T*>(a.i), p, b, w0, tw, t0, steps, 0);
  stage_rows(sdo, static_cast<const T*>(a.dout), p, b, w0, tw, t0, steps, 0);
  stage_rows(shp, a.hs, p, b, w0, tw, t0, steps, 1);
  if (t0 == 0)
    for (int col = threadIdx.x; col < tw; col += kThreads)
      shp[col] = a.h0 != nullptr ? a.h0[(size_t)b * a.w + w0 + col] : 0.f;
}

// chunks of tiles in flight: the walked one's neighbours on both sides
// and the one being staged
constexpr int kBufs = 4;

// bytes of dynamic shared memory an instance takes
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)kBufs * kElems * (4 * sizeof(T) + sizeof(float))  // tiles
         + 6 * kElems * sizeof(float)                        // a_t, sigmoid(r)
         + (sizeof(T) == 4 ? 0 : 2 * kElems * sizeof(float))         // dh
         + kThreads * sizeof(float) + kTile * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads + 32)
rglru_bwd_kernel(const __grid_constant__ Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);         // (kBufs, kElems) each
  T* s_r = s_x + kBufs * kElems;
  T* s_i = s_r + kBufs * kElems;
  T* s_do = s_i + kBufs * kElems;              // dout (float32: then dh)
  float* s_hp = reinterpret_cast<float*>(s_do + kBufs * kElems);  // h_{t-1}
  float* s_a = s_hp + kBufs * kElems;          // (3, kElems): a_t
  float* s_sr = s_a + 3 * kElems;              // (3, kElems): sigmoid(r_t)
  float* s_dh = s_sr + 3 * kElems;             // (2, kElems) beside bf16 dout
  float* s_red = s_dh + (kF32 ? 0 : 2 * kElems);
  float* s_nsp = s_red + kThreads;             // -c * softplus(L)
  const RglruBwdArgs& a = p.a;
  const int tiles = (a.w + kTile - 1) / kTile;
  const int b = blockIdx.x / tiles;
  const int w0 = (blockIdx.x - b * tiles) * kTile;
  const int tw = min(kTile, a.w - w0);
  const int tid = threadIdx.x;
  const bool walker = tid >= kThreads;  // the last warp walks dh
  const int nc = (a.s + kChunk - 1) / kChunk;
  // the terms: thread tid < kThreads forms channel tid % tw of every
  // rows-th step (rows >= 8, so at most kChunk / 8 steps of a chunk)
  const int rows = kThreads / tw;
  const int w_term = tid % tw;
  const bool termer = tid < rows * tw;
  // the j-th chunk worked is chunk nc - 1 - j: S is walked from the end
  auto t0_of = [&](int j) { return (nc - 1 - j) * kChunk; };
  auto steps_of = [&](int j) { return min(kChunk, a.s - t0_of(j)); };
  auto stage_chunk = [&](int j) {
    if (j >= nc) return;
    const int nb = (j % kBufs) * kElems;
    stage(p, s_x + nb, s_r + nb, s_i + nb, s_hp + nb, s_do + nb, b, w0, tw,
          t0_of(j), steps_of(j));
  };
  // a_t and sigmoid(r_t) of chunk j, 256 wide: a thread's (at most
  // kChunk / 8) steps unrolled, so their chains overlap
  auto a_phase = [&](int j) {
    if (!termer) return;
    const T* tr = s_r + (j % kBufs) * kElems;
    float* ta = s_a + (j % 3) * kElems;
    float* tsr = s_sr + (j % 3) * kElems;
    const float nsp = s_nsp[w_term];
    const int steps = steps_of(j);
#pragma unroll
    for (int k = 0; k < kChunk / 8; ++k) {
      const int t = tid / tw + k * rows;
      if (t < steps) {
        const int e = t * tw + w_term;
        const float sr = sigmoid(widen(tr[e]));
        tsr[e] = sr;
        ta[e] = expf(nsp * sr);
      }
    }
  };
  float dl = 0.f;  // this thread's share of dL / sigmoid(L)
  // dx, dr and di of chunk j (walked the step before), 256 wide, its steps
  // in order for dL
  auto terms = [&](int j) {
    if (!termer) return;
    const int nb = (j % kBufs) * kElems;
    const T* tx = s_x + nb;
    const T* ti = s_i + nb;
    const float* thp = s_hp + nb;
    const float* tdh = kF32 ? reinterpret_cast<const float*>(s_do + nb)
                            : s_dh + (j % 2) * kElems;
    const float* ta = s_a + (j % 3) * kElems;
    const float* tsr = s_sr + (j % 3) * kElems;
    const float nsp = s_nsp[w_term];
    const int t0 = t0_of(j);
    const int steps = steps_of(j);
    const size_t row0 = ((size_t)b * a.s + t0) * a.w + w0 + w_term;
#pragma unroll
    for (int k = 0; k < kChunk / 8; ++k) {
      const int t = tid / tw + k * rows;
      if (t >= steps) continue;
      const int e = t * tw + w_term;
      const float x = widen(tx[e]);
      const float sr = tsr[e];
      const float si = sigmoid(widen(ti[e]));
      const float at = ta[e];
      const float dh = tdh[e];
      const float g = si * x;
      const float one_m = 1.f - at * at;
      const float m = sqrtf(fmaxf(one_m, 1e-12f));
      const float dg = dh * m;
      const float da = dh * thp[e] - (one_m > 1e-12f ? dh * g * at / m : 0.f);
      const float dlog = da * at;
      const size_t o = row0 + (size_t)t * a.w;
      put(static_cast<T*>(a.dx) + o, dg * si);
      put(static_cast<T*>(a.di) + o, dg * x * (si * (1.f - si)));
      put(static_cast<T*>(a.dr) + o, dlog * nsp * (sr * (1.f - sr)));
      dl += dlog * (-a.c * sr);
    }
  };
  const int lane = tid - kThreads;
  float carry = 0.f;  // a_{t+1} dh_{t+1}, the walker's lane's channel
  if (walker && lane < tw && a.dh_last != nullptr)
    carry = a.dh_last[(size_t)b * a.w + w0 + lane];
  // dh of chunk j, one lane a channel, from the end
  auto walk = [&](int j) {
    if (lane >= tw) return;
    const int nb = (j % kBufs) * kElems;
    const T* tdo = s_do + nb;
    float* tdh = kF32 ? reinterpret_cast<float*>(s_do + nb)
                      : s_dh + (j % 2) * kElems;
    const float* ta = s_a + (j % 3) * kElems;
#pragma unroll 8
    for (int t = steps_of(j) - 1; t >= 0; --t) {
      const int e = t * tw + lane;
      const float cur = widen(tdo[e]) + carry;
      tdh[e] = cur;
      carry = ta[e] * cur;
    }
  };

  if (!walker) {
    if (tid < tw) s_nsp[tid] = -a.c * softplus(a.a_param[w0 + tid]);
    stage_chunk(0);
    cp_async_wait_all();
  }
  __syncthreads();
  if (!walker) {
    stage_chunk(1);
    cp_async_commit();
    if (nc > 0) a_phase(0);
  }
  // step j: the walker walks chunk j while the others form chunk j - 1's
  // terms and chunk j + 1's a_t, and chunk j + 2 is staged
  for (int j = 0; j <= nc; ++j) {
    if (!walker) cp_async_wait_all();  // chunk j + 1
    __syncthreads();
    if (walker) {
      if (j < nc) walk(j);
    } else {
      stage_chunk(j + 2);
      cp_async_commit();
      if (j >= 1) terms(j - 1);
      if (j + 1 < nc) a_phase(j + 1);
    }
  }

  if (walker && lane < tw && a.dh0 != nullptr)
    a.dh0[(size_t)b * a.w + w0 + lane] = carry;
  if (!walker) s_red[tid] = termer ? dl : 0.f;
  __syncthreads();
  if (tid < tw) {
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += s_red[k * tw + tid];
    a.dl_part[(size_t)b * a.w + w0 + tid] = sum;
  }
}

// dL[w] = sigmoid(L[w]) * sum over b = 0 .. B - 1, in order, of the rows'
// shares
__global__ void __launch_bounds__(256)
rglru_bwd_dl_kernel(const __grid_constant__ Params p) {
  const RglruBwdArgs& a = p.a;
  const int w = blockIdx.x * 256 + threadIdx.x;
  if (w >= a.w) return;
  float sum = 0.f;
  for (int b = 0; b < a.b; ++b) sum += a.dl_part[(size_t)b * a.w + w];
  a.dl[w] = sum * sigmoid(a.a_param[w]);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// contiguous on the card, x, r, i, dout, dx, dr and di all float32 or all
// bfloat16 (bf16), the rest float32; h0, dh_last (and dh0 with h0) may be
// null. Returns cudaGetLastError() after the two launches; the caller
// raises if it is not cudaSuccess.
extern "C" int rglru_bwd(const RglruBwdArgs* a, void* stream) {
  if (a->b <= 0 || a->s < 0 || a->w <= 0 ||
      (a->h0 == nullptr) != (a->dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{*a, false};
  p.vec = a->w % (a->bf16 ? 8 : 4) == 0 && aligned16(a->x) &&
          aligned16(a->r) && aligned16(a->i) && aligned16(a->hs) &&
          aligned16(a->dout);
  const long long blocks = (long long)a->b * ((a->w + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->bf16) {
    constexpr size_t kSmem = smem_bytes<__nv_bfloat16>();
    static const int attr = allow_smem(rglru_bwd_kernel<__nv_bfloat16>, kSmem);
    if (attr != 0) return attr;
    rglru_bwd_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, kThreads + 32, kSmem, s>>>(p);
  } else {
    constexpr size_t kSmem = smem_bytes<float>();
    static const int attr = allow_smem(rglru_bwd_kernel<float>, kSmem);
    if (attr != 0) return attr;
    rglru_bwd_kernel<float><<<(unsigned)blocks, kThreads + 32, kSmem, s>>>(p);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  rglru_bwd_dl_kernel<<<(a->w + 255) / 256, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
