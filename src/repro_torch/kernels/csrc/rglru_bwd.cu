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
// and di, 32 B of float32 after a few dozen flops, so the floor is 8
// arrays of B S W floats over the memory rate once B * W channels fill
// the card.
//
// Design: the forward's (csrc/rglru.cu). A CTA per (row b, tile of up to
// 32 channels), 256 threads, walking S in chunks of 32 steps from the
// end. Per chunk:
//   1. the threads copy the chunk's x, r, i, h_{t-1} and dout rows into
//      shared memory with cp.async (16-byte pieces where W is a multiple
//      of 4 and the arrays are 16-byte aligned, 4 otherwise),
//      double-buffered: chunk c - 1 is in flight while chunk c is worked;
//      h_{-1} is h0 (or 0), stored by the threads themselves;
//   2. every thread forms a_t of one channel at every (256 / tile)-th
//      step, 256 wide;
//   3. one lane per channel (warp 0) walks dh backwards from shared
//      memory, writing dh_t over dout_t and carrying a_t dh_t in a
//      register across chunks;
//   4. every thread forms dx, dr and di of its steps, 256 wide, stores
//      them (neighbouring lanes to neighbouring addresses) and adds its
//      steps' da_t a_t (-c sr) to a register of its own.
// No floating-point atomics: at the end the threads of a channel add
// their partial sums of dL in a fixed order into a (B, W) buffer, and a
// second kernel adds the rows b = 0 .. B - 1 in order and multiplies by
// sigmoid(L). The same inputs give the same bits. The library is built
// with --fmad=false, as the forward's: every term takes the plain
// version's operations in its order (the plain version sums dL in
// another order).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

// RglruBwdArgs in the wrapper's struct format.
struct RglruBwdArgs {
  const float* x;        // (B, S, W)
  const float* r;        // (B, S, W)
  const float* i;        // (B, S, W)
  const float* a_param;  // (W,)
  const float* h0;       // (B, W), or null for a zero state
  const float* hs;       // (B, S, W): the forward's float32 h sequence
  const float* dout;     // (B, S, W)
  const float* dh_last;  // (B, W), or null for a zero cotangent
  float* dx;             // (B, S, W)
  float* dr;             // (B, S, W)
  float* di;             // (B, S, W)
  float* dh0;            // (B, W), or null (h0 null)
  float* dl_part;        // (B, W) scratch: each row's share of dL
  float* dl;             // (W,)
  int b, s, w;
  float c;
};
static_assert(sizeof(RglruBwdArgs) == 128, "RglruBwdArgs must match <14Q3if");

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // channels a CTA walks: warp 0's lanes
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

__device__ __forceinline__ void copy(float* dst, const float* src, bool vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

// steps t0 .. t0 + steps - 1 of channels w0 .. w0 + tw - 1 of x, r, i,
// dout and h_{t-1} (row t0 + t - 1 of hs; h0 or 0 for t0 + t = 0) into
// the dense (steps, tw) tiles
__device__ __forceinline__ void stage(const Params& p, float* sx, float* sr,
                                      float* si, float* shp, float* sdo,
                                      int b, int w0, int tw, int t0,
                                      int steps) {
  const RglruBwdArgs& a = p.a;
  const int q = p.vec ? tw >> 2 : tw;  // pieces a row
  const int rows = kThreads / q;       // rows a pass
  if ((int)threadIdx.x >= rows * q) return;
  const int col = p.vec ? (threadIdx.x % q) << 2 : threadIdx.x % q;
  for (int t = threadIdx.x / q; t < steps; t += rows) {
    const size_t src = ((size_t)b * a.s + t0 + t) * a.w + w0 + col;
    const int dst = t * tw + col;
    copy(sx + dst, a.x + src, p.vec);
    copy(sr + dst, a.r + src, p.vec);
    copy(si + dst, a.i + src, p.vec);
    copy(sdo + dst, a.dout + src, p.vec);
    if (t0 + t > 0) {
      copy(shp + dst, a.hs + src - a.w, p.vec);
    } else {
      const int n = p.vec ? 4 : 1;
      for (int k = 0; k < n; ++k)
        shp[dst + k] = a.h0 != nullptr
                           ? a.h0[(size_t)b * a.w + w0 + col + k]
                           : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(16) float s_x[2][kElems];
  __shared__ __align__(16) float s_r[2][kElems];
  __shared__ __align__(16) float s_i[2][kElems];
  __shared__ __align__(16) float s_hp[2][kElems];  // h_{t-1}
  __shared__ __align__(16) float s_do[2][kElems];  // dout, then dh
  __shared__ float s_a[kElems];                    // a_t
  __shared__ float s_red[kThreads];
  __shared__ float s_nsp[kTile];                   // -c * softplus(L)
  const RglruBwdArgs& a = p.a;
  const int tiles = (a.w + kTile - 1) / kTile;
  const int b = blockIdx.x / tiles;
  const int w0 = (blockIdx.x - b * tiles) * kTile;
  const int tw = min(kTile, a.w - w0);
  const int tid = threadIdx.x;
  const int chunks = (a.s + kChunk - 1) / kChunk;
  // the terms: thread tid forms channel tid % tw of every rows-th step
  const int rows = kThreads / tw;
  const int w_term = tid % tw;
  const bool termer = tid < rows * tw;

  if (chunks > 0) {
    const int t0 = (chunks - 1) * kChunk;
    const int nb = (chunks - 1) & 1;
    stage(p, s_x[nb], s_r[nb], s_i[nb], s_hp[nb], s_do[nb], b, w0, tw, t0,
          a.s - t0);
    cp_async_commit();
  }
  if (tid < tw) s_nsp[tid] = -a.c * softplus(a.a_param[w0 + tid]);
  float carry = 0.f;  // a_{t+1} dh_{t+1}, lane tid's channel
  if (tid < tw && a.dh_last != nullptr)
    carry = a.dh_last[(size_t)b * a.w + w0 + tid];
  float dl = 0.f;     // this thread's share of dL / sigmoid(L)

  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, a.s - t0);
    if (c > 0) {
      const int nb = (c - 1) & 1;
      stage(p, s_x[nb], s_r[nb], s_i[nb], s_hp[nb], s_do[nb], b, w0, tw,
            t0 - kChunk, kChunk);
    }
    cp_async_commit();  // possibly empty: chunk c is then all but the newest
    cp_async_wait_1();
    __syncthreads();

    const int cb = c & 1;
    const float* tx = s_x[cb];
    const float* tr = s_r[cb];
    const float* ti = s_i[cb];
    const float* thp = s_hp[cb];
    float* tdh = s_do[cb];
    const float nsp = s_nsp[w_term];
    if (termer) {
      for (int t = tid / tw; t < steps; t += rows) {
        const int e = t * tw + w_term;
        s_a[e] = expf(nsp * sigmoid(tr[e]));
      }
    }
    __syncthreads();

    if (tid < tw) {
#pragma unroll 8
      for (int t = steps - 1; t >= 0; --t) {
        const int e = t * tw + tid;
        const float cur = tdh[e] + carry;
        tdh[e] = cur;
        carry = s_a[e] * cur;
      }
    }
    __syncthreads();

    if (termer) {
      const size_t row0 = ((size_t)b * a.s + t0) * a.w + w0 + w_term;
      for (int t = tid / tw; t < steps; t += rows) {
        const int e = t * tw + w_term;
        const float x = tx[e];
        const float sr = sigmoid(tr[e]);
        const float si = sigmoid(ti[e]);
        const float at = s_a[e];
        const float dh = tdh[e];
        const float g = si * x;
        const float one_m = 1.f - at * at;
        const float m = sqrtf(fmaxf(one_m, 1e-12f));
        const float dg = dh * m;
        const float da =
            dh * thp[e] - (one_m > 1e-12f ? dh * g * at / m : 0.f);
        const float dlog = da * at;
        const size_t o = row0 + (size_t)t * a.w;
        a.dx[o] = dg * si;
        a.di[o] = dg * x * (si * (1.f - si));
        a.dr[o] = dlog * nsp * (sr * (1.f - sr));
        dl += dlog * (-a.c * sr);
      }
    }
    __syncthreads();  // this buffer takes chunk c - 2 next
  }
  cp_async_wait_all();  // nothing in flight at exit

  if (tid < tw && a.dh0 != nullptr) a.dh0[(size_t)b * a.w + w0 + tid] = carry;
  s_red[tid] = termer ? dl : 0.f;
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

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// all float32, contiguous on the card; h0, dh_last (and dh0 with h0) may
// be null. Returns cudaGetLastError() after the two launches; the caller
// raises if it is not cudaSuccess.
extern "C" int rglru_bwd(const RglruBwdArgs* a, void* stream) {
  if (a->b <= 0 || a->s < 0 || a->w <= 0 ||
      (a->h0 == nullptr) != (a->dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{*a, false};
  p.vec = a->w % 4 == 0 && aligned16(a->x) && aligned16(a->r) &&
          aligned16(a->i) && aligned16(a->hs) && aligned16(a->dout);
  const long long blocks = (long long)a->b * ((a->w + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rglru_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(p);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  rglru_bwd_dl_kernel<<<(a->w + 255) / 256, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
