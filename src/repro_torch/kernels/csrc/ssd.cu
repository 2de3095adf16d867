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
// Bound: at the predicate's shapes, latency. A (b, h) pair moves
// S * (P + 2N + 1) + 2 P N floats and does ~6 S P N flops, so in bytes and
// in operations it is tiny; with P = N = 4 (below any mma tile) and one
// chunk of 64, the time is the chain of dependent steps inside one block.
// At many rows it tends to bytes: 2 B H blocks stream x, dt, B and C once.
//
// Design. One block per (b, h) walks the chunks in order, keeping the
// state in shared memory (blocks run in no order, so the TPU kernel's
// sequential grid axis becomes this loop). Per chunk: the chunk's x, dt,
// B and C are staged in shared memory; each of the first L threads forms
// its prefix sum of dt * A in index order; the lower triangle of the
// (L x L) weights (C_l . B_m) exp(cum_l - cum_m) dt_m is formed once --
// never exp() above the diagonal, where it could overflow and give
// inf * 0 = NaN; then each (l, p) output and each (p, n) state entry is
// an FMA-free loop in index order (the build passes --fmad=false). Padding
// tokens have dt = 0: their columns weigh nothing and the state passes
// through them unchanged. Nothing depends on the batch, so a row's output
// is the same alone or among thousands.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ h_last,
           int nh, int s, int p, int ng, int n, int chunk) {
  extern __shared__ float smem[];
  const int L = chunk;
  float* s_x = smem;              // (L, P)
  float* s_b = s_x + L * p;       // (L, N)
  float* s_c = s_b + L * n;       // (L, N)
  float* s_dt = s_c + L * n;      // (L,)
  float* s_cum = s_dt + L;        // (L,)
  float* s_att = s_cum + L;       // (L, L), lower triangle
  float* s_h = s_att + L * L;     // (P, N)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / nh;
  const int hi = bh - bi * nh;
  const int gi = hi / (nh / ng);
  const float a = A[hi];
  const float* xb = x + (size_t)bh * s * p;
  const float* dtb = dt + (size_t)bh * s;
  const float* bb = Bm + ((size_t)bi * ng + gi) * s * n;
  const float* cb = Cm + ((size_t)bi * ng + gi) * s * n;
  float* yb = y + (size_t)bh * s * p;

  for (int i = tid; i < p * n; i += kThreads) s_h[i] = h0[(size_t)bh * p * n + i];

  for (int base = 0; base < s; base += L) {
    __syncthreads();  // the previous chunk is consumed; s_h is visible
    for (int i = tid; i < L * p; i += kThreads) s_x[i] = xb[(size_t)base * p + i];
    for (int i = tid; i < L * n; i += kThreads) {
      s_b[i] = bb[(size_t)base * n + i];
      s_c[i] = cb[(size_t)base * n + i];
    }
    for (int i = tid; i < L; i += kThreads) s_dt[i] = dtb[base + i];
    __syncthreads();
    for (int l = tid; l < L; l += kThreads) {
      float cum = 0.f;
      for (int m = 0; m <= l; ++m) cum += s_dt[m] * a;
      s_cum[l] = cum;
    }
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int l = i / L;
      const int m = i - l * L;
      if (m > l) continue;  // above the diagonal: never read, never exp()
      float sc = 0.f;
      for (int j = 0; j < n; ++j) sc += s_c[l * n + j] * s_b[m * n + j];
      s_att[i] = sc * expf(s_cum[l] - s_cum[m]) * s_dt[m];
    }
    __syncthreads();
    for (int i = tid; i < L * p; i += kThreads) {
      const int l = i / p;
      const int q = i - l * p;
      float acc = 0.f;
      for (int m = 0; m <= l; ++m) acc += s_att[l * L + m] * s_x[m * p + q];
      float ch = 0.f;
      for (int j = 0; j < n; ++j) ch += s_c[l * n + j] * s_h[q * n + j];
      yb[(size_t)(base + l) * p + q] = acc + expf(s_cum[l]) * ch;
    }
    __syncthreads();  // every read of the entering state is done
    const float last = s_cum[L - 1];
    for (int i = tid; i < p * n; i += kThreads) {
      const int q = i / n;
      const int j = i - q * n;
      float hb = 0.f;
      for (int l = 0; l < L; ++l)
        hb += s_x[l * p + q] * (s_dt[l] * expf(last - s_cum[l])) * s_b[l * n + j];
      s_h[i] = expf(last) * s_h[i] + hb;
    }
  }
  __syncthreads();
  for (int i = tid; i < p * n; i += kThreads) h_last[(size_t)bh * p * n + i] = s_h[i];
}

}  // namespace

// x, y: (B, H, S, P); dt: (B, H, S); A: (H,); Bm, Cm: (B, G, S, N);
// h0, h_last: (B, H, P, N); all float32, contiguous on the card.
// G divides H, 1 <= chunk <= 64 and chunk divides S. Returns
// cudaGetLastError() after the launch; the caller raises if it is not
// cudaSuccess.
extern "C" int ssd_bhcp(const float* x, const float* dt, const float* A,
                        const float* Bm, const float* Cm, const float* h0,
                        float* y, float* h_last, int b, int nh, int s, int p,
                        int ng, int n, int chunk, void* stream) {
  if (b <= 0 || nh <= 0 || s <= 0 || p <= 0 || ng <= 0 || n <= 0 ||
      nh % ng != 0 || chunk <= 0 || chunk > kMaxChunk || s % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)chunk * p + 2 * (size_t)chunk * n +
                        2 * (size_t)chunk + (size_t)chunk * chunk +
                        (size_t)p * n;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_kernel<<<b * nh, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, Bm, Cm, h0, y, h_last, nh, s, p, ng, n, chunk);
  return (int)cudaGetLastError();
}
