// Fused MoE top-k gating for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py::moe_router_tk
// (_router_kernel). Per row of logits: softmax over the E experts with the
// maximum subtracted (as jax.nn.softmax computes it), then k rounds of
// argmax -- a strict '>' so the lowest index wins a tie -- each writing
// -1e30 over its winner, then the k chosen weights divided by their sum.
//
// Bound: bytes, and in practice the launch. A row reads E float32 values
// and writes 2k values after a few dozen flops, far below the card's ratio
// of operations to bytes; at the predicate's batches (T <= 32 rows) the
// whole launch is a few hundred bytes and its latency is the time.
//
// Design. One thread per row, E small (at most kMaxExperts): the row's
// probabilities live in a register array, the k rounds are plain loops,
// and nothing is shared between threads, so there is no barrier and a
// row's result does not depend on the batch it sits in. Reads of a row are
// strided across the warp; at E = 8 (32 B per row) a warp's loads still
// fall in few cache lines. Sums run in index order; the build passes
// --fmad=false, so no multiply-add is contracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxExperts = 64;
constexpr float kMasked = -1e30f;

__global__ void __launch_bounds__(kThreads)
moe_router_kernel(const float* __restrict__ logits, float* __restrict__ w,
                  int32_t* __restrict__ idx, int t, int e, int k) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= t) return;
  const float* x = logits + (size_t)row * e;

  float p[kMaxExperts];
  float mx = -INFINITY;
  for (int j = 0; j < e; ++j) mx = fmaxf(mx, x[j]);
  float sum = 0.f;
  for (int j = 0; j < e; ++j) {
    p[j] = expf(x[j] - mx);
    sum += p[j];
  }
  for (int j = 0; j < e; ++j) p[j] = p[j] / sum;

  float* wr = w + (size_t)row * k;
  int32_t* ir = idx + (size_t)row * k;
  float wsum = 0.f;
  for (int r = 0; r < k; ++r) {
    int best = 0;
    float bv = p[0];
    for (int j = 1; j < e; ++j) {
      if (p[j] > bv) {  // strict: the lowest index keeps a tie
        bv = p[j];
        best = j;
      }
    }
    p[best] = kMasked;
    wr[r] = bv;
    ir[r] = best;
    wsum += bv;
  }
  for (int r = 0; r < k; ++r) wr[r] = wr[r] / wsum;
}

}  // namespace

// RouterArgs in the wrapper's struct format.
struct RouterArgs {
  const float* logits;  // (T, E)
  float* w;             // (T, k)
  int32_t* idx;         // (T, k)
  int t, e, k, pad;
};
static_assert(sizeof(RouterArgs) == 40, "RouterArgs must match <3Q4i");

// logits: (T, E) float32, w: (T, k) float32, idx: (T, k) int32, all
// contiguous on the card; 1 <= k <= E <= 64. Returns cudaGetLastError()
// after the launch; the caller raises if it is not cudaSuccess.
extern "C" int moe_router_tk(const RouterArgs* a, void* stream) {
  if (a->t <= 0 || a->e <= 0 || a->e > kMaxExperts || a->k <= 0 || a->k > a->e)
    return (int)cudaErrorInvalidValue;
  const int blocks = (a->t + kThreads - 1) / kThreads;
  moe_router_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a->logits, a->w, a->idx, a->t, a->e, a->k);
  return (int)cudaGetLastError();
}
