// Fused MoE top-k gating for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py::moe_router_tk
// (_router_kernel). Per row of logits: softmax over the E experts with the
// maximum subtracted (as jax.nn.softmax computes it), then k rounds of
// argmax -- a strict '>' so the lowest index wins a tie -- each writing
// -1e30 over its winner, then the k chosen weights divided by their sum.
// Two entry points share that body (route):
//   * moe_router_tk takes (T, E) logits;
//   * moe_router_tokens takes a (B, S) array of token ids and forms each
//     row's logits itself, as the predicate's featurizer does
//     (kernels/ref.py::router_logits): the (S, D) embedding rows of its
//     tokens summed over S in fixed_sum's halving order, divided by the
//     live (non-zero) token count, at least 1, times the (D, E) gate, and
//     summed over D in the same halving order. The predicate then makes one
//     launch a call and runs no torch operation before it.
//
// Bound: bytes, and in practice the launch. A row reads E float32 logits
// (or S token ids and S embedding rows of D floats, from a table that
// stays in L2) and writes 2k values after a few hundred flops, far below
// the card's ratio of operations to bytes; at the predicate's batches
// (B <= 32 rows) the launch and two dependent load round trips (ids, then
// rows) are the time.
//
// Design.
//   * moe_router_tk, E <= kMaxExperts (64): one thread per row. The row's
//     probabilities live in a thread-local array, the k rounds are plain
//     loops, and nothing is shared between threads.
//   * moe_router_tk, kMaxExperts < E <= kMaxExpertsWarp (128; arctic's
//     128 experts): one warp per row, four rows to a CTA, since a
//     thread-local array of 128 floats would spill. Lane l holds experts
//     l, l + 32, l + 64 and l + 96 (absent ones at -inf). The maximum and
//     the sum are xor-butterfly shuffles, so every lane holds the same
//     bits; the division is IEEE. Each of the k rounds takes a lane's
//     best (value, index) in index order with a strict '>', then a
//     butterfly that keeps the larger value and, on equal values, the
//     lower index: the lowest index wins a tie, as in the one-thread body.
//     The winner's lane writes -1e30 over it. The sum runs in another
//     order than the one-thread body's, so the weights may differ from it
//     (and from the plain version) by an ulp; the indices do not.
//   * moe_router_tokens: one warp per row, four rows to a CTA (fewer when a
//     row's tiles outgrow shared memory), so B = 4096 rows make 1,024 CTAs.
//     The lanes load the row's ids and count the live ones (an integer
//     warp sum, exact in any order), then gather the (S, D) rows into
//     shared memory with cp.async (16 bytes a copy where D is a multiple of
//     4 and the table is 16-byte aligned). Each halving level of fixed_sum
//     -- v[j] += v[j + half] for j < half, then an odd remainder moved to
//     slot half -- is spread over the lanes with __syncwarp between
//     levels, over S and then, after the division and the gate product,
//     over D. Lane 0 runs route on the E logits.
//   * moe_router_bwd, the weights' gradient (no TPU kernel: the reference
//     differentiates its plain router through XLA): the renormalised
//     weights are a softmax over the k chosen logits, so
//     dlogit[t, idx[t, m]] = w[t, m] * (dw[t, m] - s[t]) with s[t] =
//     sum_j w[t, j] * dw[t, j] in j order, and 0 at the other experts. One
//     thread per element of the (T, E) output, so the writes coalesce; a
//     thread finds its expert among the row's k indices (distinct, k <=
//     E) and forms s itself from the row's 3k values (L1 serves the
//     row's other threads). No atomics and no shared state: the same bits
//     on every run, and equal to kernels/ref.py::moe_router_bwd (same
//     products and order, no contraction). Bound: bytes, T * E * 4
//     written and T * k * 12 read.
// Every sum runs in an order fixed by the shapes, never by the batch, so a
// row's result does not depend on its batch. The build passes
// --fmad=false, so no multiply-add is contracted, and nvcc's division is
// IEEE: the logits equal the featurizer's bit for bit. A token id outside
// [0, V) is taken as the JAX package's gather takes it (a negative id
// counts from the end, then the id is clamped into the table), so no load
// leaves the table; the predicate refuses such ids on the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

// RouterArgs in the wrapper's struct format.
struct RouterArgs {
  const float* logits;  // (T, E)
  float* w;             // (T, k)
  int32_t* idx;         // (T, k)
  int t, e, k, pad;
};
static_assert(sizeof(RouterArgs) == 40, "RouterArgs must match <3Q4i");

// RouterTokensArgs in the wrapper's struct format.
struct RouterTokensArgs {
  const int32_t* toks;   // (B, S) token ids
  const float* emb;      // (V, D)
  const float* w_gate;   // (D, E)
  float* logits;         // (B, E), or null
  float* w;              // (B, k)
  int32_t* idx;          // (B, k)
  int b, s, d, e, k, v;
};
static_assert(sizeof(RouterTokensArgs) == 72, "RouterTokensArgs must match <6Q6i");

// RouterBwdArgs in the wrapper's struct format.
struct RouterBwdArgs {
  const float* w;      // (T, k) the forward's weights
  const int32_t* idx;  // (T, k) their experts
  const float* dw;     // (T, k) the weights' cotangent
  float* dlogits;      // (T, E)
  int t, e, k, pad;
};
static_assert(sizeof(RouterBwdArgs) == 48, "RouterBwdArgs must match <4Q4i");

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = 4;  // rows a CTA of the token entry, at most
constexpr int kMaxExperts = 64;       // one thread a row
constexpr int kMaxExpertsWarp = 128;  // one warp a row
constexpr int kPerLane = kMaxExpertsWarp / 32;
constexpr int kSmemLimit = 227 * 1024;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// one row: softmax of x[0 .. e), k rounds of argmax and mask, the k
// weights renormalised into wr and their experts into ir. Sums run in
// index order.
__device__ __forceinline__ void route(const float* x, int e, int k,
                                      float* __restrict__ wr,
                                      int32_t* __restrict__ ir) {
  float p[kMaxExperts];
  float mx = -INFINITY;
  for (int j = 0; j < e; ++j) mx = fmaxf(mx, x[j]);
  float sum = 0.f;
  for (int j = 0; j < e; ++j) {
    p[j] = expf(x[j] - mx);
    sum += p[j];
  }
  for (int j = 0; j < e; ++j) p[j] = p[j] / sum;

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

__global__ void __launch_bounds__(kThreads)
moe_router_kernel(const float* __restrict__ logits, float* __restrict__ w,
                  int32_t* __restrict__ idx, int t, int e, int k) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= t) return;
  route(logits + (size_t)row * e, e, k, w + (size_t)row * k,
        idx + (size_t)row * k);
}

// (value, index) of the larger value across the warp, the lower index on
// equal values; every lane ends with the same pair
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
moe_router_warp_kernel(const float* __restrict__ logits, float* __restrict__ w,
                       int32_t* __restrict__ idx, int t, int e, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= t) return;  // the whole warp
  const float* x = logits + (size_t)row * e;
  float p[kPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + 32 * j;
    p[j] = c < e ? x[c] : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    p[j] = lane + 32 * j < e ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    p[j] = lane + 32 * j < e ? p[j] / sum : -INFINITY;

  float* wr = w + (size_t)row * k;
  int32_t* ir = idx + (size_t)row * k;
  float wsum = 0.f;
  for (int r = 0; r < k; ++r) {
    float bv = p[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < kPerLane; ++j) {
      if (p[j] > bv) {  // strict: the lane's lowest index keeps a tie
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
    warp_argmax(bv, bi);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane + 32 * j == bi) p[j] = kMasked;
    if (lane == 0) {
      wr[r] = bv;
      ir[r] = bi;
    }
    wsum += bv;
  }
  if (lane == 0)
    for (int r = 0; r < k; ++r) wr[r] = wr[r] / wsum;
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// words of one row's shared tiles: the (S, D) rows, the (D, E) products
// and the S ids; 16-byte aligned pieces
__host__ __device__ __forceinline__ int row_words(int s, int d, int e) {
  return round4(s * d) + round4(d * e) + round4(s);
}

// fixed_sum over the n rows of a dense (n, width) tile, in its halving
// order: each level adds row j + half into row j for j < half, and an odd
// n moves its last row to slot half. The warp's lanes share each level;
// the sum ends in row 0.
__device__ __forceinline__ void halve_rows(float* v, int n, int width, int lane) {
  while (n > 1) {
    const int half = n >> 1;
    for (int g = lane; g < half * width; g += 32) v[g] = v[g] + v[g + half * width];
    __syncwarp();
    if (n & 1) {
      for (int c = lane; c < width; c += 32) v[half * width + c] = v[2 * half * width + c];
      __syncwarp();
    }
    n = half + (n & 1);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
moe_router_tokens_kernel(const RouterTokensArgs a, int rows_per_cta, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * rows_per_cta + warp;
  if (row >= a.b) return;  // the whole warp: only __syncwarp follows
  const int S = a.s, D = a.d, E = a.e;
  float* v = smem + (size_t)warp * row_words(S, D, E);  // (S, D) rows
  float* prod = v + round4(S * D);                      // (D, E)
  int* ids = reinterpret_cast<int*>(prod + round4(D * E));

  const int32_t* tr = a.toks + (size_t)row * S;
  int live = 0;
  for (int j = lane; j < S; j += 32) {
    int id = tr[j];
    live += id > 0;
    if (id < 0) id += a.v;
    ids[j] = min(max(id, 0), a.v - 1);
  }
  live = __reduce_add_sync(kFull, live);
  __syncwarp();
  if (vec) {
    const int q = D >> 2;
    for (int g = lane; g < S * q; g += 32) {
      const int j = g / q;
      const int c = (g - j * q) << 2;
      cp_async16(v + j * D + c, a.emb + (size_t)ids[j] * D + c);
    }
  } else {
    for (int g = lane; g < S * D; g += 32) {
      const int j = g / D;
      cp_async4(v + g, a.emb + (size_t)ids[j] * D + (g - j * D));
    }
  }
  cp_async_wait_all();
  __syncwarp();

  halve_rows(v, S, D, lane);  // v[0 .. D): the sum over S
  const float count = (float)max(live, 1);
  for (int g = lane; g < D * E; g += 32) prod[g] = v[g / E] / count * a.w_gate[g];
  __syncwarp();
  halve_rows(prod, D, E, lane);  // prod[0 .. E): the logits

  if (lane == 0) {
    if (a.logits != nullptr)
      for (int j = 0; j < E; ++j) a.logits[(size_t)row * E + j] = prod[j];
    route(prod, E, a.k, a.w + (size_t)row * a.k, a.idx + (size_t)row * a.k);
  }
}

__global__ void __launch_bounds__(kThreads)
moe_router_bwd_kernel(const RouterBwdArgs a) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)a.t * a.e) return;
  const int row = (int)(g / a.e);
  const int col = (int)(g - (long long)row * a.e);
  const float* wr = a.w + (size_t)row * a.k;
  const float* dr = a.dw + (size_t)row * a.k;
  const int32_t* ir = a.idx + (size_t)row * a.k;
  int m = -1;
  for (int j = 0; j < a.k; ++j)
    if (ir[j] == col) m = j;
  float out = 0.f;
  if (m >= 0) {
    float s = 0.f;
    for (int j = 0; j < a.k; ++j) s = s + wr[j] * dr[j];
    out = wr[m] * (dr[m] - s);
  }
  a.dlogits[g] = out;
}

}  // namespace

// logits: (T, E) float32, w: (T, k) float32, idx: (T, k) int32, all
// contiguous on the card; 1 <= k <= E <= 128 (a thread a row up to 64, a
// warp a row above). Returns cudaGetLastError() after the launch; the
// caller raises if it is not cudaSuccess.
extern "C" int moe_router_tk(const RouterArgs* a, void* stream) {
  if (a->t <= 0 || a->e <= 0 || a->e > kMaxExpertsWarp || a->k <= 0 || a->k > a->e)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->e <= kMaxExperts) {
    const int blocks = (a->t + kThreads - 1) / kThreads;
    moe_router_kernel<<<blocks, kThreads, 0, s>>>(a->logits, a->w, a->idx, a->t,
                                                  a->e, a->k);
  } else {
    const int rows = kThreads / 32;
    const int blocks = (a->t + rows - 1) / rows;
    moe_router_warp_kernel<<<blocks, kThreads, 0, s>>>(a->logits, a->w, a->idx,
                                                       a->t, a->e, a->k);
  }
  return (int)cudaGetLastError();
}

// toks: (B, S) int32; emb: (V, D), w_gate: (D, E), logits (or null): (B,
// E), w: (B, k) float32; idx: (B, k) int32; all contiguous on the card;
// S >= 1, 1 <= k <= E <= 64. Returns cudaGetLastError() after the launch;
// the caller raises if it is not cudaSuccess.
extern "C" int moe_router_tokens(const RouterTokensArgs* a, void* stream) {
  if (a->b <= 0 || a->s <= 0 || a->d <= 0 || a->v <= 0 || a->e <= 0 ||
      a->e > kMaxExperts || a->k <= 0 || a->k > a->e ||
      (long long)a->s * a->d > kSmemLimit / 4 || (long long)a->d * a->e > kSmemLimit / 4)
    return (int)cudaErrorInvalidValue;
  const size_t per_row = (size_t)row_words(a->s, a->d, a->e) * sizeof(float);
  if (per_row > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int rows = (int)(kSmemLimit / per_row < (size_t)kWarps ? kSmemLimit / per_row
                                                               : kWarps);
  const size_t bytes = rows * per_row;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_router_tokens_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = a->d % 4 == 0 && reinterpret_cast<uintptr_t>(a->emb) % 16 == 0;
  const int blocks = (a->b + rows - 1) / rows;
  moe_router_tokens_kernel<<<blocks, rows * 32, bytes,
                             static_cast<cudaStream_t>(stream)>>>(*a, rows, vec);
  return (int)cudaGetLastError();
}

// w, dw: (T, k) float32; idx: (T, k) int32 (distinct in a row, each in
// [0, E)); dlogits: (T, E) float32; all contiguous on the card; 1 <= k <=
// E <= 128. Returns cudaGetLastError() after the launch; the caller raises
// if it is not cudaSuccess.
extern "C" int moe_router_bwd(const RouterBwdArgs* a, void* stream) {
  if (a->t <= 0 || a->e <= 0 || a->e > kMaxExpertsWarp || a->k <= 0 || a->k > a->e)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)a->t * a->e;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  moe_router_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
