// Blocked flash attention (forward) for Hopper (sm_90a), with GQA and a
// causal / sliding-window mask.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bhsd (_flash_kernel).
// For program bh and query row i, over the keys j of kv head bh / group
// (positions of both start at 0):
//   s_ij = scale * (q_i . k_j),   visible when (not causal or j <= i)
//                                 and (window <= 0 or j > i - window)
//   o_i  = sum_j p_ij v_j / sum_j p_ij,   p_ij = exp(s_ij - max_j s_ij)
// over the visible keys, computed online tile by tile in float32 with
// -1e30 (not -inf) as the running maximum's start. A row with no visible
// key writes 0, as the TPU kernel does where its running sum l is 0.
//
// Bound: at the predicate's shapes (S = 32, D = 8, two heads a row) a
// CTA does ~16 K flops on ~4 KB, so latency: a handful of dependent
// steps inside one CTA. At long S (1,024-4,096, D = 64) the S^2 products
// dominate and the work is bound by operations; with no tensor cores
// here, by the card's float32 rate, and this simple version stays well
// below it (wgmma tiles, TMA and a deeper pipeline are later work).
//
// Design. One CTA of 8 warps per (bh, tile of 32 query rows). Each warp
// owns 4 rows and keeps their running max m, sum l and float32
// accumulator in registers (lane c holds dims c, c + 32, ...). The CTA
// stages its q tile, then each tile of 32 keys and values, in shared
// memory as float32 (K rows padded to D + 1 floats, so 32 lanes reading
// 32 rows hit 32 banks). For each row and tile: lane j forms the logit of
// key j (dot over D in index order); a warp max gives the tile's max;
// lane j writes p_j (0 for a masked key) to shared memory; every lane
// then sums p in index order, so all hold the same l, and each of its
// dims of p . V in index order. No FMA contraction (the build passes
// --fmad=false). Tiles that the TPU kernel's block test finds fully
// masked for the CTA's rows are skipped; a masked key weighs exactly 0
// and leaves m, l and the accumulator unchanged bit for bit, so a row's
// result depends neither on the skipping nor on the rows beside it, the
// grid or the batch.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBlockK = 32;                      // keys per tile: one a lane
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int kDimsPerLane>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int d, int group, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int kstride = d + 1;
  float* s_q = smem;                     // (kBlockQ, d)
  float* s_k = s_q + kBlockQ * d;        // (kBlockK, d + 1)
  float* s_v = s_k + kBlockK * kstride;  // (kBlockK, d)
  float* s_p = s_v + kBlockK * d;        // (kBlockQ, kBlockK)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = (sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / nq;
  const int q_start = (blockIdx.x - bh * nq) * kBlockQ;
  const int q_last = q_start + kBlockQ - 1;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)(bh / group) * sk * d;
  const T* vb = v + (size_t)(bh / group) * sk * d;

  for (int i = tid; i < kBlockQ * d; i += kWarps * 32)
    s_q[i] = q_start + i / d < sq ? to_f32(qb[(size_t)q_start * d + i]) : 0.f;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int k_start = 0; k_start < sk; k_start += kBlockK) {
    // the TPU kernel's block test over this CTA's rows [q_start, q_last]
    if (causal && k_start > q_last) break;
    if (window > 0 && k_start + kBlockK - 1 < q_start - window + 1) continue;
    __syncthreads();  // the q tile is staged; the previous tile is consumed
    for (int i = tid; i < kBlockK * d; i += kWarps * 32) {
      const int r = i / d;
      const bool in = k_start + r < sk;
      s_k[r * kstride + (i - r * d)] =
          in ? to_f32(kb[(size_t)k_start * d + i]) : 0.f;
      s_v[i] = in ? to_f32(vb[(size_t)k_start * d + i]) : 0.f;
    }
    __syncthreads();
    const int kpos = k_start + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q_start + row;
      bool visible = kpos < sk;
      if (causal) visible = visible && kpos <= qpos;
      if (window > 0) visible = visible && kpos > qpos - window;
      float s = kNegInf;
      if (visible) {
        const float* qr = s_q + row * d;
        const float* kr = s_k + lane * kstride;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        s = dot * scale;
      }
      const float m_new = fmaxf(m[r], warp_max(s));
      float* pr = s_p + row * kBlockK;
      pr[lane] = visible ? expf(s - m_new) : 0.f;
      __syncwarp();
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
      for (int j = 0; j < kBlockK; ++j) psum += pr[j];
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          float pv = 0.f;
          for (int j = 0; j < kBlockK; ++j) pv += pr[j] * s_v[j * d + c];
          acc[r][i] = acc[r][i] * corr + pv;
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q_start + warp * kRowsPerWarp + r;
    if (qpos >= sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // no visible key -> 0
    T* orow = o + ((size_t)bh * sq + qpos) * d;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store(orow + c, acc[r][i] / denom);
    }
  }
}

template <typename T, int kDimsPerLane>
int launch(const void* q, const void* k, const void* v, void* o, int blocks,
           int sq, int sk, int d, int group, int causal, int window,
           float scale, size_t smem, cudaStream_t stream) {
  auto kernel = flash_kernel<T, kDimsPerLane>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, group, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int blocks,
             int sq, int sk, int d, int group, int causal, int window,
             float scale, size_t smem, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, o, blocks, sq, sk, d, group, causal, window,
                        scale, smem, stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, o, blocks, sq, sk, d, group, causal, window,
                        scale, smem, stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, o, blocks, sq, sk, d, group, causal, window,
                        scale, smem, stream);
  return launch<T, 8>(q, k, v, o, blocks, sq, sk, d, group, causal, window,
                      scale, smem, stream);
}

}  // namespace

// q, o: (BH, Sq, D); k, v: (BH / group, Sk, D); all contiguous on the
// card, float32 (bf16 == 0) or bfloat16 (bf16 == 1), o in q's type.
// 1 <= D <= 256, group >= 1 divides BH, Sk >= 0. Returns
// cudaGetLastError() after the launch; the caller raises if it is not
// cudaSuccess.
extern "C" int flash_attention_bhsd(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int sk, int d, int group, int causal,
                                    int window, float scale, int bf16,
                                    void* stream) {
  if (bh <= 0 || sq <= 0 || sk < 0 || d <= 0 || d > kMaxHeadDim ||
      group <= 0 || bh % group != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)bh * ((sq + kBlockQ - 1) / kBlockQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kBlockQ * d + (size_t)kBlockK * (d + 1) +
                       (size_t)kBlockK * d + (size_t)kBlockQ * kBlockK) *
                      sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, (int)blocks, sq, sk, d, group,
                                   causal, window, scale, smem, s);
  return dispatch<float>(q, k, v, o, (int)blocks, sq, sk, d, group, causal,
                         window, scale, smem, s);
}
