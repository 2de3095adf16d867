// GQA flash-decode for Hopper (sm_90a): one new token's query heads
// against an S-long KV cache, masked by a per-sequence length.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_bkgd
// (_decode_kernel). Program b is one (sequence, kv head) pair; with
// len = lengths[b / num_kv_heads] clamped to [0, S], each of its G query
// rows g gives
//   o_g = sum_{j < len} p_gj v_j / sum_{j < len} p_gj,
//   p_gj = exp(s_gj - max_j s_gj),   s_gj = scale * (q_g . k_j),
// computed online tile by tile in float32 from a running maximum of -1e30.
// len 0 writes 0, as the TPU kernel does where its running sum l is 0.
//
// Bound: bytes. Each program reads len keys and values of D floats and
// does ~4 G D flops per key, so at the predicate's G = 2 and D = 8 (and at
// G = 4, D = 64) there are 1-2 flops per byte, far below the card's
// ~20 float32 flops per byte. This simple version gives each program one
// CTA that walks the cache in order, so at a long cache with few programs
// most SMs sit idle (splitting the cache over CTAs is later work).
//
// Design. One CTA of 8 warps per program; warp w owns rows w, w + 8, ...
// (G <= 32) with their running max m, sum l and float32 accumulator in
// registers (lane c holds dims c, c + 32, ...). The CTA stages its G
// query rows, then each tile of 32 keys and values, in shared memory as
// float32 (K rows padded to D + 1 floats for conflict-free reads), and
// stops at the tile that holds position len - 1 (the TPU kernel skips
// blocks past the length). Per row and tile: lane j forms the logit of
// key j (dot over D in index order), a warp max gives the tile's max,
// lane j writes p_j (0 past the length) to shared memory, and every lane
// sums p and its dims of p . V in index order. No FMA contraction (the
// build passes --fmad=false). A row's arithmetic depends on its own
// query, cache and length only, never on the batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // query heads per kv head
constexpr int kBlockK = 32;                       // keys per tile: one a lane
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
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int g, int s, int d, int num_kv_heads,
              float scale) {
  extern __shared__ float smem[];
  const int kstride = d + 1;
  float* s_q = smem;                     // (G, d)
  float* s_k = s_q + g * d;              // (kBlockK, d + 1)
  float* s_v = s_k + kBlockK * kstride;  // (kBlockK, d)
  float* s_p = s_v + kBlockK * d;        // (G, kBlockK)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int len = min(max(lengths[b / num_kv_heads], 0), s);
  const T* qb = q + (size_t)b * g * d;
  const T* kb = k + (size_t)b * s * d;
  const T* vb = v + (size_t)b * s * d;

  for (int i = tid; i < g * d; i += kWarps * 32) s_q[i] = to_f32(qb[i]);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int k_start = 0; k_start < len; k_start += kBlockK) {
    __syncthreads();  // the queries are staged; the previous tile is consumed
    for (int i = tid; i < kBlockK * d; i += kWarps * 32) {
      const int r = i / d;
      const bool in = k_start + r < len;
      s_k[r * kstride + (i - r * d)] =
          in ? to_f32(kb[(size_t)k_start * d + i]) : 0.f;
      s_v[i] = in ? to_f32(vb[(size_t)k_start * d + i]) : 0.f;
    }
    __syncthreads();
    const bool visible = k_start + lane < len;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      if (row >= g) continue;
      float sc = kNegInf;
      if (visible) {
        const float* qr = s_q + row * d;
        const float* kr = s_k + lane * kstride;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        sc = dot * scale;
      }
      const float m_new = fmaxf(m[r], warp_max(sc));
      float* pr = s_p + row * kBlockK;
      pr[lane] = visible ? expf(sc - m_new) : 0.f;
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
    const int row = warp + kWarps * r;
    if (row >= g) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // length 0 -> 0
    T* orow = o + ((size_t)b * g + row) * d;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store(orow + c, acc[r][i] / denom);
    }
  }
}

template <typename T, int kDimsPerLane>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int bkv, int g, int s, int d, int num_kv_heads,
           float scale, size_t smem, cudaStream_t stream) {
  auto kernel = decode_kernel<T, kDimsPerLane>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<bkv, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), g, s, d,
      num_kv_heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* o, int bkv, int g, int s, int d, int num_kv_heads,
             float scale, size_t smem, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, lengths, o, bkv, g, s, d, num_kv_heads,
                        scale, smem, stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, lengths, o, bkv, g, s, d, num_kv_heads,
                        scale, smem, stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, lengths, o, bkv, g, s, d, num_kv_heads,
                        scale, smem, stream);
  return launch<T, 8>(q, k, v, lengths, o, bkv, g, s, d, num_kv_heads, scale,
                      smem, stream);
}

}  // namespace

// q, o: (B * Hkv, G, D); k_cache, v_cache: (B * Hkv, S, D); lengths: (B,)
// int32; all contiguous on the card, float32 (bf16 == 0) or bfloat16
// (bf16 == 1), o in q's type. 1 <= G <= 32, 1 <= D <= 256, S >= 1,
// num_kv_heads >= 1 divides B * Hkv. Returns cudaGetLastError() after the
// launch; the caller raises if it is not cudaSuccess.
extern "C" int decode_attention_bkgd(const void* q, const void* k_cache,
                                     const void* v_cache, const int* lengths,
                                     void* o, int bkv, int g, int s, int d,
                                     int num_kv_heads, float scale, int bf16,
                                     void* stream) {
  if (bkv <= 0 || g <= 0 || g > kMaxRows || s <= 0 || d <= 0 ||
      d > kMaxHeadDim || num_kv_heads <= 0 || bkv % num_kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)g * d + (size_t)kBlockK * (d + 1) +
                       (size_t)kBlockK * d + (size_t)g * kBlockK) *
                      sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, lengths, o, bkv, g,
                                   s, d, num_kv_heads, scale, smem, st);
  return dispatch<float>(q, k_cache, v_cache, lengths, o, bkv, g, s, d,
                         num_kv_heads, scale, smem, st);
}
