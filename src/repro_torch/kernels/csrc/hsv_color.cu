// HSV color histogram for Hopper (sm_90a): the paper's DogColorClassifier.
//
// Replaces the TPU kernel src/repro/kernels/hsv_color.py::hsv_color_hist
// (_hsv_kernel). Per crop: RGB -> HSV on the OpenCV H/2 scale, the first
// matching (lo, hi) range wins, a pixel in no range counts as 'other', and
// the output is the (C+1) histogram of pixel fractions.
//
// Bound: bytes. Each pixel is read once as three float32 values (12 B) and
// does a few dozen flops, far below the card's ratio of operations to
// bytes, so the floor is 12 B per pixel over the memory rate.
//
// Design. One block of 256 threads per crop; the block walks the crop in
// tiles of 256 pixels. Each tile is staged through shared memory with
// coalesced loads of the flat float array (neighbouring threads read
// neighbouring addresses), then each thread classifies one pixel. Counts
// are integers kept per thread, reduced with warp shuffles and
// shared-memory atomics; thread 0 scales each count once by the float32
// reciprocal of H*W, as the reference's mean does (XLA turns its division
// by a constant into that product). Integer counting makes the result
// equal to the plain version's exact sum. The range table sits in shared
// memory. The kernel allocates nothing and does not synchronise with the
// host.
//
// Exactness. Crops hold integer values, so pixels land on range bounds all
// the time and one ulp moves a pixel to another bucket. The arithmetic is
// the reference's, in its order, with IEEE division; the build passes
// --fmad=false so no multiply-add is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanges = 31;

// jnp.remainder(x, 6): C's fmod, then + 6 where the result is negative.
__device__ __forceinline__ float floor_mod6(float x) {
  float r = fmodf(x, 6.f);
  if (r != 0.f && r < 0.f) r += 6.f;
  return r;
}

template <int NB>  // histogram buckets held per thread (>= C + 1)
__global__ void __launch_bounds__(kThreads)
hsv_color_hist_kernel(const float* __restrict__ crops,
                      const float* __restrict__ ranges,
                      float* __restrict__ hist, int hw, int c) {
  __shared__ float s_rng[kMaxRanges * 6];
  __shared__ float s_px[kThreads * 3];
  __shared__ int s_cnt[NB];

  const int tid = threadIdx.x;
  for (int i = tid; i < c * 6; i += kThreads) s_rng[i] = ranges[i];
  if (tid < NB) s_cnt[tid] = 0;

  const float* img = crops + (size_t)blockIdx.x * (size_t)hw * 3;
  int cnt[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) cnt[j] = 0;

  for (int base = 0; base < hw; base += kThreads) {
    const int npx = min(kThreads, hw - base);
    __syncthreads();  // previous tile consumed; table and counts visible
    const float* src = img + (size_t)base * 3;
    for (int i = tid; i < npx * 3; i += kThreads) s_px[i] = src[i];
    __syncthreads();
    if (tid >= npx) continue;

    const float r = s_px[tid * 3 + 0];
    const float g = s_px[tid * 3 + 1];
    const float b = s_px[tid * 3 + 2];
    const float mx = fmaxf(fmaxf(r, g), b);
    const float mn = fminf(fminf(r, g), b);
    const float diff = mx - mn;
    const float safe = diff == 0.f ? 1.f : diff;
    float h;
    if (mx == r) {
      h = floor_mod6((g - b) / safe);
    } else if (mx == g) {
      h = (b - r) / safe + 2.f;
    } else {
      h = (r - g) / safe + 4.f;
    }
    h = (diff == 0.f ? 0.f : h) * 30.f;
    const float s = (mx == 0.f ? 0.f : diff / (mx == 0.f ? 1.f : mx)) * 255.f;
    const float v = mx;

    int bucket = c;  // 'other'
    for (int j = 0; j < c; ++j) {
      const float* q = s_rng + j * 6;
      if (h >= q[0] && s >= q[1] && v >= q[2] &&
          h <= q[3] && s <= q[4] && v <= q[5]) {
        bucket = j;
        break;
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) cnt[j] += (bucket == j);
  }

  // every thread reaches here (the loop's `continue` skips no barrier)
  const int lane = tid & 31;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    int v = cnt[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) atomicAdd(&s_cnt[j], v);
  }
  __syncthreads();
  if (tid == 0) {
    const float inv = 1.f / (float)hw;  // IEEE division, rounded once
    float* out = hist + (size_t)blockIdx.x * (size_t)(c + 1);
    for (int j = 0; j <= c; ++j) out[j] = (float)s_cnt[j] * inv;
  }
}

}  // namespace

// crops: (B, H*W, 3) float32, ranges: (C, 6) float32, hist: (B, C+1)
// float32, all contiguous on the card. Returns cudaGetLastError() after
// the launch; the caller raises if it is not cudaSuccess.
extern "C" int hsv_color_hist(const float* crops, const float* ranges,
                              float* hist, int batch, int hw, int c,
                              void* stream) {
  if (batch <= 0 || hw <= 0 || c < 0 || c > kMaxRanges)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c + 1 <= 16) {
    hsv_color_hist_kernel<16><<<batch, kThreads, 0, s>>>(crops, ranges, hist,
                                                         hw, c);
  } else {
    hsv_color_hist_kernel<32><<<batch, kThreads, 0, s>>>(crops, ranges, hist,
                                                         hw, c);
  }
  return (int)cudaGetLastError();
}
