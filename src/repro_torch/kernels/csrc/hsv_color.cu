// HSV color histogram for Hopper (sm_90a): the paper's DogColorClassifier.
//
// Replaces the TPU kernel src/repro/kernels/hsv_color.py::hsv_color_hist
// (_hsv_kernel). Per crop: RGB -> HSV on the OpenCV H/2 scale, the first
// matching (lo, hi) range wins, a pixel in no range counts as 'other', and
// the output is the (C+1) histogram of pixel fractions.
//
// Bound: bytes, 12 B a pixel (three float32 values read once) over the
// memory rate. At many crops the instructions come close too: two IEEE
// divisions, C ranges of six compares and the count cost about as much
// issue time per pixel as its 12 bytes take to arrive. At the main path's
// 4-32 crops the launch and one load latency set the time.
//
// Design. A crop is split over a cluster of K CTAs (K = 1, 2, 4 or 8,
// chosen by the wrapper's plan from the batch and the crop size: enough
// CTAs to fill the card at a few crops, K = 1 at thousands), CTA r taking
// pixels [r * stretch, (r + 1) * stretch), stretch a multiple of 4. Each
// thread takes groups of 4 consecutive pixels: where a crop starts on 16
// bytes (H * W % 4 == 0) a group is three float4 loads, else (and at a
// ragged tail) scalar loads; the next group's loads are issued before the
// current one is classified, and nothing is staged through shared memory,
// so there is no barrier per tile. A group's 4 pixels are tested against
// each range together (one shared-memory read of the range for four
// pixels), every range in turn with no branch: the lowest matching index
// wins, as the first match does. A thread counts its pixels in 4-bit
// fields of 64-bit words (one add a pixel) and moves them into integer
// counters every 12 pixels; the counters are summed across the warp
// (redux), added into the leader CTA's shared counts through distributed
// shared memory (cluster.map_shared_rank), and after a cluster barrier the
// leader scales each count once by the float32 reciprocal of H*W, as the
// reference's mean does (XLA turns its division by a constant into that
// product). Integer addition is exact in any order, so the histogram is
// the plain version's bit for bit whatever K is, and a row does not
// depend on its batch. The kernel allocates nothing and does not
// synchronise with the host.
//
// Exactness. Crops hold integer values, so pixels land on range bounds all
// the time and one ulp moves a pixel to another bucket. The arithmetic is
// the reference's, with IEEE division; the build passes --fmad=false so no
// multiply-add is contracted. The hue's floor-mod needs no fmodf: when the
// maximum is r, x = (g - b) / diff with |g - b| <= diff (both rounded
// monotonically, so also in float32), hence |x| <= 1 < 6, fmod(x, 6) == x
// exactly and jnp.remainder(x, 6) is x < 0 ? x + 6 : x, bit for bit (-0.0
// stays -0.0 in both). The hue's numerator is picked first and divided
// once, so a warp's lanes do not diverge over three divisions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// HsvArgs in the wrapper's struct format; cluster, stretch and threads are
// the wrapper's plan; vec (ignored on entry, the entry point sets it) says
// every crop starts on 16 bytes.
struct HsvArgs {
  const float* crops;   // (B, H*W, 3)
  const float* ranges;  // (C, 6)
  float* hist;          // (B, C+1)
  long long batch;
  int hw, c, cluster, stretch, threads, vec;
};
static_assert(sizeof(HsvArgs) == 56, "HsvArgs must match <3Qq6i");

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxRanges = 31;
constexpr int kMaxCluster = 8;
constexpr int kFlushGroups = 3;  // 12 pixels: a 4-bit field holds 15

__device__ __forceinline__ void load_group(const float* src, int npx, bool vec,
                                           float (&px)[12]) {
  if (vec && npx == 4) {
    const float4* s = reinterpret_cast<const float4*>(src);
    const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
    px[0] = a.x; px[1] = a.y; px[2] = a.z; px[3] = a.w;
    px[4] = b.x; px[5] = b.y; px[6] = b.z; px[7] = b.w;
    px[8] = c.x; px[9] = c.y; px[10] = c.z; px[11] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) px[k] = k < 3 * npx ? __ldg(src + k) : 0.f;
  }
}

// the reference's rgb_to_hsv for one pixel
__device__ __forceinline__ void to_hsv(float r, float g, float b, float& h,
                                       float& s, float& v) {
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float diff = mx - mn;
  const float safe = diff == 0.f ? 1.f : diff;
  const bool is_r = mx == r;
  const bool is_g = !is_r && mx == g;
  const float num = is_r ? g - b : (is_g ? b - r : r - g);
  const float q = num / safe;
  float hue = is_r ? (q < 0.f ? q + 6.f : q) : (is_g ? q + 2.f : q + 4.f);
  h = (diff == 0.f ? 0.f : hue) * 30.f;
  s = (mx == 0.f ? 0.f : diff / (mx == 0.f ? 1.f : mx)) * 255.f;
  v = mx;
}

// one bucket's pixel into 4-bit fields: buckets 0-15 in w[0], 16-31 in w[1]
template <int NW>
__device__ __forceinline__ void count(unsigned long long (&w)[NW], int bucket) {
  const unsigned long long one = 1ull << ((bucket & 15) << 2);
  if (NW == 1) {
    w[0] += one;
  } else {
    w[0] += bucket < 16 ? one : 0ull;
    w[NW - 1] += bucket < 16 ? 0ull : one;
  }
}

template <int NB>
__device__ __forceinline__ void flush(unsigned long long (&w)[NB / 16], int (&cnt)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
    cnt[j] += (int)((w[j >> 4] >> ((j & 15) << 2)) & 15ull);
#pragma unroll
  for (int k = 0; k < NB / 16; ++k) w[k] = 0ull;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int NB>  // histogram buckets counted per thread (>= C + 1)
__global__ void __launch_bounds__(kMaxThreads)
hsv_color_hist_kernel(const HsvArgs a) {
  __shared__ float4 s_rng[kMaxRanges * 2];  // range j: lo (h, s, v, -), hi
  __shared__ int s_cnt[NB];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int c = a.c;
  const long long crop = blockIdx.x / a.cluster;
  const int rank = (int)cluster.block_rank();

  float* rng = reinterpret_cast<float*>(s_rng);
  for (int i = tid; i < c * 6; i += blockDim.x)
    rng[(i / 6) * 8 + (i % 6 < 3 ? i % 6 : i % 6 + 1)] = a.ranges[i];
  if (tid < NB) s_cnt[tid] = 0;
  __syncthreads();  // the range table and the zero counts are in place
  cluster_arrive();  // ... and the leader's counts may take remote adds

  const int begin = rank * a.stretch;
  const int end = min(a.hw, begin + a.stretch);
  const int step = 4 * blockDim.x;
  const float* img = a.crops + crop * (long long)a.hw * 3;
  const bool vec = a.vec != 0;

  int cnt[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) cnt[j] = 0;
  unsigned long long w[NB / 16];
#pragma unroll
  for (int k = 0; k < NB / 16; ++k) w[k] = 0ull;

  int g = begin + 4 * tid;
  float px[12];
  if (g < end) load_group(img + 3LL * g, min(4, end - g), vec, px);
  for (int n = 0; g < end; g += step) {
    const int npx = min(4, end - g);
    float nx[12];
    const int gn = g + step;
    if (gn < end) load_group(img + 3LL * gn, min(4, end - gn), vec, nx);

    float h[4], s[4], v[4];
    int bucket[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      to_hsv(px[3 * q], px[3 * q + 1], px[3 * q + 2], h[q], s[q], v[q]);
      bucket[q] = c;  // 'other'
    }
    for (int j = c - 1; j >= 0; --j) {  // the lowest match is written last
      const float4 lo = s_rng[2 * j];
      const float4 hi = s_rng[2 * j + 1];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = (h[q] >= lo.x) & (s[q] >= lo.y) & (v[q] >= lo.z) &
                        (h[q] <= hi.x) & (s[q] <= hi.y) & (v[q] <= hi.z);
        bucket[q] = in ? j : bucket[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < npx) count<NB / 16>(w, bucket[q]);
    if (++n == kFlushGroups) {
      flush<NB>(w, cnt);
      n = 0;
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) px[k] = nx[k];
  }
  flush<NB>(w, cnt);

  // the warp's counts, then into the leader's shared counts
  const int lane = tid & 31;
  int* leader = cluster.map_shared_rank(s_cnt, 0);
  int tot[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) tot[j] = __reduce_add_sync(0xffffffffu, cnt[j]);
  cluster_wait();  // every CTA's counts are zero and visible
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (tot[j] != 0) atomicAdd(leader + j, tot[j]);
  }
  cluster_arrive();  // every remote add is done ...
  cluster_wait();    // ... before the leader reads its counts
  if (rank == 0 && tid <= c) {
    const float inv = 1.f / (float)a.hw;  // IEEE division, rounded once
    a.hist[crop * (c + 1) + tid] = (float)s_cnt[tid] * inv;
  }
}

template <int NB>
int launch(const HsvArgs& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.batch * a.cluster), 1, 1);
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, hsv_color_hist_kernel<NB>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// crops: (B, H*W, 3) float32 contiguous, ranges: (C, 6) float32
// contiguous, hist: (B, C+1) float32, all on the card; the plan (cluster
// in 1, 2, 4, 8; stretch a multiple of 4 with cluster * stretch >= H*W;
// threads a multiple of 32 up to 128) comes from the wrapper. Returns
// cudaGetLastError() after the launch; the caller raises if it is not
// cudaSuccess.
extern "C" int hsv_color_hist(const HsvArgs* a, void* stream) {
  const int k = a->cluster;
  if (a->batch <= 0 || a->hw <= 0 || a->c < 0 || a->c > kMaxRanges ||
      !(k == 1 || k == 2 || k == 4 || k == 8) || k > kMaxCluster ||
      a->stretch <= 0 || a->stretch % 4 != 0 ||
      (long long)k * a->stretch < a->hw || a->threads <= 0 ||
      a->threads > kMaxThreads || a->threads % 32 != 0 ||
      a->batch * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  HsvArgs args = *a;
  args.vec = args.hw % 4 == 0 && reinterpret_cast<uintptr_t>(args.crops) % 16 == 0;
  if (args.c + 1 <= 16) return launch<16>(args, s);
  return launch<32>(args, s);
}
