// Split-cache GQA flash-decode for Hopper (sm_90a): one new token's query
// heads against an S-long KV cache, masked by a per-sequence length, with
// strided operands.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_bkgd
// (_decode_kernel). Program p = b * kv_heads + kh is one (sequence, kv
// head) pair; with len = lengths[b] clamped to [0, S], each of its G
// query rows g gives
//   o_g = sum_{j < len} p_gj v_j / sum_{j < len} p_gj,
//   p_gj = exp(s_gj - max_j s_gj),   s_gj = scale * (q_g . k_j),
// in float32 from a running maximum of -1e30. A key past the length
// weighs exactly 0, and len 0 writes 0, as the TPU kernel does where its
// running sum l is 0.
//
// Bound: bytes. Each key brings 2 D elements and costs ~4 G D flops, so
// at the predicate's G = 2, D = 8 and at bench_kernels' G = 4, D = 64
// there are 1-2 flops a byte, far below the card's ~20 float32 flops a
// byte: the products stay on the CUDA cores (with FMA), and the design
// is about keeping many bytes in flight on many SMs.
//
// Design (flash-decoding).
// - Grid: program x split x row chunk. A split is a fixed stretch of the
//   cache (the caller passes its length, 256 keys), never sized by the
//   batch or the SM count; a row chunk is up to R query rows: 4 where G <=
//   4, else 32 / (dims a lane holds). At (8, 4096, 8, 2, 64) that is 256
//   CTAs on 132 SMs. A CTA whose split starts at or past the length exits
//   at once (writing its rows' 0 when the cache is one split); the
//   combine never reads it.
// - Per CTA: W warps (4 at D <= 64, 2 at D = 128, 1 at D = 256, so that
//   the rings fit in shared memory). The CTA stages its rows of q once
//   (float32, zero past D). Warp w takes the split's 32-key tiles w, w +
//   W, ... and streams them through a private two-stage ring of K and V
//   tiles in shared memory, filled by cp.async (16 bytes a thread, zero
//   past the length and D): tile i + 1 lands while tile i is computed,
//   with no block-wide barrier. Per tile, lane j forms key j's logits
//   (float4 reads of its K row against broadcast q rows), a warp max and
//   sum update each row's running max m and sum l, and each lane adds p
//   . V for its dims (c, c + 32, ...), p broadcast by shuffles.
// - The W warps' (m, l, acc) are merged in warp order through shared
//   memory. With one split (S <= 256: the predicates' S = 32) the CTA
//   writes o = acc / l (0 where l = 0) directly and nothing else
//   launches. With more, it writes the partial (m, l, acc) in float32 to
//   a scratch buffer, and a combine kernel merges a program's live splits
//   in split order (max, rescale, sum) and writes o. The choice of path
//   is made from S alone.
// - A row's arithmetic depends on its own query, cache, length, D and
//   the dtype only, never on the batch or the grid.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileKeys = 32;  // keys of one warp tile: one a lane
constexpr int kMaxRows = 32;   // query heads per kv head
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

// element strides of one operand: between sequences, kv heads and rows
// (query rows for q and o, cache positions for k and v)
struct Layout {
  long long batch, head, row;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part;  // (programs, splits, G, D + 2): acc, then m and l
  Layout lq, lk, lv, lo;
  int kv_heads, g, s, d, split, splits, row_chunks, vec;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// four consecutive elements as float32 (16 bytes of float, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;  // the same value in every lane
}

// keys [pos0, pos0 + 32) of one program's cache into a (32, RS) tile by
// one warp, zero from position end and from column d on
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int pos0, int end,
                                          int d, bool vec, int lane) {
  constexpr int RS = DP + 16 / (int)sizeof(T);
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kChunks = DP / kVec;
    for (int i = lane; i < kTileKeys * kChunks; i += 32) {
      const int r = i / kChunks;
      const int col = (i - r * kChunks) * kVec;
      const int pos = pos0 + r;
      const bool in = pos < end && col < d;
      cp_async16(dst + r * RS + col, in ? src + pos * stride + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = lane; i < kTileKeys * DP; i += 32) {
      const int r = i / DP;
      const int col = i - r * DP;
      const int pos = pos0 + r;
      dst[r * RS + col] =
          pos < end && col < d ? src[pos * stride + col] : zero<T>();
    }
  }
}

template <int DP>
struct Shape {
  static constexpr int kDimsPerLane = DP <= 32 ? 1 : DP / 32;
  static constexpr int kRows = kMaxRows / kDimsPerLane;  // rows per CTA
  static constexpr int kWarps = DP <= 64 ? 4 : (DP == 128 ? 2 : 1);
};
constexpr int kFewRows = 4;  // G <= 4 (the predicates' 2, bench's 4)

// R: the query rows of one CTA (Shape<DP>::kRows, or kFewRows for G <= 4)
template <typename T, int DP, int R>
__global__ void __launch_bounds__(Shape<DP>::kWarps * 32)
decode_split_kernel(const Params p) {
  constexpr int DPL = Shape<DP>::kDimsPerLane;
  constexpr int W = Shape<DP>::kWarps;
  constexpr int RS = DP + 16 / (int)sizeof(T);
  constexpr int kStage = kTileKeys * RS;  // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_q = reinterpret_cast<float*>(smem_raw);  // (R, DP)
  T* s_ring = reinterpret_cast<T*>(s_q + R * DP);   // W x (K, V) x 2 stages

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x % p.row_chunks;
  const int rest = blockIdx.x / p.row_chunks;
  const int split = rest % p.splits;
  const int prog = rest / p.splits;
  const int b = prog / p.kv_heads;
  const int kh = prog - b * p.kv_heads;
  const int len = min(max(p.lengths[b], 0), p.s);
  const int key0 = split * p.split;
  const int row0 = chunk * R;
  const int rows = min(R, p.g - row0);
  if (key0 >= len) {  // past the length: the combine never reads it
    if (p.splits == 1) {  // len 0 with one split: the rows are 0
      T* ob = static_cast<T*>(p.o) + b * p.lo.batch + kh * p.lo.head;
      for (int i = tid; i < rows * p.d; i += W * 32)
        store(ob + (row0 + i / p.d) * p.lo.row + i % p.d, 0.f);
    }
    return;
  }
  const int key_end = min(key0 + p.split, len);
  const T* qb = static_cast<const T*>(p.q) + b * p.lq.batch +
                kh * p.lq.head + row0 * p.lq.row;
  const T* kb = static_cast<const T*>(p.k) + b * p.lk.batch + kh * p.lk.head;
  const T* vb = static_cast<const T*>(p.v) + b * p.lv.batch + kh * p.lv.head;
  const bool vec = p.vec != 0;

  // this warp's tiles: w, w + W, ... of the split's live keys
  const int n_split_tiles = (key_end - key0 + kTileKeys - 1) / kTileKeys;
  const int n_tiles =
      warp < n_split_tiles ? (n_split_tiles - warp + W - 1) / W : 0;
  T* ring_k = s_ring + warp * 4 * kStage;  // 2 stages of K, then 2 of V
  T* ring_v = ring_k + 2 * kStage;
  if (n_tiles > 0) {
    const int pos = key0 + warp * kTileKeys;
    load_tile<T, DP>(ring_k, kb, p.lk.row, pos, key_end, p.d, vec, lane);
    load_tile<T, DP>(ring_v, vb, p.lv.row, pos, key_end, p.d, vec, lane);
  }
  cp_async_commit();

  for (int i = tid; i < R * DP; i += W * 32) {
    const int r = i / DP;
    const int c = i - r * DP;
    s_q[i] = r < rows && c < p.d ? to_f32(qb[r * p.lq.row + c]) : 0.f;
  }
  __syncthreads();

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int pos = key0 + (warp + it * W) * kTileKeys;
    if (it + 1 < n_tiles) {
      const int next = pos + W * kTileKeys;
      const int stage = (it + 1) & 1;
      load_tile<T, DP>(ring_k + stage * kStage, kb, p.lk.row, next, key_end,
                       p.d, vec, lane);
      load_tile<T, DP>(ring_v + stage * kStage, vb, p.lv.row, next, key_end,
                       p.d, vec, lane);
    }
    cp_async_commit();
    cp_async_wait_1();  // all but the newest group: tile it has landed
    __syncwarp();
    const T* tk = ring_k + (it & 1) * kStage;
    const T* tv = ring_v + (it & 1) * kStage;
    const bool visible = pos + lane < key_end;

    // logits of key `lane` for every row
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      const float4 kv = load4(tk + lane * RS + c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float4 qv = *reinterpret_cast<const float4*>(s_q + r * DP + c);
          sc[r] = fmaf(qv.x, kv.x, sc[r]);
          sc[r] = fmaf(qv.y, kv.y, sc[r]);
          sc[r] = fmaf(qv.z, kv.z, sc[r]);
          sc[r] = fmaf(qv.w, kv.w, sc[r]);
        }
      }
    }
    // online softmax per row; sc becomes p
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const float x = visible ? sc[r] * p.scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(x));
        sc[r] = visible ? expf(x - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(sc[r]);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      }
    }
    // acc += p . V over the tile's keys, in key order
#pragma unroll 4
    for (int j = 0; j < kTileKeys; ++j) {
      float vj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        vj[i] = c < DP ? to_f32(tv[j * RS + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float pj = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
        }
      }
    }
    __syncwarp();  // the stage is consumed before it is refilled
  }

  // merge the warps' (m, l, acc) in warp order through shared memory
  __syncthreads();  // every warp is done with its ring
  float* s_acc = reinterpret_cast<float*>(s_ring);  // (W, R, DP)
  float* s_ml = s_acc + W * R * DP;                 // (W, R, 2)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        if (c < DP) s_acc[(warp * R + r) * DP + c] = acc[r][i];
      }
      if (lane == 0) {
        s_ml[(warp * R + r) * 2] = m[r];
        s_ml[(warp * R + r) * 2 + 1] = l[r];
      }
    }
  }
  __syncthreads();
  const bool direct = p.splits == 1;
  T* ob = static_cast<T*>(p.o) + b * p.lo.batch + kh * p.lo.head;
  float* part = p.part + ((long long)prog * p.splits + split) * p.g *
                             (long long)(p.d + 2);
  for (int i = tid; i < rows * p.d; i += W * 32) {
    const int r = i / p.d;
    const int c = i - r * p.d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, s_ml[(w * R + r) * 2]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = expf(s_ml[(w * R + r) * 2] - mx);
      sum += s_ml[(w * R + r) * 2 + 1] * f;
      a += s_acc[(w * R + r) * DP + c] * f;
    }
    if (direct) {
      store(ob + (row0 + r) * p.lo.row + c, sum == 0.f ? 0.f : a / sum);
    } else {
      float* pr = part + (long long)(row0 + r) * (p.d + 2);
      pr[c] = a;
      if (c == 0) {
        pr[p.d] = mx;
        pr[p.d + 1] = sum;
      }
    }
  }
}

// one CTA per program: merge its live splits in split order and write o
template <typename T>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const Params p) {
  __shared__ float s_max[kMaxRows], s_sum[kMaxRows];
  const int prog = blockIdx.x;
  const int b = prog / p.kv_heads;
  const int kh = prog - b * p.kv_heads;
  const int len = min(max(p.lengths[b], 0), p.s);
  const int live = (len + p.split - 1) / p.split;
  const long long ss = (long long)p.g * (p.d + 2);  // between splits
  const float* part = p.part + prog * p.splits * ss;
  // each row's max and rescaled sum (loads unrolled, so they overlap)
  for (int r = threadIdx.x; r < p.g; r += blockDim.x) {
    const float* pr = part + r * (p.d + 2);
    float mx = kNegInf;
#pragma unroll 8
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, pr[s * ss + p.d]);
    float sum = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      sum += pr[s * ss + p.d + 1] * expf(pr[s * ss + p.d] - mx);
    s_max[r] = mx;
    s_sum[r] = sum;
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.o) + b * p.lo.batch + kh * p.lo.head;
  for (int i = threadIdx.x; i < p.g * p.d; i += blockDim.x) {
    const int r = i / p.d;
    const int c = i - r * p.d;
    const float* pr = part + r * (p.d + 2);
    const float mx = s_max[r];
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      a += pr[s * ss + c] * expf(pr[s * ss + p.d] - mx);
    store(ob + r * p.lo.row + c, s_sum[r] == 0.f ? 0.f : a / s_sum[r]);
  }
}

template <typename T, int DP, int R>
int launch(const Params& p, int programs, cudaStream_t stream) {
  using S = Shape<DP>;
  constexpr int RS = DP + 16 / (int)sizeof(T);
  constexpr size_t kRing = (size_t)S::kWarps * 4 * kTileKeys * RS * sizeof(T);
  constexpr size_t kMerge = (size_t)S::kWarps * R * (DP + 2) * 4;
  constexpr size_t kSmem =
      (size_t)R * DP * 4 + (kRing > kMerge ? kRing : kMerge);
  static_assert(kSmem <= 232448, "rings exceed a block's shared memory");
  Params q = p;
  q.row_chunks = (p.g + R - 1) / R;
  const long long blocks = (long long)programs * p.splits * q.row_chunks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = decode_split_kernel<T, DP, R>;
  if (kSmem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<(int)blocks, S::kWarps * 32, kSmem, stream>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  decode_combine_kernel<T><<<programs, 128, 0, stream>>>(q);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int by_rows(const Params& p, int programs, cudaStream_t stream) {
  constexpr int kRows = Shape<DP>::kRows;
  if (kRows > kFewRows && p.g <= kFewRows)
    return launch<T, DP, (kRows > kFewRows ? kFewRows : kRows)>(p, programs,
                                                                stream);
  return launch<T, DP, kRows>(p, programs, stream);
}

template <typename T>
int dispatch(const Params& p, int programs, cudaStream_t stream) {
  if (p.d <= 8) return by_rows<T, 8>(p, programs, stream);
  if (p.d <= 16) return by_rows<T, 16>(p, programs, stream);
  if (p.d <= 32) return by_rows<T, 32>(p, programs, stream);
  if (p.d <= 64) return by_rows<T, 64>(p, programs, stream);
  if (p.d <= 128) return by_rows<T, 128>(p, programs, stream);
  return by_rows<T, 256>(p, programs, stream);
}

bool aligned16(const void* ptr, const Layout& l, size_t elem) {
  const size_t a = 16 / elem;  // elements in 16 bytes
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && l.batch % a == 0 &&
         l.head % a == 0 && l.row % a == 0;
}

}  // namespace

// The entry point's arguments, packed by the caller (Python's struct
// format "<6Q12q7if", no padding): the six pointers; the element strides
// (between sequences, kv heads and rows) of q, the caches and o; the
// sizes, the split length, the dtype flag and the scale.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  void* partials;
  Layout lq, lk, lv, lo;
  int batch, kv_heads, g, s, d, split, bf16;
  float scale;
};
static_assert(sizeof(DecodeArgs) == 176, "DecodeArgs must match <6Q12q7if");

// q, o: (batch, kv_heads, G, D) and k_cache, v_cache: (batch, kv_heads, S,
// D), each addressed by its own strides with the last dimension
// contiguous; lengths: (batch,) int32, contiguous. float32 (bf16 == 0) or
// bfloat16 (bf16 == 1), o in q's type. 1 <= G <= 32, 1 <= D <= 256, S >=
// 1; split is the keys of one CTA, a positive multiple of 32. With S >
// split, `partials` holds batch * kv_heads * ceil(S / split) * G * (D + 2)
// floats of scratch (unused otherwise). Returns cudaGetLastError() after
// the launches; the caller raises if it is not cudaSuccess.
extern "C" int decode_attention_bshd(const DecodeArgs* a, void* stream) {
  if (a->batch <= 0 || a->kv_heads <= 0 || a->g <= 0 || a->g > kMaxRows ||
      a->s <= 0 || a->d <= 0 || a->d > kMaxHeadDim || a->split <= 0 ||
      a->split % kTileKeys != 0)
    return (int)cudaErrorInvalidValue;
  const long long programs = (long long)a->batch * a->kv_heads;
  const int splits = (a->s + a->split - 1) / a->split;
  if (programs > INT_MAX || (splits > 1 && a->partials == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{a->q,       a->k,      a->v,     a->lengths,
           a->o,       static_cast<float*>(a->partials),
           a->lq,      a->lk,     a->lv,    a->lo,
           a->kv_heads, a->g,     a->s,     a->d,
           a->split,   splits,    1,        0,
           a->scale};
  const size_t elem = a->bf16 ? 2 : 4;
  p.vec = a->d % (16 / elem) == 0 && aligned16(a->k, a->lk, elem) &&
          aligned16(a->v, a->lv, elem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->bf16) return dispatch<__nv_bfloat16>(p, (int)programs, st);
  return dispatch<float>(p, (int)programs, st);
}
