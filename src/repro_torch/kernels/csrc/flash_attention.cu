// Blocked flash attention (forward) for Hopper (sm_90a) on the tensor
// cores, with GQA, a causal / sliding-window mask and strided operands.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bhsd (_flash_kernel).
// For program p = b * heads + h and query row i, over the keys j of kv
// head h / group of sequence b (positions of both start at 0):
//   s_ij = scale * (q_i . k_j),   visible when (not causal or j <= i)
//                                 and (window <= 0 or j > i - window)
//   o_i  = sum_j p_ij v_j / sum_j p_ij,   p_ij = exp(s_ij - max_j s_ij)
// over the visible keys, computed online tile by tile in float32 with
// -1e30 (not -inf) as the running maximum's start. A masked key weighs
// exactly 0, and a row with no visible key writes 0, as the TPU kernel
// does where its running sum l is 0. scale is D ** -0.5 on the true D
// unless the caller gives one; bf16 results round to nearest even.
//
// Bound: by shape. The products go to the tensor cores: bf16 at 989
// TFLOP/s, and float32 at a third of TF32's 495 TFLOP/s, because every
// float32 product is three TF32 products (below). In bf16, S = 512 causal
// is bound by bytes (q, k, v read once and o written once: grok-1's (2,
// 512, 48, 8, 128) moves 29 MB for 6.5 GFLOP, the LLM predicate's (64,
// 512, 9, 3, 64) 101 MB for 19 GFLOP), longer or wider attention by
// operations (whisper-small's encoder, recurrentgemma-9b's D = 256). At
// the predicates' S = 32, D = 8 the work is a few dependent steps inside
// one CTA: latency.
//
// Two designs, chosen by the dtype; flash_attention_route says which a
// call takes. Both give a CTA 64 query rows of one program and walk the
// key tiles (aligned to 64 from key 0) that the TPU kernel's block test
// lets some of those rows see: tiles wholly outside the causal or window
// band are skipped, tiles wholly inside it skip the per-element test, and
// the late (heavy) query tiles of every program launch first. Either may
// split a CTA's key tiles between two key groups (the even and the odd
// tiles) and merge the groups' (m, l, o) through shared memory at the end
// (M = max, each side rescaled by exp2(m - M)). Tile sizes, the split and
// the order of every sum depend on the program's shape (Sq, Sk, D, the
// mask) and the dtype only, never on the batch or the grid, so a row's
// result is bit-equal alone and in any batch. No atomics: the same inputs
// give the same bits. Softmax runs in base 2 (scale * log2 e folded into
// the logits), row max and sum over a quad by shuffles. The log-sum-exp:
// given an lse buffer (training asks for one), each row's
// ln sum_j exp(s_ij) is written beside o, one float a row, for the
// gradient kernel (flash_attention_bwd.cu) to rebuild P from; serving
// passes none and the kernel writes nothing more. FMA contraction is
// allowed in this library.
//
// The bf16 instances (flash_wgmma_kernel; tiles and wgmma in
// flash_wgmma.cuh, loads in flash_tma.cuh, as the gradient's):
// - A CTA is one or two consumer warpgroups and a producer warpgroup,
//   whose first warp loads: the CTA's Q tile once, then a ring of K/V
//   tile pairs of 64 keys; full and empty mbarriers hand each stage to
//   the warpgroup whose tile it holds and back. The producer gives its
//   registers back (setmaxnreg) to the consumers.
// - Two consumer warpgroups, the key groups, where the rows see more than
//   one key tile and the CTAs are few (Sq within one tile: whisper's
//   cross-attention has 48) or D > 128 (one CTA fills an SM); one CTA an
//   SM, six stages (three at D = 256). Otherwise one consumer warpgroup,
//   so that three CTAs (D <= 64, four stages) or two (D <= 128, three
//   stages) share an SM and overlap one another's first loads and last
//   stores: on the card, CTAs an SM gained more than stages (PERF.md).
// - Loads are TMA (a rank-4 map per operand, flash_tma.cuh) where q, k and
//   v are 16-byte aligned in base and strides; TMA writes zeros past S and
//   past D, so D pads to 64, 128 or 256 (16, 32 and 80 among them).
//   Otherwise (an unaligned view) the producer's lanes copy each element
//   into the same swizzled layout: a route chosen from the arguments.
// - S = Q K^T is wgmma m64n64k16 from the two shared-memory tiles, both
//   K-major, D / 16 steps. O += P V takes P, rounded to bf16 to nearest
//   even in registers, as the A operand and V MN-major from shared memory
//   as B (m64n64k16 at D = 64, m64n128k16 at D = 128, two of those at D =
//   256).
//   O accumulates across key tiles on the tensor cores, rescaled in
//   registers by exp2(m - m_new) before each product; the tensor cores'
//   additions truncate toward zero, as in the gradient, which moves O by
//   ~2^-23 a tile, far inside kernels/ref.py's flash_bf16_limit (2^-6
//   |want| + 2^-7 P.|V|, the room that rounding P to bf16 needs).
// - Overlap: tile n's S is issued before tile n - 1's P.V (two commit
//   groups), and tile n's exponentials (ex2.approx: a P below 2^-126
//   flushes to 0) run while that P.V is on the tensor cores; a row's max
//   and sum run as two chains each. A tile at the band's edge masks an
//   element by one range test against its row's visible keys.
// - The end: one reciprocal of l a row, then products (not D / 2
//   divisions a thread, which took a large share of a short CTA's time).
//
// The float32 instances (flash_kernel; tiles in flash_tiles.cuh, shared
// with the float32 gradient), which the predicates and the float32 gates
// run:
// - Tiles: a CTA of 8 warps owns 64 query rows of one program: 4 row
//   warps of 16 rows (one m16 row block) times the 2 key groups; where Sk
//   fits one tile (the predicates' S = 32) the CTA is the 4 row warps
//   alone, which gives the same sums. K/V tiles are 64 keys (32 at D =
//   128, 16 at D = 256); D is padded to DP (8, 16, ..., 256) with zeros.
// - Copies: Q and a two-stage ring of K/V tile pairs in shared memory,
//   filled by cp.async (16 bytes a thread, zero-filled past S and D): pair
//   t + 1 lands while pair t is computed, one __syncthreads a pair. Rows are
//   padded by 16 bytes so the fragment loads below hit 32 banks. Operands
//   that are not 16-byte aligned (a ragged D, odd strides) are copied
//   element by element instead. Tiles wholly outside the band are also
//   skipped per warp.
// - Products: mma.sync m16n8k8 TF32 with float32 accumulators, as
//   3xTF32: operands are split as hi = tf32(x), lo = tf32(x - hi) (tf32:
//   round to nearest, ties away, as cvt.rna.tf32.f32 does, in integer
//   operations that run at full rate), and a product is lo*hi' + hi*lo' +
//   hi*hi' (never one TF32 product: that keeps ~3 digits, enough to flip
//   the predicates' decisions). Both QK^T and P.V go this way; wgmma's
//   shared-memory B operand would need two more copies of every K and V
//   tile for the split, and the predicates' D = 8 and S = 32 are below
//   its 64-row, 32-byte-deep tiles. The tensor cores add into their
//   accumulator rounding toward zero, which over a long sum biases it; so
//   QK^T keeps the hi*hi' terms and the small lo terms in separate
//   accumulators, P.V sums each tile from zero, and those partial sums are
//   added in float32, rounding to nearest.
// - Softmax in registers, on the accumulator fragments: rescale by
//   exp2f(m - m_new). P feeds P.V from the same registers: the keys of
//   each 8-key step are taken in the order (0, 2, 4, 6 | 1, 3, 5, 7), so
//   the C fragment is the A fragment again and V's B fragment reads the
//   matching rows.

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "flash_tma.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash_tiles;

constexpr int kRowWarps = 4;              // 16 query rows each
constexpr int kMaxGroups = 2;             // key groups: even, odd tiles
constexpr int kGroupThreads = kRowWarps * 32;
constexpr int kBlockQ = kRowWarps * 16;   // query rows per CTA
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (programs, Sq) log-sum-exp of each row, or null
  Layout lq, lk, lv, lo;
  int heads, group, sq, sk, d, causal, window, programs, q_tiles, vec;
  int groups;        // key groups of a CTA: 2, or 1 where Sk fits a tile
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kMaxGroups * kGroupThreads)
flash_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = DP + 16 / (int)sizeof(T);
  constexpr int kTile = BK * RS;  // elements of one K or V tile
  T* s_q = reinterpret_cast<T*>(smem_raw);  // (kBlockQ, RS)
  const int groups = p.groups;
  const int threads = groups * kGroupThreads;
  T* s_k = s_q + kBlockQ * RS;  // 2 stages x groups tiles of (BK, RS)
  T* s_v = s_k + 2 * groups * kTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kRowWarps;  // which 16 rows
  const int kg = warp / kRowWarps;  // which key group
  const int g = lane >> 2;
  const int t = lane & 3;
  // the last query tile of every program first: those see the most keys
  const int rank = blockIdx.x / p.programs;
  const int prog = blockIdx.x - rank * p.programs;
  const int q_start = (p.q_tiles - 1 - rank) * kBlockQ;
  const int b = prog / p.heads;
  const int h = prog - b * p.heads;
  const int kh = h / p.group;
  const T* qb = static_cast<const T*>(p.q) + b * p.lq.batch + h * p.lq.head;
  const T* kb = static_cast<const T*>(p.k) + b * p.lk.batch + kh * p.lk.head;
  const T* vb = static_cast<const T*>(p.v) + b * p.lv.batch + kh * p.lv.head;
  T* ob = static_cast<T*>(p.o) + b * p.lo.batch + h * p.lo.head;
  const bool vec = p.vec != 0;

  // the TPU kernel's block test over this CTA's rows [q_start, q_last]:
  // key tiles (aligned to BK from key 0) that some row can see; key
  // group kg takes tiles kg, kg + 2, ...
  const int q_last = min(q_start + kBlockQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  const int k_begin =
      p.window > 0 ? max(0, q_start - p.window + 1) / BK * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int n_steps = (n_tiles + groups - 1) / groups;

  load_tile<T, DP, kBlockQ>(s_q, qb, p.lq.seq, q_start, p.sq, p.d, vec, tid,
                            threads);
  for (int grp = 0; grp < groups && grp < n_tiles; ++grp) {
    load_tile<T, DP, BK>(s_k + grp * kTile, kb, p.lk.seq, k_begin + grp * BK,
                         p.sk, p.d, vec, tid, threads);
    load_tile<T, DP, BK>(s_v + grp * kTile, vb, p.lv.seq, k_begin + grp * BK,
                         p.sk, p.d, vec, tid, threads);
  }
  cp_async_commit();

  const int row0 = q_start + rw * 16;  // this warp's rows
  const int qpos[2] = {row0 + g, row0 + g + 8};
  const int row_last = min(row0 + 15, p.sq - 1);
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step it has landed; step it - 1 is consumed
    if (it + 1 < n_steps) {
      T* nk = s_k + ((it + 1) & 1) * groups * kTile;
      T* nv = s_v + ((it + 1) & 1) * groups * kTile;
      for (int grp = 0; grp < groups; ++grp) {
        const int tile = (it + 1) * groups + grp;
        if (tile < n_tiles) {
          load_tile<T, DP, BK>(nk + grp * kTile, kb, p.lk.seq,
                               k_begin + tile * BK, p.sk, p.d, vec, tid,
                               threads);
          load_tile<T, DP, BK>(nv + grp * kTile, vb, p.lv.seq,
                               k_begin + tile * BK, p.sk, p.d, vec, tid,
                               threads);
        }
      }
    }
    cp_async_commit();
    const int tile = it * groups + kg;
    const int k_start = k_begin + tile * BK;
    // the same block test for this warp's 16 rows
    if (tile >= n_tiles || row0 >= p.sq ||
        (p.causal && k_start > row_last) ||
        (p.window > 0 && k_start + BK - 1 <= row0 - p.window))
      continue;
    const int slot = (it & 1) * groups + kg;
    const T* cur_k = s_k + slot * kTile;
    const T* cur_v = s_v + slot * kTile;

    float s[BK / 8][4];
    qk_tile<DP, BK>(s, s_q + rw * 16 * RS, cur_k, g, t);

    // logits in log2 units (scale * log2 e folded in), the masked ones
    // left out of the max and weighted exactly 0; a tile that every row
    // of this warp sees whole skips the per-key test
    const bool whole = k_start + BK <= p.sk &&
                       (!p.causal || k_start + BK - 1 <= row0) &&
                       (p.window <= 0 || k_start > row0 + 15 - p.window);
    uint64_t visible = ~0ull;
    if (!whole) {
      visible = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_start + j * 8 + 2 * t + (e & 1);
          const int i = qpos[e >> 1];
          if (kpos < p.sk && (!p.causal || kpos <= i) &&
              (p.window <= 0 || kpos > i - p.window))
            visible |= 1ull << (j * 4 + e);
        }
    }
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= p.scale_log2;
        if ((visible >> (j * 4 + e)) & 1)
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = tile_max[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (visible >> (j * 4 + e)) & 1 ? exp2f(s[j][e] - m[e >> 1])
                                               : 0.f;
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
    pv_tile<DP, BK>(o, s, cur_v, g, t, corr);
  }

  if (groups > 1) {
    // merge the odd tiles' (m, l, o) into the even tiles' through shared
    // memory: M = max, each side rescaled by exp2(m - M), then summed
    constexpr int kLaneFloats = DP / 2 + 4;
    float* mine = reinterpret_cast<float*>(s_k) + (rw * 32 + lane) *
                                                     kLaneFloats;
    __syncthreads();  // every warp is done with the ring
    if (kg == 1) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[n * 4 + e] = o[n][e];
      mine[DP / 2] = m[0];
      mine[DP / 2 + 1] = m[1];
      mine[DP / 2 + 2] = l[0];
      mine[DP / 2 + 3] = l[1];
    }
    __syncthreads();
    if (kg == 1) return;
    float f_mine[2], f_other[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_other = mine[DP / 2 + r];
      const float m_new = fmaxf(m[r], m_other);
      f_mine[r] = exp2f(m[r] - m_new);
      f_other[r] = exp2f(m_other - m_new);
      l[r] = l[r] * f_mine[r] + mine[DP / 2 + 2 + r] * f_other[r];
      m[r] = m_new;  // l is now relative to it (the log-sum-exp reads m)
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = o[n][e] * f_mine[e >> 1] + mine[n * 4 + e] * f_other[e >> 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (p.lse != nullptr && t == 0) {
    // the row's log-sum-exp of the scaled logits, ln 2 (m + log2 l) with m
    // and the logits in base 2; a row that sees no key gets +inf, so that
    // exp(s - lse) weighs its (masked) keys 0
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < p.sq)
        p.lse[(long long)prog * p.sq + qpos[r]] =
            l[r] == 0.f ? INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // no visible key -> 0
    T* orow = ob + qpos[r] * p.lo.seq;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d) store(orow + col, o[n][2 * r] / denom);
      if (col + 1 < p.d) store(orow + col + 1, o[n][2 * r + 1] / denom);
    }
  }
}

// Sk within one tile leaves the second key group nothing to do: one group
// then, which gives the same sums (an empty partner merges as exactly 0)
template <typename T, int DP, int BK>
int launch(Params p, int blocks, cudaStream_t stream) {
  constexpr int RS = DP + 16 / (int)sizeof(T);
  constexpr size_t kGroupRing = (size_t)4 * BK * RS * sizeof(T);
  constexpr size_t kMerge = (size_t)kRowWarps * 32 * (DP / 2 + 4) * 4;
  static_assert(kMerge <= kMaxGroups * kGroupRing,
                "the merge must fit in the ring");
  constexpr size_t kQ = (size_t)kBlockQ * RS * sizeof(T);
  constexpr size_t kMaxSmem = kQ + kMaxGroups * kGroupRing;
  static_assert(kMaxSmem <= 232448, "tiles exceed a block's shared memory");
  auto kernel = flash_kernel<T, DP, BK>;
  if (kMaxSmem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
  }
  p.groups = p.sk > BK ? kMaxGroups : 1;
  kernel<<<blocks, p.groups * kGroupThreads, kQ + p.groups * kGroupRing,
           stream>>>(p);
  return (int)cudaGetLastError();
}


// ---- the bf16 instances: wgmma fed by a TMA ring ------------------------

namespace wg = flash_wgmma;
using namespace flash_tma;
using wg::kRows;
static_assert(kRows == kBlockQ, "both designs take 64 query rows a CTA");

constexpr int kWgThreads = 128;   // a warpgroup: one key group's consumers
constexpr int kProducerRegs = 24;  // registers a producer thread keeps

struct WgParams {
  CUtensorMap mq, mk, mv;
  MapDims dq_, dk_, dv_;
  Params p;
  int tma;  // 1: tiles come by TMA; 0: by the producer's own loads
};

// every pair of the 64 x 64 block at (q0, k0) is visible: no element
// needs its mask
__device__ __forceinline__ bool block_full(const Params& p, int q0, int k0) {
  return q0 + kRows <= p.sq && k0 + kRows <= p.sk &&
         (!p.causal || k0 + kRows - 1 <= q0) &&
         (p.window <= 0 || k0 > q0 + kRows - 1 - p.window);
}

// one operand's rows as the producer loads them: its map, where the map
// keeps its dims, its rows' base and stride, and its head
struct Src {
  const CUtensorMap* map;
  MapDims dims;
  const __nv_bfloat16* base;
  long long stride;
  int head;
};

__device__ __forceinline__ const __nv_bfloat16* rows_of(const void* t,
                                                        const Layout& l,
                                                        int b, int h) {
  return static_cast<const __nv_bfloat16*>(t) + b * l.batch + h * l.head;
}

// the producer's hand-over of the tiles of N operands (one after the
// other from dst), rows pos0 .. pos0 + 63, on barrier `bar`, whose count
// is the warp's 32 lanes: lane 0 expects the TMA bytes and issues the
// loads, or every lane copies its share and fences its stores for
// wgmma's reads; every lane but TMA's issuer arrives
template <int DP, int N>
__device__ __forceinline__ void produce(const WgParams& w, unsigned char* dst,
                                        uint64_t* bar, const Src (&src)[N],
                                        int pos0, int n, int seq, int lane) {
  constexpr uint32_t kTile = kRows * DP * 2;
  if (w.tma) {
    if (lane == 0) {
      wg::mbar_arrive_tx(bar, N * kTile);
#pragma unroll
      for (int i = 0; i < N; ++i)
        tma_tile<DP>(dst + i * kTile, src[i].map, src[i].dims, bar, pos0,
                     src[i].head, seq);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      plain_tile<DP>(dst + i * kTile, src[i].base, src[i].stride, pos0, n,
                     w.p.d, lane);
    wg::fence_proxy_async();
  }
  if (!w.tma || lane != 0) wg::mbar_arrive(bar);
}

// the consumer warpgroups' own barrier (the producer has left by then)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// o for 64 query rows of one program: kGroups consumer warpgroups, the
// key tiles in turn (group g takes tiles g, g + kGroups, ...), and a
// producer warpgroup after them, whose first warp loads; kStages stages
// of K/V tile pairs; MINB the CTAs an SM should hold. The producer gives
// back all but kProducerRegs registers a thread, and the consumers take
// kConsumerRegs (a CTA launches with 16384 / (32 (kGroups + 1) MINB) a
// thread: an SM sub-partition's registers over the warps it holds)
template <int DP, int kGroups, int kStages, int MINB, int kConsumerRegs>
__global__ void __launch_bounds__((kGroups + 1) * kWgThreads, MINB)
flash_wgmma_kernel(const __grid_constant__ WgParams w) {
  // the 128-byte swizzle wants 1024-aligned tiles: the dynamic shared
  // memory's base is, so the tiles take no slack (two CTAs of the D = 128
  // instance fill an SM to its last 2 KB)
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  constexpr uint32_t kTile = kRows * DP * 2;
  constexpr int NO = DP < 128 ? DP : 128;  // o's columns a product writes
  constexpr int kHalves = DP / NO;
  constexpr int groups = kGroups;
  unsigned char* s_q = wg_smem;
  unsigned char* ring = s_q + kTile;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* own = empty + kStages;

  const Params& p = w.p;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = wg::warp_uniform();
  // the last query tile of every program first: those see the most keys
  const int rank = blockIdx.x / p.programs;
  const int prog = blockIdx.x - rank * p.programs;
  const int q0 = (p.q_tiles - 1 - rank) * kRows;
  const int b = prog / p.heads;
  const int h = prog - b * p.heads;
  const int kh = h / p.group;
  // the TPU kernel's block test over this CTA's rows [q0, q_last]: the key
  // tiles (aligned to 64 from key 0) that some row can see
  const int q_last = min(q0 + kRows, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  const int k_begin =
      p.window > 0 ? max(0, q0 - p.window + 1) / kRows * kRows : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kRows - 1) / kRows : 0;
  if (tid == 0) {
    if (wg::smem_u32(wg_smem) & 1023) __trap();
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], 4);
    }
    wg::mbar_init(own, 32);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * groups) {  // the producer warpgroup: its first warp loads
    wg::setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 * groups || n_tiles == 0) return;
    const Src q[1] = {{&w.mq, w.dq_, rows_of(p.q, p.lq, b, h), p.lq.seq, h}};
    const Src kv[2] = {
        {&w.mk, w.dk_, rows_of(p.k, p.lk, b, kh), p.lk.seq, kh},
        {&w.mv, w.dv_, rows_of(p.v, p.lv, b, kh), p.lv.seq, kh}};
    produce<DP>(w, s_q, own, q, q0, p.sq, b, lane);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      wg::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
      produce<DP>(w, ring + s * 2 * kTile, &full[s], kv, k_begin + n * kRows,
                  p.sk, b, lane);
    }
    return;
  }

  wg::setmaxnreg_inc<kConsumerRegs>();
  const int grp = warp >> 2;  // this warpgroup's key group
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + (warp & 3) * 16;  // this warp's 16 rows
  const int qpos[2] = {row0 + g, row0 + g + 8};
  const int n_mine =
      n_tiles > grp ? (n_tiles - grp + groups - 1) / groups : 0;
  // the keys [keys_lo, keys_hi) each of the thread's two rows sees (none
  // past Sq)
  int keys_lo[2], keys_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qpos[r];
    keys_lo[r] = p.window > 0 ? i - p.window + 1 : 0;
    keys_hi[r] = i >= p.sq ? 0 : p.causal ? min(p.sk, i + 1) : p.sk;
  }
  // a warpgroup accumulator holds, for each 8-column block j, rows (g, g,
  // g + 8, g + 8) and columns (2t, 2t + 1, 2t, 2t + 1) of the warp's rows
  float o[kHalves][NO / 2];
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int e = 0; e < NO / 2; ++e) o[hh][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  uint32_t pa[4][4];
  const uint32_t a_q = wg::smem_u32(s_q);
  if (n_mine > 0) wg::mbar_wait(own, 0);

  // step i takes tile n = grp + i groups in (its S and softmax) and
  // finishes the previous one (its P.V): S is issued first, and the
  // exponentials run while that P.V is on the tensor cores
  for (int i = 0; n_mine > 0 && i <= n_mine; ++i) {
    const bool take = i < n_mine;
    const int n = grp + i * groups;
    const int k0 = k_begin + n * kRows;
    const int st = n % kStages;
    const int prev = i > 0 ? (n - groups) % kStages : 0;
    if (take) wg::mbar_wait(&full[st], (n / kStages) & 1);
    const uint32_t a_k = wg::smem_u32(ring + st * 2 * kTile);
    const uint32_t a_v = wg::smem_u32(ring + prev * 2 * kTile) + kTile;
    wg::wgmma_fence();
    if (take) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wg::wgmma_ss_n64(s, wg::desc_k(a_q, ks), wg::desc_k(a_k, ks), ks);
      wg::wgmma_commit();
    }
    if (i > 0) {
#pragma unroll
      for (int c = 0; c < kRows / 16; ++c)
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          wg::wgmma_rs<NO>(o[hh], pa[c], wg::desc_mn(a_v, c, hh * NO));
      wg::wgmma_commit();
    }
    float corr[2] = {1.f, 1.f};
    if (take) {
      if (i > 0)
        wg::wgmma_wait<1>();  // S; the previous P.V still on the cores
      else
        wg::wgmma_wait<0>();
      wg::fence_regs(s);
      // logits in log2 units, a masked one -inf: out of the max, and its
      // exponential exactly 0
      // (each row's max and sum run as two chains, its 8-key blocks
      // j = e / 4 even and odd, so a step waits on half as many)
      float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
      if (block_full(p, q0, k0)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          s[e] *= p.scale_log2;
          float& x = mx[(e >> 1) & 1][(e >> 2) & 1];
          x = fmaxf(x, s[e]);
        }
      } else {
        // element e holds key k0 + 2t + c, c = 8 (e / 4) + e % 2: visible
        // when c lies in its row's [lo, hi)
        const int lo[2] = {keys_lo[0] - k0 - 2 * t, keys_lo[1] - k0 - 2 * t};
        const int hi[2] = {keys_hi[0] - k0 - 2 * t, keys_hi[1] - k0 - 2 * t};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + (e & 1);
          s[e] = c >= lo[r] && c < hi[r] ? s[e] * p.scale_log2 : -INFINITY;
          float& x = mx[r][(e >> 2) & 1];
          x = fmaxf(x, s[e]);
        }
      }
      float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(mx[r][0], mx[r][1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x);
        corr[r] = wg::ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = wg::ex2(s[e] - m[(e >> 1) & 1]);
        ps[(e >> 1) & 1][(e >> 2) & 1] += s[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r] + (ps[r][0] + ps[r][1]);
    }
    wg::wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) wg::fence_regs(o[hh]);
    wg::fence_regs(pa);
    if (i > 0) {  // the previous tile's stage goes back to the producer
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[prev]);
    }
    if (take) {
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
        for (int e = 0; e < NO / 2; ++e) o[hh][e] *= corr[(e >> 1) & 1];
      wg::to_a_frags(pa, s);
    }
  }

  if (groups > 1) {
    // merge the odd tiles' (m, l, o) into the even tiles' through shared
    // memory (the ring, whose tiles are all consumed): M = max, each side
    // rescaled by exp2(m - M), then summed
    float* buf = reinterpret_cast<float*>(ring) + (tid & (kWgThreads - 1));
    consumers_sync(groups * kWgThreads);
    if (grp == 1) {
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
        for (int e = 0; e < NO / 2; ++e)
          buf[(hh * NO / 2 + e) * kWgThreads] = o[hh][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        buf[(DP / 2 + r) * kWgThreads] = m[r];
        buf[(DP / 2 + 2 + r) * kWgThreads] = l[r];
      }
    }
    consumers_sync(groups * kWgThreads);
    if (grp == 1) return;
    float f_mine[2], f_other[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_other = buf[(DP / 2 + r) * kWgThreads];
      const float m_new = fmaxf(m[r], m_other);
      f_mine[r] = wg::ex2(m[r] - m_new);
      f_other[r] = wg::ex2(m_other - m_new);
      l[r] = l[r] * f_mine[r] + buf[(DP / 2 + 2 + r) * kWgThreads] * f_other[r];
      m[r] = m_new;  // l is now relative to it (the log-sum-exp reads m)
    }
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int e = 0; e < NO / 2; ++e)
        o[hh][e] = o[hh][e] * f_mine[(e >> 1) & 1] +
                   buf[(hh * NO / 2 + e) * kWgThreads] * f_other[(e >> 1) & 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (p.lse != nullptr && t == 0) {
    // the row's log-sum-exp of the scaled logits, ln 2 (m + log2 l); a
    // row that sees no key gets +inf, so exp(s - lse) weighs its keys 0
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < p.sq)
        p.lse[(long long)prog * p.sq + qpos[r]] =
            l[r] == 0.f ? INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + b * p.lo.batch + h * p.lo.head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.sq) continue;
    // one division a row, then products (no visible key -> 0)
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow = ob + qpos[r] * p.lo.seq;
    const bool pairs = (reinterpret_cast<uintptr_t>(orow) & 3) == 0;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int col = hh * NO + 8 * j + 2 * t;
        const float x0 = o[hh][4 * j + 2 * r] * inv;
        const float x1 = o[hh][4 * j + 2 * r + 1] * inv;
        if (pairs && col + 1 < p.d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < p.d) store(orow + col, x0);
          if (col + 1 < p.d) store(orow + col + 1, x1);
        }
      }
  }
}

// the bf16 instance at padded width DP with kGroups key groups and a ring
// of kStages stages; MINB the CTAs an SM should hold and kConsumerRegs
// the registers a consumer thread then takes
template <int DP, int kGroups, int kStages, int MINB, int kConsumerRegs>
int launch_wgmma(const WgParams& w, int blocks, cudaStream_t stream) {
  // an SM sub-partition holds one warp of each warpgroup of MINB CTAs, and
  // what the producer gives back pays for what the consumers take
  constexpr int kLaunchRegs = 16384 / (32 * (kGroups + 1) * MINB) / 8 * 8;
  static_assert(kGroups * (kConsumerRegs - kLaunchRegs) <=
                    kLaunchRegs - kProducerRegs,
                "the consumers take more registers than the producer frees");
  constexpr size_t kTile = (size_t)kRows * DP * 2;
  constexpr size_t kSmem =
      (1 + 2 * kStages) * kTile + (2 * kStages + 1) * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "tiles exceed a block's shared memory");
  static_assert(kGroups == 1 || (size_t)kWgThreads * (DP / 2 + 4) * 4 <=
                                    2 * kStages * kTile,
                "the merge must fit in the ring");
  auto kernel = flash_wgmma_kernel<DP, kGroups, kStages, MINB, kConsumerRegs>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<blocks, (kGroups + 1) * kWgThreads, kSmem, stream>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry point's arguments, packed by the caller (Python's struct
// format "<5Q12q9if", no padding): the five pointers (lse may be null);
// the element strides (between sequences, heads and positions) of q, k, v
// and o; the sizes, flags and the scale.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  Layout lq, lk, lv, lo;
  int batch, heads, group, sq, sk, d, causal, window, bf16;
  float scale;
};
static_assert(sizeof(FlashArgs) == 176, "FlashArgs must match <5Q12q9if");

namespace {

bool valid(const FlashArgs* a) {
  if (a->batch <= 0 || a->heads <= 0 || a->sq <= 0 || a->sk < 0 ||
      a->d <= 0 || a->d > kMaxHeadDim || a->group <= 0 ||
      a->heads % a->group != 0)
    return false;
  const long long programs = (long long)a->batch * a->heads;
  return programs * ((a->sq + kBlockQ - 1) / kBlockQ) <= INT_MAX;
}

Params params_of(const FlashArgs* a) {
  const long long programs = (long long)a->batch * a->heads;
  Params p{a->q,      a->k,      a->v,         a->o,
           static_cast<float*>(a->lse),                         a->lq,
           a->lk,     a->lv,     a->lo,        a->heads,      a->group,
           a->sq,     a->sk,     a->d,         a->causal,     a->window,
           (int)programs, (a->sq + kBlockQ - 1) / kBlockQ, 0, 1,
           (float)(a->scale * 1.4426950408889634)};
  const size_t elem = a->bf16 ? 2 : 4;
  p.vec = a->d % (16 / elem) == 0 && aligned16(a->q, a->lq, elem) &&
          aligned16(a->k, a->lk, elem) && aligned16(a->v, a->lv, elem);
  return p;
}

// the bf16 instances' parameters: TMA maps of q, k and v where every one
// is aligned and cuTensorMapEncodeTiled accepts it, else the producer's
// own loads
void wg_params(WgParams* w, const FlashArgs* a) {
  w->p = params_of(a);
  const int kv_heads = a->heads / a->group;
  w->tma = w->p.vec && a->sk > 0 &&
           encode(&w->mq, &w->dq_, a->q, a->lq, a->batch, a->heads, a->sq,
                  a->d) &&
           encode(&w->mk, &w->dk_, a->k, a->lk, a->batch, kv_heads, a->sk,
                  a->d) &&
           encode(&w->mv, &w->dv_, a->v, a->lv, a->batch, kv_heads, a->sk,
                  a->d);
}

}  // namespace

// q, o: (batch, heads, Sq, D) and k, v: (batch, heads / group, Sk, D),
// each addressed by its own strides with the last dimension contiguous;
// float32 (bf16 == 0) or bfloat16 (bf16 == 1), o in q's type. Program p =
// b * heads + h reads kv head h / group of sequence b. A non-null lse is
// a contiguous float32 (batch * heads, Sq): row i of program p gets
// ln sum_j exp(s_ij) over its visible keys (+inf where it sees none), the
// statistic the gradient kernel (flash_attention_bwd.cu) needs; without
// it the kernel writes only o. 1 <= D <= 256,
// group divides heads, Sk >= 0. Returns cudaGetLastError() after the
// launch; the caller raises if it is not cudaSuccess.
extern "C" int flash_attention_bshd(const FlashArgs* a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((long long)a->batch * a->heads *
                           ((a->sq + kBlockQ - 1) / kBlockQ));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = a->d;
  if (a->bf16) {
    WgParams w;
    wg_params(&w, a);
    // two key groups where a CTA's rows see more than one key tile and
    // the CTAs are few (Sq within one tile: cross-attention) or heavy (D >
    // 128, where one CTA fills an SM); else one, and two or three CTAs an
    // SM overlap one another's first loads and last stores
    if (a->sk > kRows && (a->sq <= kRows || d > 128)) {
      if (d <= 64) return launch_wgmma<64, 2, 6, 1, 240>(w, blocks, s);
      if (d <= 128) return launch_wgmma<128, 2, 6, 1, 240>(w, blocks, s);
      return launch_wgmma<256, 2, 3, 1, 240>(w, blocks, s);
    }
    if (d <= 64) return launch_wgmma<64, 1, 4, 3, 136>(w, blocks, s);
    if (d <= 128) return launch_wgmma<128, 1, 3, 2, 232>(w, blocks, s);
    return launch_wgmma<256, 1, 3, 2, 232>(w, blocks, s);
  }
  const Params p = params_of(a);
  if (d <= 8) return launch<float, 8, 64>(p, blocks, s);
  if (d <= 16) return launch<float, 16, 64>(p, blocks, s);
  if (d <= 32) return launch<float, 32, 64>(p, blocks, s);
  if (d <= 64) return launch<float, 64, 64>(p, blocks, s);
  if (d <= 128) return launch<float, 128, 32>(p, blocks, s);
  return launch<float, 256, 16>(p, blocks, s);
}

// which design flash_attention_bshd takes for these arguments: 2 the bf16
// wgmma instances with TMA loads, 1 with the producer's own loads, 0 the
// float32 mma.sync instances; -1 for arguments it refuses. Launches
// nothing.
extern "C" int flash_attention_route(const FlashArgs* a) {
  if (!valid(a)) return -1;
  if (!a->bf16) return 0;
  WgParams w;
  wg_params(&w, a);
  return w.tma ? 2 : 1;
}
