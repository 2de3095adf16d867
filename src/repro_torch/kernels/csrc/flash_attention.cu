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
// Bound: operations. At long S the S^2 products dominate (at bench_kernels'
// (1, 1024, 8, 2, 64) causal: ~0.27 GFLOP on ~2.6 MB), and on this card
// the products go to the tensor cores: bf16 at 989 TFLOP/s, and float32
// at a third of TF32's 495 TFLOP/s, because every float32 product is
// three TF32 products (below). At the predicate's S = 32, D = 8 the work
// is a few dependent steps inside one CTA: latency.
//
// Design.
// - Tiles: a CTA of 8 warps owns 64 query rows of one program: 4 row
//   warps of 16 rows (one m16 row block) times 2 key groups, the first
//   taking the even K/V tiles and the second the odd ones, their (m, l,
//   o) merged at the end through shared memory. So a heavy query tile's
//   keys take half as long and an SM holds 8 warps, not 4. Where Sk fits
//   one tile (the predicates' S = 32) the CTA is the 4 row warps alone,
//   which gives the same sums. K/V tiles are
//   BK = 64 keys (float32: 32 at D = 128, 16 at D = 256; bf16: 32 at D =
//   256); D is padded to DP (8, 16, ..., 256; 16 at least for bf16) with
//   zeros. Tile sizes and the order in which a row's keys are summed
//   depend on D and the dtype only, never on the batch or the grid, so a
//   row's result is bit-equal alone and in any batch.
// - Copies: Q and a two-stage ring of K/V tile pairs in shared memory,
//   filled by cp.async (16 bytes a thread, zero-filled past S and D): pair
//   t + 1 lands while pair t is computed, one __syncthreads a pair. Rows are
//   padded by 16 bytes so the fragment loads below hit 32 banks. Operands
//   that are not 16-byte aligned (a ragged D, odd strides) are copied
//   element by element instead.
// - Products: mma.sync on the tensor cores, m16n8k8 TF32 for float32 and
//   m16n8k16 bf16 for bf16, both with float32 accumulators. mma.sync was
//   taken over wgmma: the float32 path splits each operand in registers
//   (below), which wgmma's shared-memory B operand would need as two more
//   copies of every K and V tile, and the predicates' D = 8 and S = 32
//   are below wgmma's 64-row, 32-byte-deep tiles.
// - 3xTF32: float32 operands are split as hi = tf32(x), lo = tf32(x -
//   hi) (tf32: round to nearest, ties away, as cvt.rna.tf32.f32 does, in
//   integer operations that run at full rate), and a product is lo*hi' +
//   hi*lo' + hi*hi' (never one TF32 product: that keeps ~3 digits, enough
//   to flip the predicates' decisions). Both QK^T and P.V go this way. The
//   tensor cores add into their accumulator rounding toward zero, which
//   over a long sum biases it; so QK^T keeps the hi*hi' terms and the
//   small lo terms in separate accumulators, P.V sums each tile from zero,
//   and those partial sums are added in float32, rounding to nearest.
// - Softmax in registers, on the accumulator fragments, in base 2 (scale
//   * log2 e folded into the logits): row max and sum over a quad by
//   shuffles, rescale by exp2(m - m_new). P feeds P.V from
//   the same registers: for bf16 the m16n8k16 A fragment is the QK^T C
//   fragment; for TF32 the keys of each 8-key step are taken in the order
//   (0, 2, 4, 6 | 1, 3, 5, 7), so the C fragment is the A fragment again
//   and V's B fragment reads the matching rows.
// - Work order: tiles wholly outside the causal or window band are
//   skipped per CTA (and per warp); the late (heavy) query tiles of every
//   program launch first.
// - The log-sum-exp: given an lse buffer (training asks for one), each
//   row's ln sum_j exp(s_ij) is written beside o, one float a row, for the
//   gradient kernel (flash_attention_bwd.cu) to rebuild P from; serving
//   passes none and the kernel writes nothing more.
// - The tile helpers (copies, the 3xTF32 split, the QK^T and P.V tiles)
//   live in flash_tiles.cuh, shared with the gradient kernel.
// - FMA contraction is allowed in this library.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

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
  if (a->batch <= 0 || a->heads <= 0 || a->sq <= 0 || a->sk < 0 ||
      a->d <= 0 || a->d > kMaxHeadDim || a->group <= 0 ||
      a->heads % a->group != 0)
    return (int)cudaErrorInvalidValue;
  const long long programs = (long long)a->batch * a->heads;
  const long long q_tiles = (a->sq + kBlockQ - 1) / kBlockQ;
  if (programs * q_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  Params p{a->q,      a->k,      a->v,         a->o,
           static_cast<float*>(a->lse),                         a->lq,
           a->lk,     a->lv,     a->lo,        a->heads,      a->group,
           a->sq,     a->sk,     a->d,         a->causal,     a->window,
           (int)programs, (int)q_tiles, 0, 1,
           (float)(a->scale * 1.4426950408889634)};
  const size_t elem = a->bf16 ? 2 : 4;
  p.vec = a->d % (16 / elem) == 0 && aligned16(a->q, a->lq, elem) &&
          aligned16(a->k, a->lk, elem) && aligned16(a->v, a->lv, elem);
  const int blocks = (int)(programs * q_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = a->d;
  if (a->bf16) {
    if (d <= 16) return launch<__nv_bfloat16, 16, 64>(p, blocks, s);
    if (d <= 32) return launch<__nv_bfloat16, 32, 64>(p, blocks, s);
    if (d <= 64) return launch<__nv_bfloat16, 64, 64>(p, blocks, s);
    if (d <= 128) return launch<__nv_bfloat16, 128, 64>(p, blocks, s);
    return launch<__nv_bfloat16, 256, 32>(p, blocks, s);
  }
  if (d <= 8) return launch<float, 8, 64>(p, blocks, s);
  if (d <= 16) return launch<float, 16, 64>(p, blocks, s);
  if (d <= 32) return launch<float, 32, 64>(p, blocks, s);
  if (d <= 64) return launch<float, 64, 64>(p, blocks, s);
  if (d <= 128) return launch<float, 128, 32>(p, blocks, s);
  return launch<float, 256, 16>(p, blocks, s);
}
