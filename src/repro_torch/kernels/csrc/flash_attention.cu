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
// Three designs: float32 takes one, bf16 one of two by shape;
// flash_attention_route says which a call takes. Each gives 64 query rows
// of one program to a warp group (a CTA's or a warpgroup's) and walks the
// key tiles (aligned to 64 from key 0) that the TPU kernel's block test
// lets some of those rows see: tiles wholly outside the causal or window
// band are skipped, tiles wholly inside it skip the per-element test, and
// the late (heavy) query tiles of every program go first. The float32 and
// the bf16 design of a CTA a query tile may split a CTA's key tiles between
// two key groups (the even and the odd tiles) and merge the groups' (m, l,
// o) through shared memory at the end (M = max, each side rescaled by
// exp2(m - M)). Tile sizes, the split and the order of every sum depend on
// the program's shape (Sq, Sk, D, the mask, the kv group) and the dtype
// only, never on the batch, the grid or which CTA took the rows, so a
// row's result is bit-equal alone and in any batch. No atomics: the same
// inputs give the same bits. Softmax runs in base 2 (scale * log2 e folded
// into the logits), row max and sum over a quad by shuffles. The
// log-sum-exp: given an lse buffer (training asks for one), each row's
// ln sum_j exp(s_ij) is written beside o, one float a row, for the
// gradient kernel (flash_attention_bwd.cu) to rebuild P from; serving
// passes none and the kernel writes nothing more. FMA contraction is
// allowed in this library.
//
// The bf16 design of a CTA a query tile (flash_wgmma_kernel; tiles and
// wgmma in flash_wgmma.cuh, loads in flash_tma.cuh, as the gradient's),
// routed only where the kv group is 1 and Sq fits one query tile (whisper's
// cross-attention), where the shared design would leave a warpgroup
// idle; flash_attention_variant runs it at any shape:
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
// The bf16 shared design (flash_shared_kernel), every bf16 call but
// whisper's cross-attention shape and D <= 64 at kv groups three
// warpgroups do not divide. The q heads of a kv group read the same K/V
// tiles, and a CTA a query tile pays for its barriers, its first load and
// its last store on every 64 rows: so a persistent CTA has two or three
// consumer warpgroups of 64 query rows that share every K/V stage:
// - (a) Shared stages. Where the kv group is 2 or more, the warpgroups of
//   a CTA take consecutive q heads of one kv head at the same positions
//   (the same causal or window band); at group 1, consecutive query tiles
//   of one head (bands that may differ: a warpgroup steps idle through a
//   tile outside its own). The producer loads each K/V tile once for all,
//   and a stage goes back once every warpgroup has read it. Three
//   warpgroups at D <= 128, two at D = 256 (O alone is 128 registers a
//   thread); a head block past the group's last head leaves a warpgroup
//   idle (arctic's 7 heads: three blocks of three).
// - Key tiles of 128 at D <= 64 (S by m64n128k16): at D = 64 a visible
//   pair costs as much on the special-function units (one ex2) as on the
//   tensor cores (4 D flops), and a step's chain (S's latency, the max
//   across a quad, the rescale, the waits) is paid per tile; 128 keys a
//   step halve it. The tiles are aligned to 128 from key 0, which at the
//   causal edge leaves up to 64 more keys masked.
// - (b) Ping-pong, measured and removed: named barriers passing a turn
//   round the warpgroups, each issuing tile n's S and tile n - 1's P.V in
//   its turn and running its exponentials while the others' products ran,
//   made every model shape slower on the card (PERF.md); the warpgroups
//   issue freely.
// - (c) One FFMA an exponential: the row max is taken on the raw logits
//   (the scale is positive), and p = ex2(fma(s, scale log2 e, -m)); O's
//   rescale is skipped where no row of a warp moved its max. Polynomial
//   exponentials on the FMA pipe are not tried.
// - (d) Persistent CTAs: one CTA an SM, as many as the SMs, each walking a
//   static list of work units (query rank, sequence, kv head, head block):
//   heaviest first, in passes over the CTAs that alternate direction, each
//   unit decoded once (unit_of). Barriers are set up and
//   the TMA maps prefetched once a CTA; Q comes in two buffers, so a unit's
//   Q tiles load during the last unit (with one buffer, at D = 256 and for
//   three warpgroups at D = 128, a unit's first K/V tiles go out first and
//   each Q tile as soon as its warpgroup has finished the last unit's
//   products, during its epilogue).
// - (e) The epilogue: at D <= 128 through a swizzled O tile a warpgroup in
//   shared memory and one TMA store where o is 16-byte aligned (rows past
//   Sq and columns past D are clipped by the map); elsewhere, and at D =
//   256 where no O tile fits beside Q and two stages, 16-byte stores after
//   a quad's lanes trade their column pairs by shuffles (pairs or single
//   elements for views that are not aligned).
// D = 256 takes (a), (c), (d) with one Q buffer and (e) without its TMA
// store. A row's bits depend on its design, and the design on the shape
// (never the batch); the shared design's instances of one tile width give
// the same bits, whichever slot takes a row.
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
  CUtensorMap mq, mk, mv, mo;
  MapDims dq_, dk_, dv_, do_;
  Params p;
  int tma;        // 1: tiles come by TMA; 0: by the producer's own loads
  int tma_store;  // 1: o leaves by TMA from shared memory (mo; shared)
  int o_vec;      // 1: o is 16-byte aligned in base and strides, D % 8 == 0
  // the shared design's static schedule (slot_at): work units, units
  // of one query rank, head blocks of a kv head
  int units, per_rank, hblocks;
};

// The tick probe, built with -DFLASH_PROBE only (chip_smoke.py's probe
// library; the shipped instances compile it out): thread 0 of a CTA adds
// the clock64 ticks of each stretch of its chain to one of kLaps counters
// and at its end writes them, then their total, to flash_probe_ticks.
// (kStageWait: waiting for a tile's K/V stage)
enum Lap { kSetup, kQWait, kStageWait, kSWait, kSoftmax, kPvWait, kEpilogue,
           kLaps };
#ifdef FLASH_PROBE
constexpr int kProbeCtas = 16384;
__device__ long long flash_probe_ticks[kProbeCtas * (kLaps + 1)];
struct Probe {
  long long t0, last, acc[kLaps];
  __device__ __forceinline__ Probe() {
#ifdef __CUDA_ARCH__
    t0 = last = clock64();
#pragma unroll
    for (int i = 0; i < kLaps; ++i) acc[i] = 0;
#endif
  }
  __device__ __forceinline__ void lap(int i) {
#ifdef __CUDA_ARCH__
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
#endif
  }
  __device__ __forceinline__ void write() const {
#ifdef __CUDA_ARCH__
    if (threadIdx.x != 0 || blockIdx.x >= kProbeCtas) return;
    long long* out = flash_probe_ticks + blockIdx.x * (kLaps + 1);
#pragma unroll
    for (int i = 0; i < kLaps; ++i) out[i] = acc[i];
    out[kLaps] = clock64() - t0;
#endif
  }
};
#else
struct Probe {
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void write() const {}
};
#endif

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
  Probe probe;
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
  probe.lap(kSetup);

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
  probe.lap(kQWait);

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
    probe.lap(kStageWait);
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
      probe.lap(kSWait);
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
      probe.lap(kSoftmax);
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
    probe.lap(kPvWait);
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
  probe.lap(kEpilogue);
  probe.write();
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

// ---- the bf16 shared design: warpgroups that share each K/V stage ----

// named barriers beside __syncthreads (0) and consumers_sync (1): warpgroup
// w's own 128 threads (kOwnBar + w, its epilogue)
constexpr int kOwnBar = 2;
// registers a producer thread of the shared design keeps: its unit
// schedule wants more than the design of a CTA a query tile's 24
constexpr int kSharedProducerRegs = 40;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a swizzled tile of 64 rows in shared memory to coordinates (c0 .. c3) of
// a rank-4 map (positions past the map's bounds are not written), in one
// bulk group of the calling thread
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the calling thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until they are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// v[i] for a lane-dependent i, by selects (an indexed register array
// would go to local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// the key tiles of BN keys (aligned to BN from key 0) that some row of
// [q0, q0 + 64) can see, by the TPU kernel's block test: [kb, kb + BN nt)
template <int BN>
__device__ __forceinline__ void tiles_seen(const Params& p, int q0, int& kb,
                                           int& nt) {
  const int q_last = min(q0 + kRows, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  kb = p.window > 0 ? max(0, q0 - p.window + 1) / BN * BN : 0;
  nt = k_end > kb ? (k_end - kb + BN - 1) / BN : 0;
}

// every pair of the 64 x BN block at (q0, k0) is visible: no element
// needs its mask
template <int BN>
__device__ __forceinline__ bool band_full(const Params& p, int q0, int k0) {
  return q0 + kRows <= p.sq && k0 + BN <= p.sk &&
         (!p.causal || k0 + BN - 1 <= q0) &&
         (p.window <= 0 || k0 > q0 + kRows - 1 - p.window);
}

// Warpgroup s's share of work unit u: 64 query rows from q0 of head h of
// sequence b, and their key tiles [kb, kb + BN nt); none where !valid (a
// slot past the kv group's heads or the program's query tiles: h and q0
// then name rows that exist, which the producer loads and nobody uses).
// Units run heaviest first: rank r takes query tile Sq / 64 - 1 - r of
// every program. Where the kv group is 2 or more, the W warpgroups of a
// unit take W consecutive q heads of one kv head (head block j: heads
// j W .. j W + W - 1 of the group) at the same positions, so all have the
// same band; at group 1, W consecutive query tiles of one head.
struct Slot {
  int b, h, kh, q0, kb, nt;
  bool valid;
};

// what the slots of unit u share, decoded once a unit (the divisions):
// its rank, sequence b, kv head kh and its first slot's index i0 (a head
// of the kv group at group 2 and up, else a query tile's rank) and head h0
struct Unit {
  int rank, b, kh, i0, h0;
};

__device__ __forceinline__ Unit unit_of(const WgParams& w, int u, int W) {
  const Params& p = w.p;
  Unit n;
  n.rank = u / w.per_rank;
  const int r = u - n.rank * w.per_rank;
  if (p.group > 1) {
    const int bk = r / w.hblocks;  // b * kv_heads + kv head
    const int kv_heads = p.heads / p.group;
    n.b = bk / kv_heads;
    n.kh = bk - n.b * kv_heads;
    n.i0 = (r - bk * w.hblocks) * W;
    n.h0 = n.kh * p.group;
  } else {
    n.b = r / p.heads;
    n.kh = n.h0 = r - n.b * p.heads;
    n.i0 = n.rank * W;
  }
  return n;
}

template <int W, int BN>
__device__ __forceinline__ Slot slot_at(const WgParams& w, const Unit& n,
                                        int s) {
  const Params& p = w.p;
  Slot o;
  o.b = n.b;
  o.kh = n.kh;
  if (p.group > 1) {
    const int i = n.i0 + s;
    o.valid = i < p.group;
    o.h = n.h0 + min(i, p.group - 1);
    o.q0 = (p.q_tiles - 1 - n.rank) * kRows;
  } else {
    o.h = n.h0;
    const int qt = p.q_tiles - 1 - (n.i0 + s);
    o.valid = qt >= 0;
    o.q0 = max(qt, 0) * kRows;
  }
  tiles_seen<BN>(p, o.q0, o.kb, o.nt);
  if (!o.valid) o.nt = 0;
  return o;
}

// the key tiles of unit u: the union [kb, kb + BN nt) of its slots'
// bands, which the producer loads once for all of them
template <int W, int BN>
__device__ __forceinline__ void unit_band(const WgParams& w, const Unit& un,
                                          int& kb, int& nt) {
  int lo = INT_MAX, hi = 0;
#pragma unroll
  for (int s = 0; s < W; ++s) {
    const Slot x = slot_at<W, BN>(w, un, s);
    if (x.nt > 0) {
      lo = min(lo, x.kb);
      hi = max(hi, x.kb + x.nt * BN);
    }
  }
  kb = hi > lo ? lo : 0;
  nt = hi > lo ? (hi - lo) / BN : 0;
}

// the k-th unit of this CTA, or one past the last: the units go round the
// CTAs heaviest first in passes of gridDim.x, each pass in the other
// direction (snake order), so a CTA that took one of the heaviest units of
// a pass takes one of the lightest of the next
__device__ __forceinline__ int unit_index(int k) {
  const int c = k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return k * gridDim.x + c;
}

// the producer's hand-over of a K/V stage: BN rows from pos0 of K, then of
// V, each as BN / 64 tiles of 64 rows one after the other (at D = 64 a
// tile of BN rows in the 128-byte swizzle), on barrier `bar` as produce
template <int DP, int BN>
__device__ __forceinline__ void produce_kv(const WgParams& w,
                                           unsigned char* dst, uint64_t* bar,
                                           const Src (&src)[2], int pos0,
                                           int n, int seq, int lane) {
  constexpr uint32_t kTile = kRows * DP * 2;
  constexpr int kParts = BN / kRows;
  if (w.tma) {
    if (lane == 0) {
      wg::mbar_arrive_tx(bar, 2 * kParts * kTile);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < kParts; ++c)
          tma_tile<DP>(dst + (i * kParts + c) * kTile, src[i].map,
                       src[i].dims, bar, pos0 + c * kRows, src[i].head, seq);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < kParts; ++c)
        plain_tile<DP>(dst + (i * kParts + c) * kTile, src[i].base,
                       src[i].stride, pos0 + c * kRows, n, w.p.d, lane);
    wg::fence_proxy_async();
  }
  if (!w.tma || lane != 0) wg::mbar_arrive(bar);
}

// d = A . B^T (acc 0) or d += A . B^T (acc 1): A (64 x 16) and B (128 x
// 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// S = Q K^T over BN keys: m64n64k16 or m64n128k16
template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  wg::wgmma_ss_n64(d, da, db, acc);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  wgmma_ss_n128(d, da, db, acc);
}

// P's A fragments for P.V, BN / 16 k-steps (flash_wgmma::to_a_frags at BN
// = 64): columns 16 c .. 16 c + 15 of the accumulator, rounded to bf16
template <int BN>
__device__ __forceinline__ void to_frags(uint32_t (&a)[BN / 16][4],
                                         const float (&s)[BN / 2]) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(s[8 * c + 2 * j], s[8 * c + 2 * j + 1]);
      a[c][j] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// the producer's loads of unit u's W Q tiles into one of the Q buffers
// (its tiles at s_q, its barriers at q_full and q_empty), each once its
// warpgroup is done with the buffer's last unit (the buffer's use-th)
template <int DP, int W, int BN>
__device__ __forceinline__ void produce_q(const WgParams& w, const Unit& un,
                                          int use,
                                          unsigned char* s_q, uint64_t* q_full,
                                          uint64_t* q_empty, int lane) {
  constexpr uint32_t kTile = kRows * DP * 2;
  const Params& p = w.p;
#pragma unroll
  for (int s = 0; s < W; ++s) {
    const Slot x = slot_at<W, BN>(w, un, s);
    const Src q[1] = {
        {&w.mq, w.dq_, rows_of(p.q, p.lq, x.b, x.h), p.lq.seq, x.h}};
    wg::mbar_wait(&q_empty[s], (use & 1) ^ 1);
    produce<DP>(w, s_q + s * kTile, &q_full[s], q, x.q0, p.sq, x.b, lane);
  }
}

// o for the work units of a persistent CTA (unit_index): W consumer
// warpgroups, each 64 query rows of a unit
// (slot_at), and a producer warpgroup after them whose first warp loads,
// unit by unit, the key tiles of the unit's band into a ring of kStages
// K/V stages (each stage read by all W warpgroups and handed back once all
// have read it) and the W Q tiles into one of kQBufs buffers: with two,
// the unit's Q first; with one, the first kStages K/V tiles of a unit go
// out before its Q tiles, so they land while the warpgroups finish the
// last unit, and each Q tile as soon as its warpgroup has freed it (before
// its epilogue). Every warpgroup steps through all of its unit's tiles,
// idle on those outside its band. kStoreTma: o leaves through shared
// memory (a tile a warpgroup) by TMA where it is aligned (w.tma_store).
// The producer keeps kProducerKeeps registers a thread and the consumers
// take kConsumerRegs (launch_shared).
template <int DP, int BN, int W, int kStages, int kQBufs, int kConsumerRegs,
          int kProducerKeeps, bool kStoreTma>
__global__ void __launch_bounds__((W + 1) * kWgThreads, 1)
flash_shared_kernel(const __grid_constant__ WgParams w) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  static_assert(BN == kRows || (BN == 2 * kRows && DP == 64),
                "128-key tiles only where a row is one 128-byte panel");
  constexpr uint32_t kTile = kRows * DP * 2;  // a Q or O tile
  constexpr uint32_t kKv = BN * DP * 2;       // a K or V tile
  constexpr int NO = DP < 128 ? DP : 128;  // o's columns a product writes
  constexpr int kHalves = DP / NO;
  // Q buffer qb: warpgroup s's Q tile at (qb W + s) kTile; unit k of the
  // CTA takes buffer k % kQBufs
  unsigned char* s_q = wg_smem;
  unsigned char* ring = s_q + kQBufs * W * kTile;  // stage s: K, then V
  unsigned char* s_o = ring + kStages * 2 * kKv;    // kStoreTma: O tiles
  uint64_t* full =
      reinterpret_cast<uint64_t*>(s_o + (kStoreTma ? W * kTile : 0));
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + kQBufs * W;

  const Params& p = w.p;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = wg::warp_uniform();
  Probe probe;
  if (tid == 0) {
    if (wg::smem_u32(wg_smem) & 1023) __trap();
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], 4 * W);
    }
    for (int s = 0; s < kQBufs * W; ++s) {
      wg::mbar_init(&q_full[s], 32);
      wg::mbar_init(&q_empty[s], 4);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  probe.lap(kSetup);

  if (warp >= 4 * W) {  // the producer warpgroup: its first warp loads
    wg::setmaxnreg_dec<kProducerKeeps>();
    if (warp != 4 * W) return;
    if (w.tma && lane == 0) {
      prefetch_map(&w.mq);
      prefetch_map(&w.mk);
      prefetch_map(&w.mv);
    }
    int it = 0;  // K/V tiles loaded so far: tile it takes stage it % kStages
    for (int k = 0, u = unit_index(0); u < w.units; u = unit_index(++k)) {
      const Unit un = unit_of(w, u, W);
      int kb, nt;
      unit_band<W, BN>(w, un, kb, nt);
      const Slot x0 = slot_at<W, BN>(w, un, 0);
      const Src kv[2] = {
          {&w.mk, w.dk_, rows_of(p.k, p.lk, x0.b, x0.kh), p.lk.seq, x0.kh},
          {&w.mv, w.dv_, rows_of(p.v, p.lv, x0.b, x0.kh), p.lv.seq, x0.kh}};
      // with one Q buffer, the unit's first K/V tiles go out before its Q
      // tiles (which wait for the last unit's products); with two, Q first
      const int qb = k % kQBufs;
      const int early = kQBufs > 1 ? 0 : min(nt, kStages);
      for (int n = 0; n < nt; ++n) {
        if (n == early)
          produce_q<DP, W, BN>(w, un, k / kQBufs, s_q + qb * W * kTile,
                               q_full + qb * W, q_empty + qb * W, lane);
        const int st = (it + n) % kStages;
        wg::mbar_wait(&empty[st], (((it + n) / kStages) & 1) ^ 1);
        produce_kv<DP, BN>(w, ring + st * 2 * kKv, &full[st], kv,
                           kb + n * BN, p.sk, x0.b, lane);
      }
      if (nt == early)
        produce_q<DP, W, BN>(w, un, k / kQBufs, s_q + qb * W * kTile,
                             q_full + qb * W, q_empty + qb * W, lane);
      it += nt;
    }
    return;
  }

  wg::setmaxnreg_inc<kConsumerRegs>();
  const int wi = warp >> 2;  // this warpgroup: slot wi of every unit
  const int g = lane >> 2;
  const int t = lane & 3;
  const float c = p.scale_log2;
  int it = 0;  // K/V tiles consumed so far, as the producer counts them
  for (int k = 0, u = unit_index(0); u < w.units; u = unit_index(++k)) {
    const Unit un = unit_of(w, u, W);
    int kb, nt;
    unit_band<W, BN>(w, un, kb, nt);
    const Slot me = slot_at<W, BN>(w, un, wi);
    // this warpgroup's tiles of the unit's: [mine_lo, mine_hi)
    const int mine_lo = me.nt > 0 ? (me.kb - kb) / BN : 0;
    const int mine_hi = me.nt > 0 ? mine_lo + me.nt : 0;
    const int row0 = me.q0 + (warp & 3) * 16;  // this warp's 16 rows
    const int qpos[2] = {row0 + g, row0 + g + 8};
    // the keys [keys_lo, keys_hi) each of the thread's two rows sees
    int keys_lo[2], keys_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = qpos[r];
      keys_lo[r] = p.window > 0 ? i - p.window + 1 : 0;
      keys_hi[r] = i >= p.sq ? 0 : p.causal ? min(p.sk, i + 1) : p.sk;
    }
    float o[kHalves][NO / 2];
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int e = 0; e < NO / 2; ++e) o[hh][e] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // the running max, in log2 units
    float l[2] = {0.f, 0.f};          // this lane's share of the row sums
    float s[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
    uint32_t pa[BN / 16][4];
    const int qi = k % kQBufs * W + wi;  // this unit's Q tile and barriers
    const uint32_t a_q = wg::smem_u32(s_q + qi * kTile);
    wg::mbar_wait(&q_full[qi], (k / kQBufs) & 1);
    probe.lap(kQWait);

    // step i takes tile i in (its S and softmax) and finishes tile i - 1
    // (its P.V), where they are this warpgroup's; S is issued first, and
    // the exponentials run while that P.V and the other warpgroups'
    // products are on the tensor cores
    for (int i = 0; nt > 0 && i <= nt; ++i) {
      const bool take = i >= mine_lo && i < mine_hi;
      const bool prev = i - 1 >= mine_lo && i - 1 < mine_hi;
      const int st = (it + i) % kStages;
      const int pst = (it + i + kStages - 1) % kStages;
      if (i < nt) wg::mbar_wait(&full[st], ((it + i) / kStages) & 1);
      const uint32_t a_k = wg::smem_u32(ring + st * 2 * kKv);
      const uint32_t a_v = wg::smem_u32(ring + pst * 2 * kKv) + kKv;
      probe.lap(kStageWait);
      wg::wgmma_fence();
      if (take) {
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks)
          wgmma_ss<BN>(s, wg::desc_k(a_q, ks), wg::desc_k(a_k, ks), ks);
        wg::wgmma_commit();
      }
      if (prev) {
#pragma unroll
        for (int cc = 0; cc < BN / 16; ++cc)
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh)
            wg::wgmma_rs<NO>(o[hh], pa[cc], wg::desc_mn(a_v, cc, hh * NO));
        wg::wgmma_commit();
      }
      float corr[2] = {1.f, 1.f};
      if (take) {
        if (prev)
          wg::wgmma_wait<1>();  // S; the previous P.V still on the cores
        else
          wg::wgmma_wait<0>();
        wg::fence_regs(s);
        probe.lap(kSWait);
        // the raw logits' max (a scale > 0 keeps their order), a masked
        // logit -inf: out of the max, and its exponential exactly 0; each
        // row's max and sum run as two chains (8-key blocks even and odd)
        const int k0 = kb + i * BN;
        float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
        if (band_full<BN>(p, me.q0, k0)) {
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            float& x = mx[(e >> 1) & 1][(e >> 2) & 1];
            x = fmaxf(x, s[e]);
          }
        } else {
          // element e holds key k0 + 2t + cc, cc = 8 (e / 4) + e % 2:
          // visible when cc lies in its row's [lo, hi)
          const int lo[2] = {keys_lo[0] - k0 - 2 * t, keys_lo[1] - k0 - 2 * t};
          const int hi[2] = {keys_hi[0] - k0 - 2 * t, keys_hi[1] - k0 - 2 * t};
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            const int r = (e >> 1) & 1;
            const int cc = 8 * (e >> 2) + (e & 1);
            s[e] = cc >= lo[r] && cc < hi[r] ? s[e] : -INFINITY;
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
          const float m_new = fmaxf(m[r], x * c);
          corr[r] = wg::ex2(m[r] - m_new);
          m[r] = m_new;
        }
        // p = 2^(s c - m): the scale folded into one FFMA a logit
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          s[e] = wg::ex2(fmaf(s[e], c, -m[(e >> 1) & 1]));
          ps[(e >> 1) & 1][(e >> 2) & 1] += s[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[r] = l[r] * corr[r] + (ps[r][0] + ps[r][1]);
        probe.lap(kSoftmax);
      }
      wg::wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) wg::fence_regs(o[hh]);
      wg::fence_regs(pa);
      if (i > 0) {  // tile i - 1's stage: this warpgroup is done with it
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(&empty[pst]);
      }
      if (take) {
        // O's rescale, skipped where no row of the warp moved its max (a
        // product by 1 is exact: the same bits)
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
            for (int e = 0; e < NO / 2; ++e) o[hh][e] *= corr[(e >> 1) & 1];
        }
        to_frags<BN>(pa, s);
      }
      probe.lap(kPvWait);
    }
    it += nt;
    // the Q tile is free for the producer (the unit after next's, or with
    // one buffer the next unit's, loaded meanwhile)
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&q_empty[qi]);
    if (!me.valid) continue;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const long long prog = (long long)me.b * p.heads + me.h;
    if (p.lse != nullptr && t == 0) {
      // the row's log-sum-exp of the scaled logits, ln 2 (m + log2 l); a
      // row that sees no key gets +inf, so exp(s - lse) weighs its keys 0
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qpos[r] < p.sq)
          p.lse[prog * p.sq + qpos[r]] =
              l[r] == 0.f ? INFINITY : (m[r] + log2f(l[r])) * kLn2;
    }
    // one division a row, then products (no visible key -> 0)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    if (kStoreTma && w.tma_store) {
      // through this warpgroup's O tile, swizzled as TMA reads it (rows
      // past Sq and columns past D are not written); the last unit's store
      // must have read the tile first
      unsigned char* so = s_o + wi * kTile;
      if ((tid & (kWgThreads - 1)) == 0) bulk_wait_read();
      bar_sync(kOwnBar + wi, kWgThreads);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = (warp & 3) * 16 + g + 8 * r;
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
          for (int j = 0; j < NO / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                so + wg::swizzled(rr, hh * NO + 8 * j + 2 * t)) =
                __floats2bfloat162_rn(o[hh][4 * j + 2 * r] * inv[r],
                                      o[hh][4 * j + 2 * r + 1] * inv[r]);
      }
      wg::fence_proxy_async();
      bar_sync(kOwnBar + wi, kWgThreads);
      if ((tid & (kWgThreads - 1)) == 0) {
#pragma unroll
        for (int cc = 0; cc < DP / 64; ++cc)
          tma_store_4d(&w.mo, so + cc * wg::kPanel, cc * 64,
                       pick(w.do_, 1, me.q0, me.h, me.b),
                       pick(w.do_, 2, me.q0, me.h, me.b),
                       pick(w.do_, 3, me.q0, me.h, me.b));
        bulk_commit();
      }
    } else {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                          me.b * p.lo.batch + me.h * p.lo.head;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat16* orow = ob + (long long)qpos[r] * p.lo.seq;
        const bool live = qpos[r] < p.sq;
        if (w.o_vec) {
          // 16-byte stores: the quad's four lanes trade their pairs so
          // that lane t holds the 8 columns of block 4 cb + t (in round x
          // lane t sends its pair of block 4 cb + (t ^ x) to lane t ^ x)
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
            for (int cb = 0; cb < NO / 32; ++cb) {
              uint32_t mine[4], got[4], out[4];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int j = 4 * cb + jj;
                const __nv_bfloat162 v = __floats2bfloat162_rn(
                    o[hh][4 * j + 2 * r] * inv[r],
                    o[hh][4 * j + 2 * r + 1] * inv[r]);
                mine[jj] = *reinterpret_cast<const uint32_t*>(&v);
              }
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const uint32_t send = pick4(mine, t ^ x);
                got[x] = x == 0 ? send
                                : __shfl_xor_sync(0xffffffffu, send, x);
              }
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) out[jj] = pick4(got, t ^ jj);
              const int col = hh * NO + 8 * (4 * cb + t);
              if (live && col < p.d)
                *reinterpret_cast<uint4*>(orow + col) =
                    make_uint4(out[0], out[1], out[2], out[3]);
            }
        } else if (live) {
          const bool pairs = (reinterpret_cast<uintptr_t>(orow) & 3) == 0;
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
            for (int j = 0; j < NO / 8; ++j) {
              const int col = hh * NO + 8 * j + 2 * t;
              const float x0 = o[hh][4 * j + 2 * r] * inv[r];
              const float x1 = o[hh][4 * j + 2 * r + 1] * inv[r];
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
    }
    probe.lap(kEpilogue);
  }
  if (kStoreTma && (tid & (kWgThreads - 1)) == 0) bulk_wait();
  probe.write();
}

// the SMs of the current card, asked once a card
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// the shared instance at padded width DP with W consumer warpgroups on
// key tiles of BN, a ring of kStages stages, kQBufs Q buffers and
// kConsumerRegs registers a consumer thread: one CTA an SM, as many as
// the card has SMs (or units, if fewer)
template <int DP, int BN, int W, int kStages, int kQBufs, int kConsumerRegs,
          bool kStoreTma, int kProducerKeeps = kSharedProducerRegs>
int launch_shared(WgParams w, cudaStream_t stream) {
  // an SM sub-partition holds one warp of each warpgroup, and what the
  // producer gives back pays for what the consumers take
  constexpr int kLaunchRegs = 16384 / (32 * (W + 1)) / 8 * 8;
  static_assert(W * (kConsumerRegs - kLaunchRegs) <=
                    kLaunchRegs - kProducerKeeps,
                "the consumers take more registers than the producer frees");
  static_assert(W >= 2 && W <= 3, "two or three consumer warpgroups");
  constexpr size_t kTile = (size_t)kRows * DP * 2;
  constexpr size_t kSmem =
      W * (kQBufs + (kStoreTma ? 1 : 0)) * kTile +
      2 * kStages * (size_t)BN * DP * 2 +
      (2 * kStages + 2 * kQBufs * W) * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "tiles exceed a block's shared memory");
  const Params& p = w.p;
  if (p.group > 1) {
    w.hblocks = (p.group + W - 1) / W;
    w.per_rank = p.programs / p.group * w.hblocks;
    w.units = p.q_tiles * w.per_rank;
  } else {
    w.hblocks = 1;
    w.per_rank = p.programs;
    w.units = (p.q_tiles + W - 1) / W * w.per_rank;
  }
  auto kernel = flash_shared_kernel<DP, BN, W, kStages, kQBufs, kConsumerRegs,
                                    kProducerKeeps, kStoreTma>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = min(w.units, sm_count());
  kernel<<<grid, (W + 1) * kWgThreads, kSmem, stream>>>(w);
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
// own loads; o's map where o is aligned too (the shared design's
// store). The schedule's fields are launch_shared's.
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
  w->o_vec = a->d % 8 == 0 && aligned16(a->o, a->lo, 2);
  w->tma_store = w->tma && w->o_vec &&
                 encode(&w->mo, &w->do_, a->o, a->lo, a->batch, a->heads,
                        a->sq, a->d);
  w->units = w->per_rank = w->hblocks = 0;
}

// the bf16 designs (flash_attention_variant's numbers): kPerTile a CTA
// for each query tile of each program (flash_wgmma_kernel), kShared the
// shared design's instance for the width (flash_shared_kernel)
enum Variant { kRouted = 0, kPerTile = 1, kShared = 2 };

// the design a bf16 call takes, by shape only (a row's bits must not
// depend on the batch), from paired runs on the card (PERF.md): a CTA a
// query tile where the kv group is 1 and Sq fits one tile (nothing for
// two warpgroups to share: whisper's cross-attention; there that design's
// split of the keys between two key groups gives a CTA its second
// warpgroup), and at D <= 64 where three warpgroups would leave slots idle
// (a kv group of 2, 4, 5, ... heads: its three CTAs an SM ran faster);
// else the shared design
int routed(const FlashArgs* a) {
  const int q_tiles = (a->sq + kRows - 1) / kRows;
  if (a->group == 1 && q_tiles == 1) return kPerTile;
  if (a->d <= 64 && a->group > 1 && a->group % 3 != 0) return kPerTile;
  return kShared;
}

// the instances of a CTA a query tile: two key groups where a CTA's rows see more than one
// key tile and the CTAs are few (Sq within one tile: cross-attention) or
// heavy (D > 128, where one CTA fills an SM); else one, and two or three
// CTAs an SM overlap one another's first loads and last stores
int launch_per_tile(const WgParams& w, const FlashArgs* a, cudaStream_t s) {
  const int blocks = (int)((long long)a->batch * a->heads *
                           ((a->sq + kBlockQ - 1) / kBlockQ));
  const int d = a->d;
  if (a->sk > kRows && (a->sq <= kRows || d > 128)) {
    if (d <= 64) return launch_wgmma<64, 2, 6, 1, 240>(w, blocks, s);
    if (d <= 128) return launch_wgmma<128, 2, 6, 1, 240>(w, blocks, s);
    return launch_wgmma<256, 2, 3, 1, 240>(w, blocks, s);
  }
  if (d <= 64) return launch_wgmma<64, 1, 4, 3, 136>(w, blocks, s);
  if (d <= 128) return launch_wgmma<128, 1, 3, 2, 232>(w, blocks, s);
  return launch_wgmma<256, 1, 3, 2, 232>(w, blocks, s);
}

// the shared design's instance for width d, each the one that won its
// width in paired runs on the card (PERF.md): D <= 64, three warpgroups on
// key tiles of 128, Q in two buffers, the producer at 32 registers; D <=
// 128, three on tiles of 64 with one Q buffer (two leave room for two
// stages only, which ran slower); both with their O tiles in shared
// memory for a TMA store; D = 256, two warpgroups (O is 128 registers a
// thread) with one Q buffer and no O tile, its stores 16 bytes a lane
int launch_shared_for(const WgParams& w, int d, cudaStream_t s) {
  if (d <= 64) return launch_shared<64, 128, 3, 4, 2, 160, true, 32>(w, s);
  if (d <= 128) return launch_shared<128, 64, 3, 3, 1, 152, true>(w, s);
  return launch_shared<256, 64, 2, 2, 1, 232, false>(w, s);
}

int launch_bf16(const FlashArgs* a, int variant, cudaStream_t s) {
  WgParams w;
  wg_params(&w, a);
  if (variant == kRouted) variant = routed(a);
  if (variant == kPerTile) return launch_per_tile(w, a, s);
  if (variant == kShared) return launch_shared_for(w, a->d, s);
  return (int)cudaErrorInvalidValue;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->bf16) return launch_bf16(a, kRouted, s);
  const int blocks = (int)((long long)a->batch * a->heads *
                           ((a->sq + kBlockQ - 1) / kBlockQ));
  const Params p = params_of(a);
  const int d = a->d;
  if (d <= 8) return launch<float, 8, 64>(p, blocks, s);
  if (d <= 16) return launch<float, 16, 64>(p, blocks, s);
  if (d <= 32) return launch<float, 32, 64>(p, blocks, s);
  if (d <= 64) return launch<float, 64, 64>(p, blocks, s);
  if (d <= 128) return launch<float, 128, 32>(p, blocks, s);
  return launch<float, 256, 16>(p, blocks, s);
}

// flash_attention_bshd's bf16 call with its design chosen by the caller
// (Variant: 1 a CTA a query tile, 2 the shared design, 0 the one
// flash_attention_bshd takes): for timing the two against one another at
// any shape, the comparison routed() rests on. cudaErrorInvalidValue for
// float32 arguments and any other design.
extern "C" int flash_attention_variant(const FlashArgs* a, int variant,
                                       void* stream) {
  if (!valid(a) || !a->bf16) return (int)cudaErrorInvalidValue;
  return launch_bf16(a, variant, static_cast<cudaStream_t>(stream));
}

// which design flash_attention_bshd takes for these arguments: 4 the bf16
// shared design with TMA loads, 3 with the producer's own loads, 2 the
// bf16 design of a CTA a query tile with TMA loads, 1 with the producer's
// own loads, 0 the
// float32 mma.sync instances; -1 for arguments it refuses. Launches
// nothing.
extern "C" int flash_attention_route(const FlashArgs* a) {
  if (!valid(a)) return -1;
  if (!a->bf16) return 0;
  WgParams w;
  wg_params(&w, a);
  return (routed(a) == kPerTile ? 1 : 3) + (w.tma ? 1 : 0);
}

#ifdef FLASH_PROBE
// the tick probe's counters of the first n CTAs of the last launch
// (kLaps + 1 a CTA: each stretch's ticks, then the total), zeroed after
extern "C" int flash_probe_take(long long* dst, int n) {
  n = n < kProbeCtas ? n : kProbeCtas;
  const size_t bytes = (size_t)n * (kLaps + 1) * sizeof(long long);
  cudaError_t e = cudaMemcpyFromSymbol(dst, flash_probe_ticks, bytes);
  if (e == cudaSuccess) {
    void* at = nullptr;
    e = cudaGetSymbolAddress(&at, flash_probe_ticks);
    if (e == cudaSuccess) e = cudaMemset(at, 0, sizeof(flash_probe_ticks));
  }
  return (int)e;
}
#endif
