// The gradient of blocked flash attention for Hopper (sm_90a) on the
// tensor cores, with GQA, a causal / sliding-window mask and strided
// operands: dQ, dK and dV from q, k, v, o, dO and the forward's per-row
// log-sum-exp (flash_attention.cu, given an lse buffer).
//
// Replaces the gradient of the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bhsd: the JAX
// package trains through its plain attention (attention_impl "xla") and
// differentiates that; no Pallas kernel there has a backward. With the
// forward's notation (s_ij = scale q_i . k_j over the visible keys, P_ij =
// exp(s_ij - lse_i), a masked key and a row with no visible key weighing
// 0):
//   D_i   = sum_d dO_id O_id                 (one float a row)
//   dV_j  = sum_i P_ij dO_i                  (over every query head of
//   dS_ij = P_ij (dO_i . v_j - D_i)           the kv head's group)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_i dS_ij q_i
// in float32 throughout, each result rounded once to the inputs' type
// (bf16 to nearest even).
//
// Bound: operations. Against the forward's two S^2 products a (query,
// key) pair takes five at the least (s, dP, dV, dQ, dK); this design
// takes seven (s and dP twice: once for dQ, once for dK and dV), all on
// the tensor cores: bf16 at 989 TFLOP/s, float32 as 3xTF32 at a third of
// TF32's 495 TFLOP/s. So the bf16 instances can reach 5/7 of the bound
// at best; at D = 256 (below) eleven products a pair, 5/11.
//
// Design (FlashAttention-2's split, three launches from one entry point):
// - delta_kernel forms D, one warp a row.
// - the dQ kernel gives a CTA to each (program, 64 query rows); it walks
//   the key tiles the mask lets those rows see, recomputes s and dP =
//   dO V^T, and keeps dQ in registers.
// - the dK/dV kernel gives a CTA to each (sequence, kv head, 64 keys); it
//   walks the group's query heads and, for each, the query tiles that
//   can see its keys, and keeps dK and dV in registers. The sum over the
//   group's heads happens inside the CTA: no floating-point atomics, so
//   the same inputs give the same bits.
// - At D = 256 the accumulators would not fit: dK and dV for 64 keys are
//   256 floats a thread of a warpgroup, the whole register file. So two
//   CTAs share each tile (blockIdx.y), each keeping half of dQ's, dK's
//   and dV's columns (128) and recomputing s and dP over the full D.
// - Tiles wholly outside the causal or window band are skipped, tiles
//   wholly inside it skip the per-element mask, and the rest mask each
//   element as the forward does.
// - FMA contraction is allowed in this library.
//
// The bf16 instances (dq_wgmma_kernel, dkv_wgmma_kernel; tiles in
// flash_wgmma.cuh), built for Hopper:
// - A CTA is one consumer warpgroup (warps 0-3) and one producer warp
//   (warp 4). The producer fills a ring of two stages in shared memory
//   (K and V tiles of 64 keys for dQ; Q and dO tiles of 64 queries, with
//   their LSE and D, for dK/dV) after the CTA's own tile pair; full and
//   empty mbarriers hand each stage over, so the next tile loads while
//   the consumers work on this one.
// - Loads are TMA (a rank-4 map per operand, made on the host through
//   cudaGetDriverEntryPoint, so the library needs no libcuda; the encoder
//   and the tile loads are flash_tma.cuh's, shared with the forward) when the
//   operands' strides and base addresses are 16-byte aligned; TMA writes
//   zeros past the sequence and past D. Otherwise (an unaligned view,
//   whose rows cp.async's 4-, 8- and 16-byte pieces cannot move) the
//   producer's lanes copy each element into the same swizzled layout.
// - Every product is a wgmma of 64 rows: s and dP (s^T and dP^T for
//   dK/dV) from the two shared-memory tiles, K-major, m64n64k16; dQ +=
//   dS K, dV += P^T dO and dK += dS^T Q take P and dS as A fragments from
//   registers (rounded to bf16, the rounding points of the mma.sync
//   design) and the tile MN-major as B: m64n64k16 at D = 64, m64n128k16
//   at D >= 128. The accumulators sum across key (query) tiles on the
//   tensor cores, which round toward zero: within ref.flash_bwd_bf16_limits
//   by far (chip_smoke.py's FLASH_BWD_CASES).
// - The exponentials run while dP is still on the tensor cores (s and dP
//   are two commit groups), and dV's product while dS^T is formed. A
//   tile wholly inside the band takes no per-element mask, and P is
//   ex2.approx (a P below 2^-126 flushes to 0), so 32 exponentials
//   overlap instead of waiting on one another.
// - D pads up to 64, 128 or 256; D is formed 8 elements a lane.
// - What bounds it now: each warpgroup walks its tiles one after the
//   other (products, then the exponentials, then the next products), and
//   two or three CTAs an SM (registers, shared memory) leave the tensor
//   cores idle most of the time; it reaches about a third of the bf16
//   rate at whisper-small's encoder (PERF.md).
// The float32 instances keep the mma.sync design (dq_kernel, dkv_kernel;
// tiles in flash_tiles.cuh): one stage of tiles a step loaded by
// cp.async, 3xTF32 products, s and dP formed by each warp's 16 rows. They
// serve the float32 gates only.

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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = kWarps * 16;  // query rows (dQ) or keys (dK, dV) a CTA
constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (programs, Sq)
  float* delta;      // (programs, Sq), written by delta_kernel
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  int heads, group, sq, sk, d, causal, window, vec;
  float scale, scale_log2;
  int dvec;  // o and dO move in 16-byte pieces (bf16 instances' D)
};

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return i < p.sq && j < p.sk && (!p.causal || j <= i) &&
         (p.window <= 0 || j > i - p.window);
}

// some pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is
// visible: j - i over the rectangle takes every value from k0 - q_last to
// k_last - q0, and the band needs one in (-window, 0] (causal) or above
// -window
__device__ __forceinline__ bool block_visible(const Params& p, int q0, int nq,
                                              int k0, int nk) {
  if (q0 >= p.sq || k0 >= p.sk) return false;
  const int q_last = min(q0 + nq, p.sq) - 1;
  const int k_last = min(k0 + nk, p.sk) - 1;
  if (p.causal && k0 > q_last) return false;
  if (p.window > 0 && k_last <= q0 - p.window) return false;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const Params p,
                                                    int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int prog = row / p.sq;
  const int i = row - prog * p.sq;
  const int b = prog / p.heads;
  const int h = prog - b * p.heads;
  const T* orow = static_cast<const T*>(p.o) + b * p.lo.batch +
                  h * p.lo.head + i * p.lo.seq;
  const T* drow = static_cast<const T*>(p.dout) + b * p.ldo.batch +
                  h * p.ldo.head + i * p.ldo.seq;
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32) acc += to_f32(drow[c]) * to_f32(orow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// D for bf16 rows whose o and dO move in 16-byte pieces: LPR lanes a
// row, 8 elements a lane a step, the lanes' sums added by shuffles
template <int LPR>
__global__ void __launch_bounds__(256) delta_vec_kernel(const Params p,
                                                        int rows) {
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR;
  const int sub = threadIdx.x % LPR;
  float acc = 0.f;
  if (row < rows) {
    const int prog = row / p.sq;
    const int i = row - prog * p.sq;
    const int b = prog / p.heads;
    const int h = prog - b * p.heads;
    const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(p.o) +
                                b * p.lo.batch + h * p.lo.head + i * p.lo.seq;
    const __nv_bfloat16* drow = static_cast<const __nv_bfloat16*>(p.dout) +
                                b * p.ldo.batch + h * p.ldo.head +
                                i * p.ldo.seq;
    for (int c = sub * 8; c < p.d; c += LPR * 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 of = __bfloat1622float2(o2[k]);
        const float2 df = __bfloat1622float2(d2[k]);
        acc += df.x * of.x + df.y * of.y;
      }
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) p.delta[row] = acc;
}

// dQ for 64 query rows of one program, its columns c0 .. c0 + NO - 1
// (c0 = NO blockIdx.y); BK keys a step
template <typename T, int DP, int BK, int NO>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const Params p, int programs, int q_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = DP + 16 / (int)sizeof(T);
  T* s_q = reinterpret_cast<T*>(smem_raw);  // (kBlock, RS)
  T* s_do = s_q + kBlock * RS;              // (kBlock, RS)
  T* s_k = s_do + kBlock * RS;              // (BK, RS)
  T* s_v = s_k + BK * RS;                   // (BK, RS)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the last query tile of every program first: those see the most keys
  const int rank = blockIdx.x / programs;
  const int prog = blockIdx.x - rank * programs;
  const int q_start = (q_tiles - 1 - rank) * kBlock;
  const int c0 = blockIdx.y * NO;
  const int b = prog / p.heads;
  const int h = prog - b * p.heads;
  const int kh = h / p.group;
  const T* qb = static_cast<const T*>(p.q) + b * p.lq.batch + h * p.lq.head;
  const T* dob =
      static_cast<const T*>(p.dout) + b * p.ldo.batch + h * p.ldo.head;
  const T* kb = static_cast<const T*>(p.k) + b * p.lk.batch + kh * p.lk.head;
  const T* vb = static_cast<const T*>(p.v) + b * p.lv.batch + kh * p.lv.head;
  T* dqb = static_cast<T*>(p.dq) + b * p.ldq.batch + h * p.ldq.head;
  const bool vec = p.vec != 0;

  load_tile<T, DP, kBlock>(s_q, qb, p.lq.seq, q_start, p.sq, p.d, vec, tid,
                           kThreads);
  load_tile<T, DP, kBlock>(s_do, dob, p.ldo.seq, q_start, p.sq, p.d, vec,
                           tid, kThreads);
  cp_async_commit();

  const int row0 = q_start + warp * 16;  // this warp's rows
  const int qpos[2] = {row0 + g, row0 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < p.sq;
    const long long at = (long long)prog * p.sq + qpos[r];
    lse2[r] = in ? p.lse[at] * kLog2e : 0.f;
    dl[r] = in ? p.delta[at] : 0.f;
  }
  float dq[NO / 8][4];
#pragma unroll
  for (int n = 0; n < NO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float one[2] = {1.f, 1.f};

  const int k_tiles = (p.sk + BK - 1) / BK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k_start = kt * BK;
    if (!block_visible(p, q_start, kBlock, k_start, BK)) continue;
    __syncthreads();  // the previous step's tiles are consumed
    load_tile<T, DP, BK>(s_k, kb, p.lk.seq, k_start, p.sk, p.d, vec, tid,
                         kThreads);
    load_tile<T, DP, BK>(s_v, vb, p.lv.seq, k_start, p.sk, p.d, vec, tid,
                         kThreads);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (!block_visible(p, row0, 16, k_start, BK)) continue;

    float s[BK / 8][4], dp[BK / 8][4];
    qk_tile<DP, BK>(s, s_q + warp * 16 * RS, s_k, g, t);
    qk_tile<DP, BK>(dp, s_do + warp * 16 * RS, s_v, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr =
            visible(p, qpos[r], k_start + j * 8 + 2 * t + (e & 1))
                ? exp2f(s[j][e] * p.scale_log2 - lse2[r])
                : 0.f;
        s[j][e] = pr * (dp[j][e] - dl[r]);  // dS
      }
    pv_tile<DP, BK, NO>(dq, s, s_k + c0, g, t, one);
  }
  cp_async_wait_all();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.sq) continue;
    T* row = dqb + qpos[r] * p.ldq.seq;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      if (col < p.d) store(row + col, dq[n][2 * r] * p.scale);
      if (col + 1 < p.d) store(row + col + 1, dq[n][2 * r + 1] * p.scale);
    }
  }
}

// dK and dV for 64 keys of one (sequence, kv head), their columns c0 ..
// c0 + NO - 1 (c0 = NO blockIdx.y); BQ query rows a step, over every query
// head of the group
template <typename T, int DP, int BQ, int NO>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const Params p, int kv_programs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = DP + 16 / (int)sizeof(T);
  T* s_k = reinterpret_cast<T*>(smem_raw);  // (kBlock, RS)
  T* s_v = s_k + kBlock * RS;               // (kBlock, RS)
  T* s_q = s_v + kBlock * RS;               // (BQ, RS)
  T* s_do = s_q + BQ * RS;                  // (BQ, RS)
  float* s_lse = reinterpret_cast<float*>(s_do + BQ * RS);  // (BQ,) base 2
  float* s_delta = s_lse + BQ;                              // (BQ,)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv_heads = p.heads / p.group;
  // the first key tile of every kv head first: under a causal mask those
  // are seen by the most queries
  const int rank = blockIdx.x / kv_programs;
  const int kvp = blockIdx.x - rank * kv_programs;
  const int k_start = rank * kBlock;
  const int c0 = blockIdx.y * NO;
  const int b = kvp / kv_heads;
  const int kh = kvp - b * kv_heads;
  const T* kb = static_cast<const T*>(p.k) + b * p.lk.batch + kh * p.lk.head;
  const T* vb = static_cast<const T*>(p.v) + b * p.lv.batch + kh * p.lv.head;
  T* dkb = static_cast<T*>(p.dk) + b * p.ldk.batch + kh * p.ldk.head;
  T* dvb = static_cast<T*>(p.dv) + b * p.ldv.batch + kh * p.ldv.head;
  const bool vec = p.vec != 0;

  load_tile<T, DP, kBlock>(s_k, kb, p.lk.seq, k_start, p.sk, p.d, vec, tid,
                           kThreads);
  load_tile<T, DP, kBlock>(s_v, vb, p.lv.seq, k_start, p.sk, p.d, vec, tid,
                           kThreads);
  cp_async_commit();

  const int key0 = k_start + warp * 16;  // this warp's keys
  const int kpos[2] = {key0 + g, key0 + g + 8};
  float dk[NO / 8][4], dv[NO / 8][4];
#pragma unroll
  for (int n = 0; n < NO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float one[2] = {1.f, 1.f};

  const int q_tiles = (p.sq + BQ - 1) / BQ;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kh * p.group + gi;
    const long long prog = (long long)b * p.heads + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.lq.batch + h * p.lq.head;
    const T* dob =
        static_cast<const T*>(p.dout) + b * p.ldo.batch + h * p.ldo.head;
    for (int qt = 0; qt < q_tiles; ++qt) {
      const int q0 = qt * BQ;
      if (!block_visible(p, q0, BQ, k_start, kBlock)) continue;
      __syncthreads();  // the previous step's tiles are consumed
      load_tile<T, DP, BQ>(s_q, qb, p.lq.seq, q0, p.sq, p.d, vec, tid,
                           kThreads);
      load_tile<T, DP, BQ>(s_do, dob, p.ldo.seq, q0, p.sq, p.d, vec, tid,
                           kThreads);
      for (int i = tid; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.sq;
        s_lse[i] = in ? p.lse[prog * p.sq + q0 + i] * kLog2e : 0.f;
        s_delta[i] = in ? p.delta[prog * p.sq + q0 + i] : 0.f;
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (!block_visible(p, q0, BQ, key0, 16)) continue;

      // s^T and dP^T: rows are this warp's keys, columns the tile's queries
      float st[BQ / 8][4], dpt[BQ / 8][4];
      qk_tile<DP, BQ>(st, s_k + warp * 16 * RS, s_q, g, t);
      qk_tile<DP, BQ>(dpt, s_v + warp * 16 * RS, s_do, g, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);  // query q0 + c
          const float pr =
              visible(p, q0 + c, kpos[e >> 1])
                  ? exp2f(st[j][e] * p.scale_log2 - s_lse[c])
                  : 0.f;
          st[j][e] = pr;
          dpt[j][e] = pr * (dpt[j][e] - s_delta[c]);  // dS^T
        }
      pv_tile<DP, BQ, NO>(dv, st, s_do + c0, g, t, one);
      pv_tile<DP, BQ, NO>(dk, dpt, s_q + c0, g, t, one);
    }
  }
  cp_async_wait_all();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.sk) continue;
    T* krow = dkb + kpos[r] * p.ldk.seq;
    T* vrow = dvb + kpos[r] * p.ldv.seq;
#pragma unroll
    for (int n = 0; n < NO / 8; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      if (col < p.d) {
        store(krow + col, dk[n][2 * r] * p.scale);
        store(vrow + col, dv[n][2 * r]);
      }
      if (col + 1 < p.d) {
        store(krow + col + 1, dk[n][2 * r + 1] * p.scale);
        store(vrow + col + 1, dv[n][2 * r + 1]);
      }
    }
  }
}

// ---- the bf16 instances: wgmma fed by a ring of stages ------------------

namespace wg = flash_wgmma;
using wg::kRows;
using namespace flash_tma;

constexpr int kWgThreads = 160;  // a consumer warpgroup and a producer warp
constexpr int kProducer = 4;     // the producer's warp

struct WgParams {
  CUtensorMap mq, mk, mv, mdo;
  MapDims dq_, dk_, dv_, ddo_;
  Params p;
  int tma;  // 1: tiles come by TMA; 0: by the producer's own loads
};

// visible(), as one predicate without short-circuit branches
__device__ __forceinline__ bool seen(const Params& p, int i, int j) {
  return (i < p.sq) & (j < p.sk) & (!p.causal | (j <= i)) &
         ((p.window <= 0) | (j > i - p.window));
}

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

// the producer's hand-over of a tile of a (at dst) and one of b (after
// it), rows pos0 .. pos0 + 63, on barrier `bar`, whose count is the warp's
// 32 lanes: lane 0 expects the TMA bytes and issues the loads, or every
// lane copies its share. Then `also` (other stores by every lane for the
// same stage), and every lane but TMA's issuer arrives, a copying lane
// after fencing its stores for wgmma's reads.
template <int DP, typename Also>
__device__ __forceinline__ void produce(const WgParams& w, unsigned char* dst,
                                        uint64_t* bar, const Src& a,
                                        const Src& b, int pos0, int n,
                                        int seq, int lane, Also also) {
  constexpr uint32_t kTile = kRows * DP * 2;
  if (w.tma) {
    if (lane == 0) {
      wg::mbar_arrive_tx(bar, 2 * kTile);
      tma_tile<DP>(dst, a.map, a.dims, bar, pos0, a.head, seq);
      tma_tile<DP>(dst + kTile, b.map, b.dims, bar, pos0, b.head, seq);
    }
  } else {
    plain_tile<DP>(dst, a.base, a.stride, pos0, n, w.p.d, lane);
    plain_tile<DP>(dst + kTile, b.base, b.stride, pos0, n, w.p.d, lane);
  }
  also();
  if (!w.tma) wg::fence_proxy_async();
  if (!w.tma || lane != 0) wg::mbar_arrive(bar);
}

__device__ __forceinline__ const __nv_bfloat16* rows_of(const void* t,
                                                        const Layout& l,
                                                        int b, int h) {
  return static_cast<const __nv_bfloat16*>(t) + b * l.batch + h * l.head;
}

// dQ for 64 query rows of one program, its columns c0 .. c0 + NO - 1 (c0
// = NO blockIdx.y), walking 64 keys a step
template <int DP, int NO, int kStages, int MINB>
__global__ void __launch_bounds__(kWgThreads, MINB)
dq_wgmma_kernel(const __grid_constant__ WgParams w, int programs,
                int q_tiles) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  constexpr uint32_t kTile = kRows * DP * 2;
  unsigned char* s_q = align1024(wg_smem);  // Q, then dO
  unsigned char* ring = s_q + 2 * kTile;    // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* own = empty + kStages;

  const Params& p = w.p;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the last query tile of every program first: those see the most keys
  const int rank = blockIdx.x / programs;
  const int prog = blockIdx.x - rank * programs;
  const int q0 = (q_tiles - 1 - rank) * kRows;
  const int c0 = blockIdx.y * NO;
  const int b = prog / p.heads;
  const int h = prog - b * p.heads;
  const int kh = h / p.group;
  const int k_tiles = (p.sk + kRows - 1) / kRows;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], 4);
    }
    wg::mbar_init(own, 32);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducer) {
    const Src q{&w.mq, w.dq_, rows_of(p.q, p.lq, b, h), p.lq.seq, h};
    const Src dout{&w.mdo, w.ddo_, rows_of(p.dout, p.ldo, b, h), p.ldo.seq, h};
    const Src k{&w.mk, w.dk_, rows_of(p.k, p.lk, b, kh), p.lk.seq, kh};
    const Src v{&w.mv, w.dv_, rows_of(p.v, p.lv, b, kh), p.lv.seq, kh};
    produce<DP>(w, s_q, own, q, dout, q0, p.sq, b, lane, [] {});
    int n = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int k_start = kt * kRows;
      if (!block_visible(p, q0, kRows, k_start, kRows)) continue;
      const int s = n % kStages;
      wg::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
      produce<DP>(w, ring + s * 2 * kTile, &full[s], k, v, k_start, p.sk, b,
                  lane, [] {});
      ++n;
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < p.sq;
    const long long at = (long long)prog * p.sq + qpos[r];
    lse2[r] = in ? p.lse[at] * kLog2e : 0.f;
    dl[r] = in ? p.delta[at] : 0.f;
  }
  float dq[NO / 2];
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) dq[e] = 0.f;
  uint32_t af[4][4];
  const uint32_t a_q = wg::smem_u32(s_q);
  const uint32_t a_do = a_q + kTile;
  wg::mbar_wait(own, 0);

  int n = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k_start = kt * kRows;
    if (!block_visible(p, q0, kRows, k_start, kRows)) continue;
    const int s = n % kStages;
    wg::mbar_wait(&full[s], (n / kStages) & 1);
    const uint32_t a_k = wg::smem_u32(ring + s * 2 * kTile);
    const uint32_t a_v = a_k + kTile;
    float sacc[32], dpacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = dpacc[e] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wg::wgmma_ss_n64(sacc, wg::desc_k(a_q, ks), wg::desc_k(a_k, ks), ks);
    wg::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wg::wgmma_ss_n64(dpacc, wg::desc_k(a_do, ks), wg::desc_k(a_v, ks), ks);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // s; dP still on the tensor cores
    wg::fence_regs(sacc);

    // P: a tile wholly inside the band takes no mask; at its edges a
    // masked exponential is dropped by a select, not a branch, so the 32
    // still overlap
    if (block_full(p, q0, k_start)) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sacc[e] = wg::ex2(sacc[e] * p.scale_log2 - lse2[(e >> 1) & 1]);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const int key = k_start + 8 * (e >> 2) + 2 * t + (e & 1);
        const float ex = wg::ex2(sacc[e] * p.scale_log2 - lse2[r]);
        sacc[e] = seen(p, qpos[r], key) ? ex : 0.f;
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(dpacc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      const float pr = sacc[e];
      sacc[e] = pr * (dpacc[e] - dl[r]);  // dS
    }
    wg::to_a_frags(af, sacc);
    wg::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c)
      wg::wgmma_rs<NO>(dq, af[c], wg::desc_mn(a_k, c, c0));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dq);
    wg::fence_regs(af);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);
    ++n;
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + b * p.ldq.batch +
                       h * p.ldq.head;
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) {
    const int row = qpos[(e >> 1) & 1];
    const int col = c0 + 8 * (e >> 2) + 2 * t + (e & 1);
    if (row < p.sq && col < p.d)
      store(dqb + row * p.ldq.seq + col, dq[e] * p.scale);
  }
}

// dK and dV for 64 keys of one (sequence, kv head), their columns c0 ..
// c0 + NO - 1 (c0 = NO blockIdx.y), walking 64 query rows a step over
// every query head of the group
template <int DP, int NO, int kStages, int MINB>
__global__ void __launch_bounds__(kWgThreads, MINB)
dkv_wgmma_kernel(const __grid_constant__ WgParams w, int kv_programs) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  constexpr uint32_t kTile = kRows * DP * 2;
  unsigned char* s_k = align1024(wg_smem);  // K, then V
  unsigned char* ring = s_k + 2 * kTile;    // stage s: Q, then dO
  float* s_lse = reinterpret_cast<float*>(ring + kStages * 2 * kTile);
  float* s_delta = s_lse + kStages * kRows;  // (kStages, kRows) each
  uint64_t* full = reinterpret_cast<uint64_t*>(s_delta + kStages * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* own = empty + kStages;

  const Params& p = w.p;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kv_heads = p.heads / p.group;
  // the first key tile of every kv head first: under a causal mask those
  // are seen by the most queries
  const int rank = blockIdx.x / kv_programs;
  const int kvp = blockIdx.x - rank * kv_programs;
  const int k_start = rank * kRows;
  const int c0 = blockIdx.y * NO;
  const int b = kvp / kv_heads;
  const int kh = kvp - b * kv_heads;
  const int q_tiles = (p.sq + kRows - 1) / kRows;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], 4);
    }
    wg::mbar_init(own, 32);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducer) {
    const Src k{&w.mk, w.dk_, rows_of(p.k, p.lk, b, kh), p.lk.seq, kh};
    const Src v{&w.mv, w.dv_, rows_of(p.v, p.lv, b, kh), p.lv.seq, kh};
    produce<DP>(w, s_k, own, k, v, k_start, p.sk, b, lane, [] {});
    int n = 0;
    for (int gi = 0; gi < p.group; ++gi) {
      const int h = kh * p.group + gi;
      const long long prog = (long long)b * p.heads + h;
      const Src q{&w.mq, w.dq_, rows_of(p.q, p.lq, b, h), p.lq.seq, h};
      const Src dout{&w.mdo, w.ddo_, rows_of(p.dout, p.ldo, b, h), p.ldo.seq,
                     h};
      for (int qt = 0; qt < q_tiles; ++qt) {
        const int q0 = qt * kRows;
        if (!block_visible(p, q0, kRows, k_start, kRows)) continue;
        const int s = n % kStages;
        wg::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        // the tiles' loads first, then each row's LSE (base 2) and D
        produce<DP>(w, ring + s * 2 * kTile, &full[s], q, dout, q0, p.sq, b,
                    lane, [&] {
#pragma unroll
                      for (int i = lane; i < kRows; i += 32) {
                        const bool in = q0 + i < p.sq;
                        const long long at = prog * p.sq + q0 + i;
                        s_lse[s * kRows + i] = in ? p.lse[at] * kLog2e : 0.f;
                        s_delta[s * kRows + i] = in ? p.delta[at] : 0.f;
                      }
                    });
        ++n;
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int kpos[2] = {k_start + warp * 16 + g, k_start + warp * 16 + g + 8};
  float dk[NO / 2], dv[NO / 2];
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) dk[e] = dv[e] = 0.f;
  uint32_t pa[4][4], da[4][4];
  const uint32_t a_k = wg::smem_u32(s_k);
  const uint32_t a_v = a_k + kTile;
  wg::mbar_wait(own, 0);

  int n = 0;
  for (int gi = 0; gi < p.group; ++gi) {
    for (int qt = 0; qt < q_tiles; ++qt) {
      const int q0 = qt * kRows;
      if (!block_visible(p, q0, kRows, k_start, kRows)) continue;
      const int s = n % kStages;
      wg::mbar_wait(&full[s], (n / kStages) & 1);
      const uint32_t a_q = wg::smem_u32(ring + s * 2 * kTile);
      const uint32_t a_do = a_q + kTile;
      // s^T and dP^T: rows are this CTA's keys, columns the tile's queries
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wg::wgmma_ss_n64(st, wg::desc_k(a_k, ks), wg::desc_k(a_q, ks), ks);
      wg::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wg::wgmma_ss_n64(dpt, wg::desc_k(a_v, ks), wg::desc_k(a_do, ks), ks);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // s^T; dP^T still on the tensor cores
      wg::fence_regs(st);

      const float* lse2 = s_lse + s * kRows;
      const float* dl = s_delta + s * kRows;
      if (block_full(p, q0, k_start)) {
#pragma unroll
        for (int e = 0; e < 32; ++e)  // query q0 + 8 (e / 4) + 2 t + e % 2
          st[e] = wg::ex2(st[e] * p.scale_log2 -
                          lse2[8 * (e >> 2) + 2 * t + (e & 1)]);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          const float ex = wg::ex2(st[e] * p.scale_log2 - lse2[c]);
          st[e] = seen(p, q0 + c, kpos[(e >> 1) & 1]) ? ex : 0.f;
        }
      }
      wg::to_a_frags(pa, st);
      wg::wgmma_fence();
      // dV += P^T dO runs while dS^T is formed
#pragma unroll
      for (int c = 0; c < kRows / 16; ++c)
        wg::wgmma_rs<NO>(dv, pa[c], wg::desc_mn(a_do, c, c0));
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // dP^T
      wg::fence_regs(dpt);
#pragma unroll
      for (int e = 0; e < 32; ++e)  // dS^T
        dpt[e] = st[e] * (dpt[e] - dl[8 * (e >> 2) + 2 * t + (e & 1)]);
      wg::to_a_frags(da, dpt);
      wg::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kRows / 16; ++c)  // dK += dS^T Q
        wg::wgmma_rs<NO>(dk, da[c], wg::desc_mn(a_q, c, c0));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(dv);
      wg::fence_regs(dk);
      wg::fence_regs(pa);
      wg::fence_regs(da);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[s]);
      ++n;
    }
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + b * p.ldk.batch +
                       kh * p.ldk.head;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + b * p.ldv.batch +
                       kh * p.ldv.head;
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) {
    const int key = kpos[(e >> 1) & 1];
    const int col = c0 + 8 * (e >> 2) + 2 * t + (e & 1);
    if (key < p.sk && col < p.d) {
      store(dkb + key * p.ldk.seq + col, dk[e] * p.scale);
      store(dvb + key * p.ldv.seq + col, dv[e]);
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// N: keys a dq_kernel step and query rows a dkv_kernel step; NO: the
// output columns a CTA keeps (DP / NO CTAs share each tile's columns)
template <typename T, int DP, int N, int NO = DP>
int launch(const Params& p, int batch, cudaStream_t stream) {
  static_assert(DP % NO == 0, "NO must divide DP");
  constexpr int kSplits = DP / NO;
  constexpr int RS = DP + 16 / (int)sizeof(T);
  constexpr size_t kDqSmem = (size_t)2 * (kBlock + N) * RS * sizeof(T);
  constexpr size_t kDkvSmem =
      (size_t)2 * (kBlock + N) * RS * sizeof(T) + 2 * N * sizeof(float);
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "tiles exceed a block's shared memory");
  const long long programs = (long long)batch * p.heads;
  const long long rows = programs * p.sq;
  const long long q_tiles = (p.sq + kBlock - 1) / kBlock;
  const long long kv_programs = programs / p.group;
  const long long k_tiles = (p.sk + kBlock - 1) / kBlock;
  if ((rows + 7) / 8 > INT_MAX || programs * q_tiles > INT_MAX ||
      kv_programs * k_tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;

  delta_kernel<T><<<(int)((rows + 7) / 8), 256, 0, stream>>>(p, (int)rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  static const int dq_attr = allow_smem(dq_kernel<T, DP, N, NO>, kDqSmem);
  if (dq_attr != 0) return dq_attr;
  dq_kernel<T, DP, N, NO>
      <<<dim3((unsigned)(programs * q_tiles), kSplits), kThreads, kDqSmem,
         stream>>>(p, (int)programs, (int)q_tiles);
  err = (int)cudaGetLastError();
  if (err != 0 || k_tiles == 0) return err;

  static const int dkv_attr =
      allow_smem(dkv_kernel<T, DP, N, NO>, kDkvSmem);
  if (dkv_attr != 0) return dkv_attr;
  dkv_kernel<T, DP, N, NO>
      <<<dim3((unsigned)(kv_programs * k_tiles), kSplits), kThreads,
         kDkvSmem, stream>>>(p, (int)kv_programs);
  return (int)cudaGetLastError();
}

// the bf16 instances at padded width DP, each CTA keeping NO output
// columns, with a ring of kStages stages; MINB: the CTAs an SM should
// hold (so the registers a thread may take)
template <int DP, int NO, int kStages, int MINB>
int launch_wgmma(const WgParams& w, int batch, cudaStream_t stream) {
  static_assert(DP % NO == 0 && DP % 64 == 0, "NO must divide DP");
  constexpr int kSplits = DP / NO;
  constexpr size_t kTile = (size_t)kRows * DP * 2;
  constexpr size_t kBars = (2 * kStages + 1) * sizeof(uint64_t);
  constexpr size_t kDqSmem = 1024 + (2 + 2 * kStages) * kTile + kBars;
  constexpr size_t kDkvSmem = kDqSmem + 2 * kStages * kRows * sizeof(float);
  static_assert(kDkvSmem <= 232448, "tiles exceed a block's shared memory");
  const Params& p = w.p;
  const long long programs = (long long)batch * p.heads;
  const long long rows = programs * p.sq;
  const long long q_tiles = (p.sq + kRows - 1) / kRows;
  const long long kv_programs = programs / p.group;
  const long long k_tiles = (p.sk + kRows - 1) / kRows;
  if ((rows + 7) / 8 > INT_MAX || programs * q_tiles > INT_MAX ||
      kv_programs * k_tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;

  constexpr int kLpr = DP / 8;  // lanes a row in delta_vec_kernel
  if (p.dvec)
    delta_vec_kernel<kLpr><<<(int)((rows + 256 / kLpr - 1) / (256 / kLpr)),
                             256, 0, stream>>>(p, (int)rows);
  else
    delta_kernel<__nv_bfloat16>
        <<<(int)((rows + 7) / 8), 256, 0, stream>>>(p, (int)rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  static const int dq_attr =
      allow_smem(dq_wgmma_kernel<DP, NO, kStages, MINB>, kDqSmem);
  if (dq_attr != 0) return dq_attr;
  dq_wgmma_kernel<DP, NO, kStages, MINB>
      <<<dim3((unsigned)(programs * q_tiles), kSplits), kWgThreads, kDqSmem,
         stream>>>(w, (int)programs, (int)q_tiles);
  err = (int)cudaGetLastError();
  if (err != 0 || k_tiles == 0) return err;

  static const int dkv_attr =
      allow_smem(dkv_wgmma_kernel<DP, NO, kStages, MINB>, kDkvSmem);
  if (dkv_attr != 0) return dkv_attr;
  dkv_wgmma_kernel<DP, NO, kStages, MINB>
      <<<dim3((unsigned)(kv_programs * k_tiles), kSplits), kWgThreads,
         kDkvSmem, stream>>>(w, (int)kv_programs);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry point's arguments, packed by the caller (Python's struct
// format "<10Q24q9if", no padding): the ten pointers; the element strides
// (between sequences, heads and positions) of q, k, v, o, dO, dQ, dK and
// dV; the sizes, flags and the scale.
struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const void* lse;
  void* delta;
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  int batch, heads, group, sq, sk, d, causal, window, bf16;
  float scale;
};
static_assert(sizeof(FlashBwdArgs) == 312,
              "FlashBwdArgs must match <10Q24q9if");

// q, o, dO, dQ: (batch, heads, Sq, D) and k, v, dK, dV: (batch, heads /
// group, Sk, D), each addressed by its own strides with the last dimension
// contiguous, all float32 (bf16 == 0) or all bfloat16 (bf16 == 1); lse
// (from the forward) and delta (scratch) contiguous float32 (batch *
// heads, Sq). Program p = b * heads + h reads kv head h / group of
// sequence b, as in the forward, with the same mask and scale. 1 <= D <=
// 256, group divides heads, Sk >= 0 (Sk = 0 writes dQ = 0 and no dK,
// dV). Returns cudaGetLastError() after the launches; the caller raises if
// it is not cudaSuccess.
namespace {

Params params_of(const FlashBwdArgs* a) {
  Params p{a->q,  a->k,  a->v,  a->o,  a->dout,
           static_cast<const float*>(a->lse), static_cast<float*>(a->delta),
           a->dq, a->dk, a->dv,
           a->lq, a->lk, a->lv, a->lo, a->ldo, a->ldq, a->ldk, a->ldv,
           a->heads, a->group, a->sq, a->sk, a->d, a->causal, a->window, 0,
           a->scale, (float)(a->scale * 1.4426950408889634)};
  const size_t elem = a->bf16 ? 2 : 4;
  p.vec = a->d % (16 / elem) == 0 && aligned16(a->q, a->lq, elem) &&
          aligned16(a->k, a->lk, elem) && aligned16(a->v, a->lv, elem) &&
          aligned16(a->dout, a->ldo, elem);
  p.dvec = a->bf16 && a->d % 8 == 0 && aligned16(a->o, a->lo, elem) &&
           aligned16(a->dout, a->ldo, elem);
  return p;
}

// the bf16 instances' parameters: TMA maps of q, k, v and dO where every
// one is aligned and the driver takes it, else the producer's own loads
void wg_params(WgParams* w, const FlashBwdArgs* a) {
  w->p = params_of(a);
  const int kv_heads = a->heads / a->group;
  w->tma = w->p.vec && a->sk > 0 &&
           encode(&w->mq, &w->dq_, a->q, a->lq, a->batch, a->heads, a->sq,
                  a->d) &&
           encode(&w->mk, &w->dk_, a->k, a->lk, a->batch, kv_heads, a->sk,
                  a->d) &&
           encode(&w->mv, &w->dv_, a->v, a->lv, a->batch, kv_heads, a->sk,
                  a->d) &&
           encode(&w->mdo, &w->ddo_, a->dout, a->ldo, a->batch, a->heads,
                  a->sq, a->d);
}

bool valid(const FlashBwdArgs* a) {
  return a->batch > 0 && a->heads > 0 && a->sq > 0 && a->sk >= 0 &&
         a->d > 0 && a->d <= kMaxHeadDim && a->group > 0 &&
         a->heads % a->group == 0;
}

}  // namespace

// q, o, dO, dQ: (batch, heads, Sq, D) and k, v, dK, dV: (batch, heads /
// group, Sk, D), each addressed by its own strides with the last dimension
// contiguous, all float32 (bf16 == 0) or all bfloat16 (bf16 == 1); lse
// (from the forward) and delta (scratch) contiguous float32 (batch *
// heads, Sq). Program p = b * heads + h reads kv head h / group of
// sequence b, as in the forward, with the same mask and scale. 1 <= D <=
// 256, group divides heads, Sk >= 0 (Sk = 0 writes dQ = 0 and no dK,
// dV). Returns cudaGetLastError() after the launches; the caller raises if
// it is not cudaSuccess.
extern "C" int flash_attention_bwd(const FlashBwdArgs* a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = a->d;
  const int batch = a->batch;
  if (a->bf16) {
    WgParams w;
    wg_params(&w, a);
    if (d <= 64) return launch_wgmma<64, 64, 2, 2>(w, batch, s);
    if (d <= 128) return launch_wgmma<128, 128, 2, 1>(w, batch, s);
    return launch_wgmma<256, 128, 2, 1>(w, batch, s);
  }
  const Params p = params_of(a);
  if (d <= 8) return launch<float, 8, 64>(p, batch, s);
  if (d <= 16) return launch<float, 16, 64>(p, batch, s);
  if (d <= 32) return launch<float, 32, 64>(p, batch, s);
  if (d <= 64) return launch<float, 64, 32>(p, batch, s);
  if (d <= 128) return launch<float, 128, 16>(p, batch, s);
  return launch<float, 256, 16, 128>(p, batch, s);
}

// which design flash_attention_bwd takes for these arguments: 2 the bf16
// wgmma instances with TMA loads, 1 with the producer's own loads, 0 the
// float32 mma.sync instances; -1 for arguments it refuses
extern "C" int flash_attention_bwd_route(const FlashBwdArgs* a) {
  if (!valid(a)) return -1;
  if (!a->bf16) return 0;
  WgParams w;
  wg_params(&w, a);
  return w.tma ? 2 : 1;
}
