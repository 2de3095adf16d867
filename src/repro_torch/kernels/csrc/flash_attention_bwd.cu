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
// key) pair takes five (s and dP twice: once for dQ, once for dK and dV;
// dV, dQ and dK once), all on the tensor cores as the forward's are: bf16
// at 989 TFLOP/s, float32 as 3xTF32 at a third of TF32's 495 TFLOP/s.
//
// Design (FlashAttention-2's split, three launches from one entry point):
// - delta_kernel forms D, one warp a row.
// - dq_kernel gives a CTA of 4 warps to each (program, 64 query rows); it
//   walks the key tiles the mask lets those rows see, recomputes s and
//   dP = dO V^T from shared-memory tiles, and keeps dQ in registers.
// - dkv_kernel gives a CTA of 4 warps to each (sequence, kv head, 64
//   keys); it walks the group's query heads and, for each, the query
//   tiles that can see its keys, and keeps dK and dV in registers. The
//   sum over the group's heads happens inside the CTA: no floating-point
//   atomics, so the same inputs give the same bits.
// - At D = 256 the accumulators would not fit: dK and dV for 16 keys a
//   warp are 256 floats a thread, the whole register file. So two CTAs
//   share each tile (blockIdx.y), each keeping half of dQ's, dK's and
//   dV's columns (128, as the D = 128 instances keep) and recomputing s
//   and dP over the full D: four products of the pair's seven run twice.
//   The float32 tiles at D = 256 take 16 rows a step, so that the dq
//   CTA's 2 (64 + 16) rows of 260 floats fit in 227 KB.
// - Products are the forward's tiles (flash_tiles.cuh): with the key and
//   query roles swapped, qk_tile forms s^T and dP^T with 16 keys a warp,
//   and pv_tile takes P^T or dS^T from the same registers as its A
//   fragment against dO, q or k rows. bf16 rounds P and dS to bf16 for
//   those products (sums in float32); float32 goes through 3xTF32, so dS
//   is never a single TF32 product.
// - One stage of tiles a step, loaded by cp.async: this is the simple
//   version; a ring of stages, wgmma and TMA are later work.
// - Tiles wholly outside the causal or window band are skipped per CTA
//   and per warp, and each element is masked as in the forward.
// - FMA contraction is allowed in this library.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

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
extern "C" int flash_attention_bwd(const FlashBwdArgs* a, void* stream) {
  if (a->batch <= 0 || a->heads <= 0 || a->sq <= 0 || a->sk < 0 ||
      a->d <= 0 || a->d > kMaxHeadDim || a->group <= 0 ||
      a->heads % a->group != 0)
    return (int)cudaErrorInvalidValue;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = a->d;
  const int batch = a->batch;
  if (a->bf16) {
    if (d <= 16) return launch<__nv_bfloat16, 16, 64>(p, batch, s);
    if (d <= 32) return launch<__nv_bfloat16, 32, 64>(p, batch, s);
    if (d <= 64) return launch<__nv_bfloat16, 64, 64>(p, batch, s);
    if (d <= 128) return launch<__nv_bfloat16, 128, 32>(p, batch, s);
    return launch<__nv_bfloat16, 256, 32, 128>(p, batch, s);
  }
  if (d <= 8) return launch<float, 8, 64>(p, batch, s);
  if (d <= 16) return launch<float, 16, 64>(p, batch, s);
  if (d <= 32) return launch<float, 32, 64>(p, batch, s);
  if (d <= 64) return launch<float, 64, 32>(p, batch, s);
  if (d <= 128) return launch<float, 128, 16>(p, batch, s);
  return launch<float, 256, 16, 128>(p, batch, s);
}
