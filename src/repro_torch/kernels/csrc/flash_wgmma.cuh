// Hopper tiles for the flash kernels' bf16 instances (the forward,
// flash_attention.cu, and the gradient, flash_attention_bwd.cu): tiles of
// 64 rows in shared memory, each split into panels of 64 columns (128
// bytes a row) in the 128-byte swizzle that TMA writes and wgmma reads;
// mbarriers; TMA loads; and the three wgmma shapes both issue (m64n64k16
// from shared memory, m64n64k16 and m64n128k16 with A from registers), all
// bf16 with float32 accumulators. Separate from flash_tiles.cuh, whose
// mma.sync tiles the float32 instances keep.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_wgmma {

constexpr int kRows = 64;             // rows of a tile: a wgmma's M
constexpr int kPanel = kRows * 128;   // bytes of one 64-column panel
constexpr int kSwizzleAtom = 1024;    // 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) of a bf16 tile of kRows rows: panel c / 64,
// row r at 128 r, its 16-byte chunks XORed with r mod 8 (the hardware
// swizzles on address bits, so a tile starts 1024-aligned)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  const int chunk = ((c & 63) >> 3) ^ (r & 7);
  return (uint32_t)((c >> 6) * kPanel + r * 128 + chunk * 16 + (c & 7) * 2);
}

// ---- mbarriers ----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// arrive, and expect `bytes` more from TMA in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// 2^x on the special-function unit, a result below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// this thread's warp, as a value the compiler knows to be the same across
// the warp (a lane's own tid / 32 it does not): wgmma under a branch on it
// is then not taken for divergent and serialized
__device__ __forceinline__ int warp_uniform() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

// set the registers a thread of this warpgroup owns to N, for the code
// that follows: up, from those other warpgroups gave back, or down
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ----------------------------------------------------------------
// box at coordinates (c0, c1, c2, c3) of a rank-4 map into shared memory,
// completing `bytes` of the barrier's expected transactions
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma --------------------------------------------------------------
// shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading byte offset (the stride between 64-element panels of an
// MN-major operand; unused for K-major) and the stride byte offset (8
// rows, 1024 bytes, for both)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(kSwizzleAtom >> 4) << 32) | (1ull << 62);
}
// the K-major operand of a tile (rows x 64-column panels) for k-step ks
// (columns 16 ks .. 16 ks + 15): panel ks / 4, 32 bytes a step within it
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return desc(tile + (ks >> 2) * kPanel + (ks & 3) * 32, 16);
}
// the MN-major operand (rows are the K of the product) for k-step kr
// (rows 16 kr .. 16 kr + 15) from column c0 (a multiple of 64) on
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kr, int c0) {
  return desc(tile + (c0 >> 6) * kPanel + kr * 2 * kSwizzleAtom, kPanel);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
// (groups complete in the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep an accumulator's registers where the asynchronous products wrote
// them: no access is moved across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d = A . B^T (acc 0) or d += A . B^T (acc 1): A (64 x 16) and B (N x 16)
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A . B: A (64 x 16) as bf16 fragments in registers, B (16 x N)
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B: A (64 x 16) as bf16 fragments in registers, B (16 x N)
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B over the N = NO columns of the m64nNOk16 shapes
template <int NO>
__device__ __forceinline__ void wgmma_rs(float (&d)[NO / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// the A fragments of a k16 step from a 64 x 64 accumulator tile's
// registers (its columns 16 c .. 16 c + 15), rounded to bf16 to nearest
// even: a warpgroup accumulator holds, for each 8-column block j, rows
// (g, g, g + 8, g + 8) and columns (2t, 2t + 1, 2t, 2t + 1) of the warp's
// 16 rows, and the A fragment of m64nNk16 takes (g, 2t..2t+1), (g + 8,
// 2t..2t+1), (g, 2t+8..2t+9), (g + 8, 2t+8..2t+9)
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&s)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const __nv_bfloat162 v0 = __floats2bfloat162_rn(s[8 * c], s[8 * c + 1]);
    const __nv_bfloat162 v1 = __floats2bfloat162_rn(s[8 * c + 2], s[8 * c + 3]);
    const __nv_bfloat162 v2 = __floats2bfloat162_rn(s[8 * c + 4], s[8 * c + 5]);
    const __nv_bfloat162 v3 = __floats2bfloat162_rn(s[8 * c + 6], s[8 * c + 7]);
    a[c][0] = *reinterpret_cast<const uint32_t*>(&v0);
    a[c][1] = *reinterpret_cast<const uint32_t*>(&v1);
    a[c][2] = *reinterpret_cast<const uint32_t*>(&v2);
    a[c][3] = *reinterpret_cast<const uint32_t*>(&v3);
  }
}

}  // namespace flash_wgmma
