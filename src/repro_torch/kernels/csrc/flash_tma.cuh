// How the flash kernels' bf16 instances (flash_attention.cu and
// flash_attention_bwd.cu) bring an operand's tiles of 64 rows into shared
// memory, in the 128-byte swizzle of flash_wgmma.cuh: on the host, a
// rank-4 TMA map of a (batch, heads, n, d) operand read through its
// strides (cuTensorMapEncodeTiled, found through the runtime, so the
// libraries need no libcuda); on the device, a tile by TMA from that map,
// or by the 32 lanes of a warp's own loads where the operand is not
// 16-byte aligned.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "flash_wgmma.cuh"

namespace flash_tma {

using flash_tiles::Layout;
using flash_wgmma::kRows;

// where a rank-4 TMA map keeps the positions, heads and sequences of an
// operand (dims 1 .. 3, ordered by increasing stride; dim 0 is D)
struct MapDims {
  int seq, head, batch;
};

__device__ __forceinline__ int pick(const MapDims& m, int dim, int pos, int h,
                                    int b) {
  return m.seq == dim ? pos : m.head == dim ? h : b;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (flash_wgmma::smem_u32(p) & 1023)) & 1023);
}

// rows [pos0, pos0 + 64) of (sequence b, head h) of an operand into a
// swizzled tile: DP / 64 boxes of 64 columns, by the calling lane
template <int DP>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         const MapDims& md, uint64_t* bar,
                                         int pos0, int h, int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    flash_wgmma::tma_load_4d(dst + c * flash_wgmma::kPanel, map, bar, c * 64,
                             pick(md, 1, pos0, h, b), pick(md, 2, pos0, h, b),
                             pick(md, 3, pos0, h, b));
}

// the same tile by the 32 lanes' own loads (any alignment), zero past
// position n and column d
template <int DP>
__device__ __forceinline__ void plain_tile(unsigned char* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int pos0, int n,
                                           int d, int lane) {
  for (int i = lane; i < kRows * DP; i += 32) {
    const int r = i / DP;
    const int c = i - r * DP;
    const int pos = pos0 + r;
    *reinterpret_cast<__nv_bfloat16*>(dst + flash_wgmma::swizzled(r, c)) =
        pos < n && c < d ? src[pos * stride + c] : __float2bfloat16(0.f);
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no libcuda link)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a rank-4 map of a bf16 (batch, heads, n, d) operand with layout l: dim 0
// is D, then positions, heads and sequences by increasing stride (the
// order TMA is sure to take); boxes of 64 columns by kRows positions,
// 128-byte swizzle, zeros out of bounds. False if the encoder refuses it.
inline bool encode(CUtensorMap* map, MapDims* dims, const void* ptr,
                   const Layout& l, int batch, int heads, int n, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  struct Dim {
    long long stride;
    int size, what;
  } o[3] = {{l.seq, n, 0}, {l.head, heads, 1}, {l.batch, batch, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && o[j].stride < o[j - 1].stride; --j) {
      const Dim x = o[j];
      o[j] = o[j - 1];
      o[j - 1] = x;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (o[i].stride <= 0) return false;
    gdim[i + 1] = (cuuint64_t)o[i].size;
    gstride[i] = (cuuint64_t)o[i].stride * 2;
    if (o[i].what == 0) {
      box[i + 1] = kRows;
      dims->seq = i + 1;
    } else if (o[i].what == 1) {
      dims->head = i + 1;
    } else {
      dims->batch = i + 1;
    }
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash_tma
