// A kernel that does nothing: the launch floor.
//
// Not a port of any TPU kernel. chip_smoke.py times it launched the way
// the port's kernels are (one ctypes call with the stream, one CTA of one
// warp), so the times of the small-batch kernels can be read beside what
// a launch alone costs on the card.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
