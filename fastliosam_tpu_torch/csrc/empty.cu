// An empty kernel, for Hopper (sm_90a): the floor under every kernel time.
//
// The kernel phase of chip_smoke.py times each kernel with
// utils/timing.py: device_ms (back-to-back launches behind a spin kernel,
// between two CUDA events). A launch that does no work still occupies the
// device for its launch and retirement, so the time of this kernel, launched
// through ctypes as every kernel wrapper launches its kernel and timed the
// same way, is the least time any kernel can read there
// (chip_smoke.py: launch_floor_ms).

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches `blocks` x `threads` threads that do nothing on `stream`; returns
// the launch's cudaError_t (0 = success).
extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
