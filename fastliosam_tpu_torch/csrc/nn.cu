// Fused brute-force nearest neighbours for loop-closure ICP, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel fastliosam_tpu/ops/nn_pallas.py:
// nearest_neighbors_pallas (body _nn_kernel, pallas_call at line 100).
// For each source point: the index and squared distance of the nearest
// valid destination point, with the TPU kernel's semantics:
//   * distance = (|d|^2 + |s|^2) - 2 d.s (the same expansion as the plain
//     version, so values and ties agree with it);
//   * masked destinations never win (they count as 1e12);
//   * ties go to the lowest destination index (strict < while scanning
//     destinations in increasing index);
//   * with every destination masked the result is d2 = 1e12, idx = 0;
//   * the returned d2 is clamped to >= 0.
//
// Bound on the card: operations. About 8 float32 operations per
// (source, destination) pair — 16,384^2 pairs on the loop-verification
// path is ~2.15 GFLOP, ~32 us at the H100's 67 TFLOP/s float32 (non-tensor)
// rate; TF32 tensor cores are ruled out by the geometry-precision policy.
// The call reads ~0.4 MB, so memory is no limit.
//
// Design (simple and right first): one thread owns one source point and
// keeps its running (min, argmin) in registers; the block stages tiles of
// destinations into shared memory as float4 (x, y, z, |d|^2 or -1 for a
// masked point) and every thread scans the tile in index order. The grid
// is one block per 128 source points, so 16,384 sources fill 128 blocks
// (~4 warps per SM): the kernel is latency-bound at this size, which a
// later version can fix by splitting the destinations across blocks too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kBig = 1.0e12f;

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ src, int n, const float* __restrict__ dst,
          const uint8_t* __restrict__ dst_mask, int m,
          int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (i < n) {
    sx = src[3 * i];
    sy = src[3 * i + 1];
    sz = src[3 * i + 2];
  }
  const float sn = __fadd_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
                             __fmul_rn(sz, sz));
  float best = kBig;
  int best_j = 0;
  for (int base = 0; base < m; base += kTile) {
    const int len = min(kTile, m - base);
    __syncthreads();  // previous tile fully consumed
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int j = base + t;
      const float x = dst[3 * j], y = dst[3 * j + 1], z = dst[3 * j + 2];
      const float dn = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      tile[t] = make_float4(x, y, z, dst_mask[j] ? dn : -1.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const float4 d = tile[t];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(sx, d.x), __fmul_rn(sy, d.y)),
                                  __fmul_rn(sz, d.z));
      float dist = __fsub_rn(__fadd_rn(d.w, sn), __fmul_rn(2.0f, dot));
      dist = d.w < 0.0f ? kBig : dist;
      if (dist < best) {
        best = dist;
        best_j = base + t;
      }
    }
  }
  if (i < n) {
    idx_out[i] = best_j;
    d2_out[i] = fmaxf(best, 0.0f);
  }
}

}  // namespace

// src (n, 3) f32, dst (m, 3) f32, dst_mask (m,) bool bytes, all contiguous on
// the device; writes idx (n,) int32 and d2 (n,) f32 on `stream`. Returns the
// launch's cudaError_t (0 = success).
extern "C" int nn_launch(const float* src, int n, const float* dst,
                         const uint8_t* dst_mask, int m, int32_t* idx_out,
                         float* d2_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_kernel<<<blocks, kThreads, 0, stream>>>(src, n, dst, dst_mask, m, idx_out,
                                             d2_out);
  return static_cast<int>(cudaGetLastError());
}
