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
// Bound on the card: operations. 8 float32 operations per (source,
// destination) pair: at 16,384^2 that is ~2.15 GFLOP, 32 us at the H100's
// 67 TFLOP/s float32 rate. That rate counts an FMA as two operations, and
// this arithmetic may not contract (each product and sum is rounded on its
// own, as the plain version rounds it), so its ceiling is the issue rate:
// the compiled loop spends about 10 instructions per pair (3 FMUL, 4 FADD,
// FSETP, FSEL, SEL, plus a shared load and an index add per destination
// shared by the 4 sources of a thread), which at 4 warp-instructions per
// clock per SM and ~1.9 GHz is ~0.085 ms at 16,384^2. The
// call reads ~0.4 MB, so memory is no limit. TF32 tensor cores are ruled
// out by the geometry-precision policy.
//
// Design, three launches per call:
//   1. nn_pack: destinations into an (M', 4) float4 array (x, y, z, w),
//      w = |d|^2 for a valid point and +inf for a masked or padding one.
//      (|d|^2 + |s|^2) - 2 d.s is then w + |s|^2 + d.s', with the source
//      pre-scaled to s' = -2 s: scaling by a power of two commutes with
//      rounding, so the per-pair arithmetic gives the same bits as the
//      expansion, barring underflow. A w of +inf makes the distance +inf
//      (or NaN), which never beats the initial 1e12: the same outcome as
//      the select to 1e12.
//   2. nn_slices: R = 4 sources per thread in registers, 128 threads, so
//      one broadcast shared-memory load of a destination feeds 4
//      independent chains (instruction-level parallelism, 4x fewer shared
//      loads per pair). The destinations are split into S slices across
//      blockIdx.y so the grid holds ~4 blocks per SM (32 x 16 = 512 blocks
//      at 16,384^2); a block scans its slice in 256-point tiles staged with
//      cp.async, double-buffered, so the load of tile k+1 overlaps the scan
//      of tile k. Each block writes its slice's (d2, idx), unclamped, to a
//      (S, n) scratch.
//   3. nn_merge: one thread per source takes the slices in order with a
//      strict <. Each slice's best is the lowest index among its ties, and
//      slices cover increasing index ranges, so this is the lexicographic
//      min of (d2, idx): the words of a single pass, the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 4;                        // sources per thread
constexpr int kSrcPerBlock = kThreads * kR;  // 512
constexpr int kTile = 256;                   // destinations per stage
constexpr int kTargetBlocks = 4 * 132;       // ~4 blocks per SM
constexpr float kBig = 1.0e12f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void nn_pack(const float* __restrict__ dst, const uint8_t* __restrict__ dst_mask,
                        int m, int m_pad, float4* __restrict__ packed) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < m_pad;
       j += gridDim.x * blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));  // w = +inf
    if (j < m) {
      v.x = dst[3 * j];
      v.y = dst[3 * j + 1];
      v.z = dst[3 * j + 2];
      if (dst_mask[j]) v.w = norm2(v.x, v.y, v.z);
    }
    packed[j] = v;
  }
}

// stage kTile float4s (4 KB) from global to shared, 16 bytes per cp.async
__device__ __forceinline__ void stage(float4* tile, const float4* src) {
#pragma unroll
  for (int t = threadIdx.x; t < kTile; t += kThreads) cp_async16(tile + t, src + t);
}

__global__ void __launch_bounds__(kThreads)
nn_slices(const float* __restrict__ src, int n, const float4* __restrict__ packed,
          int slice_len, float* __restrict__ part_d, int32_t* __restrict__ part_i) {
  __shared__ __align__(16) float4 tile[2][kTile];
  const int j0 = blockIdx.y * slice_len;
  const int ntiles = slice_len / kTile;
  const int i0 = blockIdx.x * kSrcPerBlock + threadIdx.x;

  stage(tile[0], packed + j0);
  cp_async_commit();

  float sx[kR], sy[kR], sz[kR], sn[kR], best[kR];
  int best_j[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r * kThreads;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (i < n) {
      x = src[3 * i];
      y = src[3 * i + 1];
      z = src[3 * i + 2];
    }
    sn[r] = norm2(x, y, z);
    sx[r] = __fmul_rn(-2.0f, x);
    sy[r] = __fmul_rn(-2.0f, y);
    sz[r] = __fmul_rn(-2.0f, z);
    best[r] = kBig;
    best_j[r] = 0;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) stage(tile[(t + 1) & 1], packed + j0 + (t + 1) * kTile);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();  // this thread's copies of tile t have landed
    __syncthreads();      // and everyone's
    const float4* tl = tile[t & 1];
    const int jb = j0 + t * kTile;
#pragma unroll 16
    for (int k = 0; k < kTile; ++k) {
      const float4 d = tl[k];  // one broadcast load feeds kR chains
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float dot2 = __fadd_rn(
            __fadd_rn(__fmul_rn(sx[r], d.x), __fmul_rn(sy[r], d.y)), __fmul_rn(sz[r], d.z));
        const float dist = __fadd_rn(__fadd_rn(d.w, sn[r]), dot2);
        if (dist < best[r]) {
          best[r] = dist;
          best_j[r] = jb + k;
        }
      }
    }
    __syncthreads();  // tile t fully read before iteration t+1 restages it
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r * kThreads;
    if (i < n) {
      part_d[(size_t)blockIdx.y * n + i] = best[r];
      part_i[(size_t)blockIdx.y * n + i] = best_j[r];
    }
  }
}

__global__ void nn_merge(const float* __restrict__ part_d, const int32_t* __restrict__ part_i,
                         int n, int slices, int32_t* __restrict__ idx_out,
                         float* __restrict__ d2_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = kBig;
  int best_j = 0;
  for (int s = 0; s < slices; ++s) {
    const float d = part_d[(size_t)s * n + i];
    if (d < best) {
      best = d;
      best_j = part_i[(size_t)s * n + i];
    }
  }
  idx_out[i] = best_j;
  d2_out[i] = fmaxf(best, 0.0f);
}

}  // namespace

// The split of m destinations for n sources: returns the number of slices
// S and writes the slice length (a multiple of the tile) to *slice_len.
// The scratch the caller allocates: packed (S * slice_len, 4) float32,
// part_d (S, n) float32, part_i (S, n) int32.
extern "C" int nn_plan(int n, int m, int* slice_len) {
  const int xblocks = n > 0 ? (n + kSrcPerBlock - 1) / kSrcPerBlock : 1;
  const int tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  int slices = (kTargetBlocks + xblocks - 1) / xblocks;
  slices = slices < 1 ? 1 : (slices > tiles ? tiles : slices);
  const int per_slice = (tiles + slices - 1) / slices;
  *slice_len = per_slice * kTile;
  return (tiles + per_slice - 1) / per_slice;
}

// src (n, 3) f32, dst (m, 3) f32, dst_mask (m,) bool bytes, all contiguous
// on the device, with the scratch of nn_plan(n, m); writes idx (n,) int32
// and d2 (n,) f32 on `stream`. Returns the launches' cudaError_t (0 =
// success).
extern "C" int nn_launch(const float* src, int n, const float* dst, const uint8_t* dst_mask,
                         int m, int slices, int slice_len, float4* packed, float* part_d,
                         int32_t* part_i, int32_t* idx_out, float* d2_out,
                         cudaStream_t stream) {
  if (n <= 0) return 0;
  if (slices < 1 || slice_len <= 0 || slice_len % kTile != 0 ||
      (long long)slices * slice_len < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_pad = slices * slice_len;
  const int pack_blocks = (m_pad + 255) / 256 < 1024 ? (m_pad + 255) / 256 : 1024;
  nn_pack<<<pack_blocks, 256, 0, stream>>>(dst, dst_mask, m, m_pad, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kSrcPerBlock - 1) / kSrcPerBlock, slices);
  nn_slices<<<grid, kThreads, 0, stream>>>(src, n, packed, slice_len, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_merge<<<(n + 255) / 256, 256, 0, stream>>>(part_d, part_i, n, slices, idx_out, d2_out);
  return static_cast<int>(cudaGetLastError());
}
