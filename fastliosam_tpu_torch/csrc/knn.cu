// Brute-force k nearest neighbours in float64, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this in numpy on the
// host. It is the pair work of the post-processing toolbox:
//   * statistical outlier removal, fastliosam_tpu/postprocess/cleanup.py:
//     _knn_mean_dists (lines 13-22), a chunked (2048, N, 3) float64
//     broadcast with the diagonal set to inf (np.fill_diagonal) and
//     np.partition for the k smallest;
//   * the 2D ICP's nearest neighbour, fastliosam_tpu/postprocess/align.py:
//     icp_2d_with_scale (d2.argmin(1), lines 118-120), at k = 1 with the
//     2D points padded with z = 0 (d2 gains +0.0: unchanged).
//
// For each query i of src (N, 3): the k destinations j of dst (M, 3) with
// the smallest d2 = (dx*dx + dy*dy) + dz*dz, dx = src[i].x - dst[j].x,
// ascending, ties to the lowest j (lexicographic (d2, j)); with exclude_self
// (src is dst) j == i is skipped. Every product and sum is rounded on its
// own (__dmul_rn / __dadd_rn / __dsub_rn), in numpy's order, so nvcc cannot
// contract them into FMAs: d2 equals numpy's and the plain version's
// (ops/kneighbors_cuda.py: knn_ref) bit for bit. Finite inputs; k <= M (minus one
// with exclude_self), 1 <= k <= 32.
//
// Bound on the card: operations. 8 FP64 operations a pair (3 subtractions,
// 3 multiplications, 2 additions) over N x M pairs; each input point is read
// once from device memory (24 bytes) and 16 bytes a neighbour written.
// At the exported map's 348,097 points and k = 20 that is ~9.7e11
// operations (~29 ms at 33.5 TFLOP/s) against ~128 MB (~0.04 ms at
// 3.35 TB/s): the FP64 pipes, not memory, set the floor.
//
// Design (simple and right first): one thread per query; each block stages
// tiles of kTile destinations in shared memory (every thread of the block
// reads the same point: a broadcast), and each thread keeps a sorted
// insertion list of its k best in local memory. A pair enters the list only
// when d2 < the current k-th (strict: a later equal d2 never displaces an
// earlier index), and shifts past strictly larger entries only, so ties
// keep ascending indices. After the first tiles an insertion is rare, so
// the loop is the 8 operations and one compare a pair.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;  // destinations a shared-memory tile (12 KB)
constexpr int kMaxK = 32;

__global__ void __launch_bounds__(kThreads)
knn_kernel(const double* __restrict__ src, long long n, const double* __restrict__ dst,
           long long m, int k, int exclude_self, double* __restrict__ d2_out,
           long long* __restrict__ idx_out) {
  __shared__ double tile[kTile * 3];
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool live = i < n;
  double qx = 0.0, qy = 0.0, qz = 0.0;
  if (live) {
    qx = src[3 * i];
    qy = src[3 * i + 1];
    qz = src[3 * i + 2];
  }
  double best_d[kMaxK];
  long long best_j[kMaxK];
  for (int p = 0; p < k; ++p) {
    best_d[p] = CUDART_INF;
    best_j[p] = -1;
  }
  double worst = CUDART_INF;
  for (long long base = 0; base < m; base += kTile) {
    const int cnt = (int)(m - base < kTile ? m - base : kTile);
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * cnt; e += kThreads) tile[e] = dst[3 * base + e];
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < cnt; ++t) {
      const double dx = __dsub_rn(qx, tile[3 * t]);
      const double dy = __dsub_rn(qy, tile[3 * t + 1]);
      const double dz = __dsub_rn(qz, tile[3 * t + 2]);
      const double d2 =
          __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
      if (d2 < worst) {
        const long long j = base + t;
        if (exclude_self && j == i) continue;
        int p = k - 1;
        while (p > 0 && best_d[p - 1] > d2) {
          best_d[p] = best_d[p - 1];
          best_j[p] = best_j[p - 1];
          --p;
        }
        best_d[p] = d2;
        best_j[p] = j;
        worst = best_d[k - 1];
      }
    }
  }
  if (!live) return;
  for (int p = 0; p < k; ++p) {
    d2_out[i * k + p] = best_d[p];
    idx_out[i * k + p] = best_j[p];
  }
}

}  // namespace

// src (n, 3) and dst (m, 3) float64, d2_out (n, k) float64 and idx_out (n, k)
// int64, all contiguous on the device. Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
extern "C" int knn_launch(const double* src, long long n, const double* dst, long long m,
                          int k, int exclude_self, double* d2_out, long long* idx_out,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kMaxK || m < k + (exclude_self ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  knn_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(src, n, dst, m, k, exclude_self,
                                                        d2_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
