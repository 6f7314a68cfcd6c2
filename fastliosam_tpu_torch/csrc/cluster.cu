// Cross-voxel adjacency of Euclidean clustering, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this in numpy on the
// host, fastliosam_tpu/postprocess/cleanup.py: euclidean_clusters (lines
// 105-124): for every voxel of edge eps and every neighbour voxel
// lexicographically above it (the 13 of the 26 offsets that are
// lexicographically positive), whether some pair of their points lies
// within eps, d2 = (dx*dx + dy*dy) + dz*dz <= eps*eps, in numpy's order.
//
// Inputs: the points sorted by voxel (P, 3) float64; the sorted unique voxel
// keys (V, 3) int64 (lexicographic order); offsets (V + 1,) int64, voxel v
// holding points [offsets[v], offsets[v + 1]); eps2 = eps * eps. Output:
// nb (V, 13) int64, nb[v, o] = the index of the voxel keys[v] + kOff[o]
// when it exists and some cross pair has d2 <= eps2, else -1. Every
// product and sum is rounded on its own (__dmul_rn / __dadd_rn /
// __dsub_rn) as in the knn kernel (csrc/knn.cu), so an edge equals numpy's
// test and the plain version's (ops/cluster_cuda.py: voxel_edges_ref).
//
// Bound on the card: bytes, at the exported map's density (a few points a
// voxel): the points, keys and offsets are read and the edges written; the
// pair tests an edge needs (all pairs where there is none, one where there
// is) are few beside them.
//
// Design (simple and right first): one thread per (voxel, offset). It
// binary-searches the neighbour's key among the keys above its own (a
// positive offset only goes up), then tests the pairs in point order and
// stops at the first hit. The edge is a plain store, with no atomics: the
// result is the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsets = 13;

// the lexicographically positive offsets, in the nested-loop order of
// dx, dy, dz in (-1, 0, 1) (the JAX package's `offsets` with nb <= key
// skipped)
__constant__ int kOff[kOffsets][3] = {
    {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},  {1, -1, -1}, {1, -1, 0}, {1, -1, 1},
    {1, 0, -1}, {1, 0, 0},  {1, 0, 1},  {1, 1, -1}, {1, 1, 0},   {1, 1, 1}};

__device__ __forceinline__ bool key_less(const long long* __restrict__ k, long long x,
                                         long long y, long long z) {
  return k[0] < x || (k[0] == x && (k[1] < y || (k[1] == y && k[2] < z)));
}

__global__ void __launch_bounds__(kThreads)
voxel_edges_kernel(const double* __restrict__ pts, const long long* __restrict__ keys,
                   const long long* __restrict__ offsets, long long v, double eps2,
                   long long* __restrict__ nb) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= v * kOffsets) return;
  const long long a = t / kOffsets;
  const int o = (int)(t - a * kOffsets);
  const long long x = keys[3 * a] + kOff[o][0];
  const long long y = keys[3 * a + 1] + kOff[o][1];
  const long long z = keys[3 * a + 2] + kOff[o][2];
  long long lo = a + 1, hi = v;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (key_less(keys + 3 * mid, x, y, z)) lo = mid + 1;
    else hi = mid;
  }
  bool hit = false;
  if (lo < v && keys[3 * lo] == x && keys[3 * lo + 1] == y && keys[3 * lo + 2] == z) {
    const long long b0 = offsets[lo], b1 = offsets[lo + 1];
    for (long long p = offsets[a]; p < offsets[a + 1] && !hit; ++p) {
      const double px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
      for (long long q = b0; q < b1; ++q) {
        const double dx = __dsub_rn(px, pts[3 * q]);
        const double dy = __dsub_rn(py, pts[3 * q + 1]);
        const double dz = __dsub_rn(pz, pts[3 * q + 2]);
        const double d2 =
            __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
        if (d2 <= eps2) {
          hit = true;
          break;
        }
      }
    }
  }
  nb[t] = hit ? lo : -1;
}

}  // namespace

// pts (P, 3) float64 sorted by voxel, keys (v, 3) int64 sorted and unique,
// offsets (v + 1,) int64, nb (v, 13) int64, all contiguous on the device.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int voxel_edges_launch(const double* pts, const long long* keys,
                                  const long long* offsets, long long v, double eps2,
                                  long long* nb, cudaStream_t stream) {
  if (v <= 0) return 0;
  const long long blocks = (v * kOffsets + kThreads - 1) / kThreads;
  voxel_edges_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(pts, keys, offsets, v, eps2, nb);
  return static_cast<int>(cudaGetLastError());
}
