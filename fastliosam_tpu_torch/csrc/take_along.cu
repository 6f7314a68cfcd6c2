// 2-D take_along_axis of a float32 table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/exp_pallas_gather.py:
// pallas_tal (pallas_call at line 92, axis 0), pallas_tal1 (line 122,
// axis 1) and pallas_big (line 152, axis 0 on a (2^19, 128) table):
//   axis 0: out[i, j] = tab[idx[i, j], j]
//   axis 1: out[i, j] = tab[i, idx[i, j]]
// idx is int32 and has the output's shape. Out-of-range indices follow
// jnp.take_along_axis's default mode: a negative index wraps once (-1 ->
// last), and an index still out of range gives NaN (mode "fill").
//
// Bound on the card: bytes. Every output element is one random 4-byte read
// (a 32-byte sector each, unless neighbours share one), plus the
// contiguous index read and output write. At the map-size shape the
// 256 MB table does not fit the 50 MB L2, so the sectors come from HBM.
//
// Design (simple and right first): one thread per output element in
// row-major output order, so index reads and output writes coalesce; on
// axis 0 neighbouring threads read neighbouring columns of random rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
take_along_kernel(const float* __restrict__ tab, long long rows, long long cols,
                  const int32_t* __restrict__ idx, long long out_rows,
                  long long out_cols, int axis, float* __restrict__ out) {
  const long long total = out_rows * out_cols;
  const long long extent = axis == 0 ? rows : cols;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const long long i = e / out_cols;
    const long long j = e - i * out_cols;
    long long k = idx[e];
    if (k < 0) k += extent;
    float v = __int_as_float(0x7fc00000);  // NaN, as jnp's fill mode
    if (k >= 0 && k < extent) v = axis == 0 ? tab[k * cols + j] : tab[i * cols + k];
    out[e] = v;
  }
}

}  // namespace

// tab (rows, cols) f32, idx (out_rows, out_cols) int32, out like idx; all
// contiguous on the device. Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int take_along_launch(const float* tab, long long rows, long long cols,
                                 const int32_t* idx, long long out_rows,
                                 long long out_cols, int axis, float* out,
                                 cudaStream_t stream) {
  const long long total = out_rows * out_cols;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  take_along_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      tab, rows, cols, idx, out_rows, out_cols, axis, out);
  return static_cast<int>(cudaGetLastError());
}
