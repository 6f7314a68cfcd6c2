// The cached-plane query of the voxel-hash map in one launch, for Hopper
// (sm_90a).
//
// Replaces, on the cached association path, the Pallas TPU kernels
// scripts/exp_assoc_kernels.py: exp_a_int_indexing (pallas_call at line 61)
// and exp_b_fori_dynamic_slice (pallas_call at lines 92 and 116), the row
// gather table[idx] that the JAX package's map/voxel_hash.py: query_planes
// makes of the cached plane fields after its slot probe (_find_slots). The
// query's plain version (ops/query_cuda.py) is `probes` fingerprint gathers
// and three row gathers with the tensor operations around them.
//
// For each query i: the voxel c = floor(xyz[i] * f32(1 / voxel_size)) (the
// reciprocal multiply that XLA compiles the JAX package's division into);
// its slot is the first of `probes` slots (h0 + k) & (C - 1) whose
// fingerprint matches, where mask[i] holds (an empty slot does not end the
// probe); then the chosen slot's row, or row 0 where nothing matched (the
// JAX package reads the clipped slot -1 -> 0):
//   normal_out[i] = normal[slot], d_out[i] = d[slot],
//   valid_out[i]  = found && plane_valid[slot] > 0 && mask[i].
// Every output word is a copy, so the result equals the plain version's
// bit for bit. The hash and the fingerprint come from voxel_keys.cuh,
// which the association (assoc.cu) and the insert (insert.cu) share.
//
// Bound on the card: bytes. Per live query, `probes` 32-byte fingerprint
// sectors and the chosen row's three sectors (normal, d, plane_valid: three
// arrays); plus the xyz and mask reads and the 17-byte output row.
//
// Design: one thread per query. The probes' fingerprint loads are issued
// before any of them is compared (their addresses do not depend on each
// other), so they are in flight together; then the chosen row is read as
// five 4-byte loads. Masked queries load no fingerprint.

#include <cuda_runtime.h>
#include <stdint.h>

#include "voxel_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxProbes = 8;

__global__ void __launch_bounds__(kThreads)
query_cached_kernel(const int32_t* __restrict__ fp, const float* __restrict__ normal,
                    const float* __restrict__ d, const int32_t* __restrict__ plane_valid,
                    uint32_t cap_mask, const float* __restrict__ xyz,
                    const uint8_t* __restrict__ mask, int n, float inv_vs, int probes,
                    float* __restrict__ normal_out, float* __restrict__ d_out,
                    uint8_t* __restrict__ valid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool live = mask[i] != 0;

  int slot = -1;
  if (live) {
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = (int)floorf(__fmul_rn(__ldg(xyz + 3 * i + a), inv_vs));
    const uint32_t h0 = voxel_keys::hash_slot(c[0], c[1], c[2]) & cap_mask;
    const int32_t want = voxel_keys::fingerprint(c[0], c[1], c[2]);
    int32_t seen[kMaxProbes];
#pragma unroll
    for (int k = 0; k < kMaxProbes; ++k) {
      seen[k] = k < probes ? __ldg(fp + ((h0 + k) & cap_mask)) : 0;
    }
#pragma unroll
    for (int k = 0; k < kMaxProbes; ++k) {
      if (k < probes && slot < 0 && seen[k] == want) slot = (int)((h0 + k) & cap_mask);
    }
  }
  const int sl = slot < 0 ? 0 : slot;
  const size_t r = (size_t)sl;
#pragma unroll
  for (int a = 0; a < 3; ++a) normal_out[3 * (size_t)i + a] = __ldg(normal + 3 * r + a);
  d_out[i] = __ldg(d + r);
  valid_out[i] = (slot >= 0 && __ldg(plane_valid + r) > 0) ? 1 : 0;
}

}  // namespace

// fp (cap,) int32, normal (cap, 3) f32, d (cap,) f32, plane_valid (cap,)
// int32 (cap a power of two), xyz (n, 3) f32, mask (n,) bool bytes, all
// contiguous on the device; writes normal_out (n, 3) f32, d_out (n,) f32 and
// valid_out (n,) bool bytes on `stream`. 1 <= probes <= 8. Returns the
// launch's cudaError_t (0 = success).
extern "C" int query_cached_launch(const int32_t* fp, const float* normal, const float* d,
                                   const int32_t* plane_valid, long long cap,
                                   const float* xyz, const uint8_t* mask, int n,
                                   float inv_vs, int probes, float* normal_out,
                                   float* d_out, uint8_t* valid_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (cap <= 0 || (cap & (cap - 1)) != 0 || cap > (1LL << 31) || probes < 1 ||
      probes > kMaxProbes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  query_cached_kernel<<<blocks, kThreads, 0, stream>>>(
      fp, normal, d, plane_valid, (uint32_t)(cap - 1), xyz, mask, n, inv_vs, probes,
      normal_out, d_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}
