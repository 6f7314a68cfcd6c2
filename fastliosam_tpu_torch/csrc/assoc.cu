// The voxel-hash association's merged moments in one launch, for Hopper
// (sm_90a).
//
// Replaces, on the association path, the Pallas TPU kernels
// scripts/exp_assoc_kernels.py: exp_a_int_indexing (pallas_call at line 61)
// and exp_b_fori_dynamic_slice (pallas_call at lines 92 and 116). Those
// two were building blocks of a fused association (probe, gather and merge
// in one kernel against a table held in fast memory, DESIGN.md section
// 2c2) that Mosaic could not express. Until this kernel the port ran them
// as separate row gathers (csrc/gather.cu): per pool, `probes` fingerprint
// gathers and one moment gather, with ~120 small tensor operations around
// them for the int64-emulated hash, the probe selects and the merge.
//
// For each query i and each pool p in order (P = 3 for merged3, 7 for
// merged): hash and fingerprint the voxel pools[p, i]; take the first of
// `probes` slots (h0 + k) & (C - 1) whose fingerprint matches, where
// mask[i] holds; read that slot's moment row [c, s (3), o (6)] (zeros when
// nothing matched) and add it, re-referenced from its voxel centre to the
// centre of coords0[i], to the query's sums. Output row i is
//   [tot_c, tot_s (3), tot_o (3x3, row-major)]
// exactly as map/voxel_hash.py's plain version accumulates it: every sum
// starts at +0.0 and each product and sum is rounded on its own
// (__fadd_rn/__fmul_rn, no contraction), in the plain version's order;
// element (a, b) of tot_o is
//   ((((acc + o_ab) + s_a dc_b) + s_b dc_a) + c (dc_a dc_b)),
// which keeps all nine entries (the two triangles need not agree bitwise).
// The hash, the fingerprint and the voxel centre come from voxel_keys.cuh,
// which the map insert's kernel (insert.cu) shares.
//
// Bound on the card: bytes. Per query and pool, `probes` 32-byte
// fingerprint sectors and, where a slot is found, the 40-byte moment row
// (two sectors); plus the pools' and coords0's coordinates, the mask and
// the 52-byte output row. At 8192 queries x 3 pools x 2 probes that is
// ~3.9 MB, ~0.0012 ms at 3.35 TB/s. The (2^19, 10) moment table (21 MB)
// and the fingerprints (2 MB) fit the 50 MB L2, so the call is really
// bound by two dependent L2 round trips (fingerprints, then rows) and its
// launch.
//
// Lanes (the batched rollout, eval/batch_eval.py): the map is B lane-major
// tables (fp (B, C), moments (B, C, 10)) and the queries B blocks of n/B;
// query i belongs to lane b = i / (n/B) and probes only its own table,
// slots b*C + ((h0 + k) & (C - 1)). With B = 1 this is the unbatched call:
// the same launch and the same words.
//
// Design: one thread per query. All P x probes fingerprint loads are issued
// before any of them is compared (their addresses do not depend on each
// other), so they are in flight together; then the found rows are read as
// five float2 loads each (a row is 40 bytes, 8- but not 16-byte aligned),
// and the sums are formed in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "voxel_keys.cuh"

namespace {

using voxel_keys::center;

constexpr int kThreads = 128;
constexpr int kMaxProbes = 8;

template <int P>
__global__ void __launch_bounds__(kThreads)
merged_moments_kernel(const int32_t* __restrict__ fp, const float2* __restrict__ moments,
                      uint32_t cap_mask, const int32_t* __restrict__ pools, int n,
                      int per_lane, const int32_t* __restrict__ coords0,
                      const uint8_t* __restrict__ mask, float vs, int probes,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool live = mask[i] != 0;
  // this query's lane: its own table
  const size_t base = (size_t)(i / per_lane) * ((size_t)cap_mask + 1);
  fp += base;
  moments += base * 5;

  int vc[P][3];
  uint32_t h0[P];
  int32_t want[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int32_t* c = pools + ((size_t)p * n + i) * 3;
    vc[p][0] = c[0];
    vc[p][1] = c[1];
    vc[p][2] = c[2];
    h0[p] = voxel_keys::hash_slot(vc[p][0], vc[p][1], vc[p][2]) & cap_mask;
    want[p] = voxel_keys::fingerprint(vc[p][0], vc[p][1], vc[p][2]);
  }

  // every probe of every pool: independent loads, all in flight together
  int32_t seen[P][kMaxProbes];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < kMaxProbes; ++k) {
      seen[p][k] = k < probes ? __ldg(fp + ((h0[p] + k) & cap_mask)) : 0;
    }
  }
  int slot[P];  // -1: not found
#pragma unroll
  for (int p = 0; p < P; ++p) {
    slot[p] = -1;
#pragma unroll
    for (int k = 0; k < kMaxProbes; ++k) {
      if (k < probes && slot[p] < 0 && live && seen[p][k] == want[p]) {
        slot[p] = (int)((h0[p] + k) & cap_mask);
      }
    }
  }

  float cen0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) cen0[a] = center(coords0[3 * i + a], vs);
  // index into [xx, xy, xz, yy, yz, zz] of outer-product entry (a, b)
  const int sym[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
  float tc = 0.0f, ts[3] = {0.0f, 0.0f, 0.0f};
  float to[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) to[e] = 0.0f;

#pragma unroll
  for (int p = 0; p < P; ++p) {
    float mrow[10];
#pragma unroll
    for (int w = 0; w < 5; ++w) {
      const float2 v = slot[p] >= 0 ? __ldg(moments + (size_t)slot[p] * 5 + w)
                                    : make_float2(0.0f, 0.0f);
      mrow[2 * w] = v.x;
      mrow[2 * w + 1] = v.y;
    }
    float dc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) dc[a] = __fsub_rn(center(vc[p][a], vs), cen0[a]);
    const float c = mrow[0];
    tc = __fadd_rn(tc, c);
#pragma unroll
    for (int a = 0; a < 3; ++a) ts[a] = __fadd_rn(__fadd_rn(ts[a], mrow[1 + a]), __fmul_rn(c, dc[a]));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float acc = __fadd_rn(to[3 * a + b], mrow[4 + sym[3 * a + b]]);
        acc = __fadd_rn(acc, __fmul_rn(mrow[1 + a], dc[b]));
        acc = __fadd_rn(acc, __fmul_rn(mrow[1 + b], dc[a]));
        to[3 * a + b] = __fadd_rn(acc, __fmul_rn(c, __fmul_rn(dc[a], dc[b])));
      }
    }
  }

  float* o = out + (size_t)i * 13;
  o[0] = tc;
#pragma unroll
  for (int a = 0; a < 3; ++a) o[1 + a] = ts[a];
#pragma unroll
  for (int e = 0; e < 9; ++e) o[4 + e] = to[e];
}

}  // namespace

// fp (lanes, cap) int32 and moments (lanes, cap, 10) f32 (cap a power of
// two), pools (n_pools, n, 3) int32, coords0 (n, 3) int32, mask (n,) bool
// bytes, all contiguous on the device, n a multiple of lanes (lane-major
// queries); writes out (n, 13) f32 on `stream`. 1 <= n_pools <= 8,
// 1 <= probes <= 8. Returns the launch's cudaError_t (0 = success).
extern "C" int merged_moments_launch(const int32_t* fp, const float* moments, long long cap,
                                     int lanes, const int32_t* pools, int n_pools, int n,
                                     const int32_t* coords0, const uint8_t* mask, float vs,
                                     int probes, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (cap <= 0 || (cap & (cap - 1)) != 0 || cap > (1LL << 31) || probes < 1 ||
      probes > kMaxProbes || lanes < 1 || n % lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = n / lanes;
  const uint32_t cap_mask = (uint32_t)(cap - 1);
  const float2* m2 = reinterpret_cast<const float2*>(moments);
  const int blocks = (n + kThreads - 1) / kThreads;
#define ASSOC_CASE(P)                                                                 \
  case P:                                                                             \
    merged_moments_kernel<P><<<blocks, kThreads, 0, stream>>>(fp, m2, cap_mask, pools, \
                                                              n, per_lane, coords0,   \
                                                              mask, vs, probes, out); \
    break;
  switch (n_pools) {
    ASSOC_CASE(1)
    ASSOC_CASE(2)
    ASSOC_CASE(3)
    ASSOC_CASE(4)
    ASSOC_CASE(5)
    ASSOC_CASE(6)
    ASSOC_CASE(7)
    ASSOC_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ASSOC_CASE
  return static_cast<int>(cudaGetLastError());
}
