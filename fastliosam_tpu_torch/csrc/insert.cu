// The voxel-hash map insert's probe-and-claim rounds in one launch, for
// Hopper (sm_90a).
//
// Replaces, on the map insert path, the Pallas TPU kernels
// scripts/exp_assoc_kernels.py: exp_a_int_indexing (pallas_call at line 61)
// and exp_b_fori_dynamic_slice (pallas_call at lines 92 and 116), the row
// gathers the insert's table reads stood on. Before this kernel the port
// ran each insert as ~190 small device operations: the int64-emulated hash
// and fingerprint, then per round a fingerprint gather (csrc/gather.cu), a
// claim-table fill, a scatter-max tournament, an integer scatter-add commit
// and a second gather, then the coordinate write, the saturation read and
// the moment-update rows.
//
// What it computes (map/voxel_hash.py's plain version, the JAX package's
// fastliosam_tpu/map/voxel_hash.py: insert, lines 212-260), for N points
// xyz with mask and a table of C slots (a power of two):
//   * voxel c = floor(xyz * f32(1 / voxel_size)) (the reciprocal multiply
//     XLA compiles the JAX division to), its slot hash h0 and fingerprint
//     (voxel_keys.cuh);
//   * `rounds` synchronous rounds. In each, every unassigned masked point
//     reads fp[cand], cand = (h0 + poff) & (C - 1); a matching word adopts
//     the slot; on an empty slot the point bids pid + 1 and the highest
//     point index wins; the winners write their fingerprint and their
//     coordinate row; then everyone re-reads fp[cand]: same-voxel losers
//     adopt, true collisions advance poff;
//   * sl = the slot, or C where unassigned; n_dropped = masked points left
//     unassigned;
//   * upd = [1, rel, outer6(rel)] * w, rel = xyz - (f32(c) + 0.5) * vs,
//     w = assigned and the OLD moments[sl, 0] < max_points, each product and
//     difference rounded alone in the plain version's order. It is a
//     multiply by w, not a select, so rows with w = 0 keep the plain
//     version's signed zeros.
// The moment scatter after it (core/segment.py) and the plane refresh stay
// in map/voxel_hash.py. The JAX package's caveat holds as it is: after
// evict_far punches a hole in a probe chain, a re-inserted voxel may claim
// the hole ahead of its surviving older entry, which it then shadows.
//
// Lanes (the batched rollout, eval/batch_eval.py): B lane-major tables
// (fp (B, C), coords (B, C, 3), moments (B, C, 10), the claim table
// (B, C)) and B blocks of n/B points in one launch. Point i belongs to lane
// b = i / (n/B), and every slot it touches is b*C + a lane-local slot: its
// candidate is kept as that global slot, so a probe step wraps inside the
// lane ((cand & ~(C - 1)) | ((cand + 1) & (C - 1))) and a bid goes to the
// lane's own claim word. Bids stay pid + 1 with the global point index,
// which orders a lane's points as their lane-local indices do, so each
// lane's winners, and its results, are the unbatched call's on that lane's
// table. sl is the lane-local slot (C where unassigned) and n_dropped one
// count per lane. With B = 1 this is the unbatched call: the same launch
// and the same words.
//
// The claim table: one int32 per slot, zeroed once per call (a
// cudaMemsetAsync on the call's stream, before the kernel), not once per
// round. A slot receives bids in a round only if its word was 0 when the
// round began; that round gives it a winner, whose fingerprint (odd, never
// 0) makes the slot full for every later round, so no slot is bid on in two
// rounds and the rounds need no fresh table.
//
// Bound on the card: bytes. Per point, `rounds` x 2 fingerprint sectors
// (read, re-read), one moment sector, the xyz and mask read and the
// outputs (sl, the 40-byte upd row); winners write a fingerprint word and
// a coordinate row. About 2 MB at N = 8192, ~0.0006 ms at 3.35 TB/s. The
// (2^19,) fingerprints and the claim words are L2-resident, so the call is
// really bound by ~2 x rounds dependent L2 round trips and the grid
// barriers between the phases of a round.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), one thread
// per point, the grid sized by occupancy: the fewest blocks that cover N
// with K points per thread (K = 1, 2, 4, 8, 16, the smallest whose grid
// fits on the card at once); the points of a thread, i = t + k * stride,
// keep their state in registers across the barriers. Each round is
//   A  read fp[cand] (L1 bypassed: other SMs write it), adopt a match, or
//      atomicMax(claim[cand], pid + 1) on an empty slot;
//   -- grid barrier --
//   B  a bidder whose pid + 1 is the slot's claim word writes its
//      fingerprint and coordinate row;
//   -- grid barrier --
//   C  re-read fp[cand]: adopt, or advance on a foreign word;
// and C runs straight on into the next round's A: C and A only read fp and
// A bids only on slots that were empty, which had no bid before, so two
// barriers per round suffice. The epilogue (sl, upd and n_dropped, one
// integer atomicAdd per block, whose sum is the same in any order) follows
// the last C without a barrier. The fingerprint commit is
// a plain store: the tournament already made the winner unique.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "voxel_keys.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// point states; a state >= 0 is the assigned slot
constexpr int kOpen = -1;      // masked, not assigned yet
constexpr int kBidding = -2;   // bid for its candidate slot this round
constexpr int kIdle = -3;      // masked out

// a word that other blocks write during the call: read from L2, not L1
__device__ __forceinline__ int32_t load_l2(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
insert_claim_kernel(int32_t* fp, int32_t* coords, const float* __restrict__ moments,
                    const float* __restrict__ xyz, const uint8_t* __restrict__ mask, int n,
                    int lanes, int per_lane, uint32_t cap_mask, float inv_vs, float vs,
                    int rounds, float max_points, int32_t* claim, long long* __restrict__ sl,
                    float2* __restrict__ upd, int32_t* n_dropped) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int t = blockIdx.x * kThreads + threadIdx.x;

  int c[K][3];
  uint32_t cand[K];
  int32_t want[K];
  int state[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * stride;
    state[k] = kIdle;
    cand[k] = 0;
    want[k] = 0;
    c[k][0] = c[k][1] = c[k][2] = 0;
    if (i < n) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        c[k][a] = (int)floorf(__fmul_rn(__ldg(xyz + 3 * i + a), inv_vs));
      }
      if (__ldg(mask + i)) {
        state[k] = kOpen;
        // the global slot: lane base + lane-local slot
        cand[k] = (uint32_t)(i / per_lane) * (cap_mask + 1u) +
                  (voxel_keys::hash_slot(c[k][0], c[k][1], c[k][2]) & cap_mask);
        want[k] = voxel_keys::fingerprint(c[k][0], c[k][1], c[k][2]);
      }
    }
  }
  // the first atomicAdd comes two barriers later
  for (int l = t; l < lanes; l += stride) n_dropped[l] = 0;

  for (int r = 0; r < rounds; ++r) {
    // A: adopt a matching slot, or bid for an empty one
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (state[k] != kOpen) continue;
      const int32_t cur = load_l2(fp + cand[k]);
      if (cur == want[k]) {
        state[k] = (int)cand[k];
      } else if (cur == 0) {
        atomicMax(claim + cand[k], t + k * stride + 1);
        state[k] = kBidding;
      }
    }
    grid.sync();
    // B: the highest bidder of each slot commits it
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (state[k] != kBidding) continue;
      state[k] = kOpen;
      if (load_l2(claim + cand[k]) == t + k * stride + 1) {
        fp[cand[k]] = want[k];
        int32_t* row = coords + (size_t)cand[k] * 3;
        row[0] = c[k][0];
        row[1] = c[k][1];
        row[2] = c[k][2];
      }
    }
    grid.sync();
    // C: winners and same-voxel losers adopt; true collisions move on
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (state[k] != kOpen) continue;
      const int32_t cur = load_l2(fp + cand[k]);
      if (cur == want[k]) {
        state[k] = (int)cand[k];
      } else if (cur != 0) {
        cand[k] = (cand[k] & ~cap_mask) | ((cand[k] + 1u) & cap_mask);
      }
    }
  }

  int dropped = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * stride;
    if (i >= n) continue;
    const bool assigned = state[k] >= 0;
    if (state[k] == kOpen) {
      if (lanes == 1) {
        ++dropped;
      } else {
        atomicAdd(n_dropped + i / per_lane, 1);
      }
    }
    sl[i] = assigned ? (long long)((uint32_t)state[k] & cap_mask) : (long long)cap_mask + 1;
    const float w =
        assigned && __ldg(moments + (size_t)state[k] * 10) < max_points ? 1.0f : 0.0f;
    float rel[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      rel[a] = __fsub_rn(__ldg(xyz + 3 * i + a), voxel_keys::center(c[k][a], vs));
    }
    const float row[10] = {
        __fmul_rn(1.0f, w),
        __fmul_rn(rel[0], w),
        __fmul_rn(rel[1], w),
        __fmul_rn(rel[2], w),
        __fmul_rn(__fmul_rn(rel[0], rel[0]), w),
        __fmul_rn(__fmul_rn(rel[0], rel[1]), w),
        __fmul_rn(__fmul_rn(rel[0], rel[2]), w),
        __fmul_rn(__fmul_rn(rel[1], rel[1]), w),
        __fmul_rn(__fmul_rn(rel[1], rel[2]), w),
        __fmul_rn(__fmul_rn(rel[2], rel[2]), w),
    };
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      upd[(size_t)i * 5 + q] = make_float2(row[2 * q], row[2 * q + 1]);
    }
  }

  if (lanes != 1) return;  // counted per lane above
  __shared__ int warp_sum[kWarps];
  dropped = __reduce_add_sync(0xffffffffu, dropped);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = dropped;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    if (total) atomicAdd(n_dropped, total);
  }
}

// grid barriers alone, at the insert's grid: what the barriers cost
__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

constexpr int kVariants = 5;  // K = 1, 2, 4, 8, 16
const void* const kKernels[kVariants] = {
    reinterpret_cast<const void*>(&insert_claim_kernel<1>),
    reinterpret_cast<const void*>(&insert_claim_kernel<2>),
    reinterpret_cast<const void*>(&insert_claim_kernel<4>),
    reinterpret_cast<const void*>(&insert_claim_kernel<8>),
    reinterpret_cast<const void*>(&insert_claim_kernel<16>)};

struct Plan {
  int variant;  // K = 1 << variant
  int blocks;
};

// the fewest blocks that cover n points, with the smallest K whose grid
// fits on the card at once; cached occupancy per device
cudaError_t plan_grid(long long n, Plan* plan) {
  static int sms[kMaxDevices];
  static int per_sm[kMaxDevices][kVariants];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorCooperativeLaunchTooLarge;
    for (int v = 0; v < kVariants; ++v) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev][v], kKernels[v],
                                                          kThreads, 0);
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  for (int v = 0; v < kVariants; ++v) {
    const long long per_block = (long long)kThreads << v;
    const long long blocks = (n + per_block - 1) / per_block;
    if (blocks <= (long long)per_sm[dev][v] * sms[dev]) {
      plan->variant = v;
      plan->blocks = (int)blocks;
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// fp (lanes, cap) int32 and coords (lanes, cap, 3) int32: the new tables,
// updated in place (the caller passes copies); moments (lanes, cap, 10) f32,
// read only; xyz (n, 3) f32, mask (n,) bool bytes, lane-major (n a multiple
// of lanes); claim (lanes, cap) int32 scratch, zeroed here on `stream`
// before the kernel; writes sl (n,) int64 (lane-local slots), upd (n, 10)
// f32 (8-byte aligned) and n_dropped (lanes,) int32. All contiguous on the
// device; cap a power of two, lanes * cap <= 2^31, 1 <= n < 2^31 - 1,
// rounds >= 1. Launches on `stream`; returns the launch's cudaError_t (0 =
// success; cudaErrorCooperativeLaunchTooLarge when n points do not fit one
// cooperative grid: the call is never split).
extern "C" int insert_claim_launch(int32_t* fp, int32_t* coords, const float* moments,
                                   long long cap, int lanes, const float* xyz,
                                   const uint8_t* mask, int n, float inv_vs, float vs,
                                   int rounds, float max_points, int32_t* claim, long long* sl,
                                   float* upd, int32_t* n_dropped, cudaStream_t stream) {
  if (cap <= 0 || (cap & (cap - 1)) != 0 || lanes < 1 || cap * lanes > (1LL << 31) ||
      n <= 0 || n % lanes != 0 || rounds < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = plan_grid(n, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(claim, 0, (size_t)cap * lanes * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint32_t cap_mask = (uint32_t)(cap - 1);
  int per_lane = n / lanes;
  float2* upd2 = reinterpret_cast<float2*>(upd);
  void* args[] = {&fp, &coords, &moments, &xyz, &mask, &n, &lanes, &per_lane, &cap_mask,
                  &inv_vs, &vs, &rounds, &max_points, &claim, &sl, &upd2, &n_dropped};
  err = cudaLaunchCooperativeKernel(kKernels[plan.variant], dim3(plan.blocks), dim3(kThreads),
                                    args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The grid the insert takes for n points: writes its blocks and points per
// thread. Returns a cudaError_t.
extern "C" int insert_claim_grid(long long n, int* blocks, int* points_per_thread) {
  Plan plan;
  const cudaError_t err = plan_grid(n, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = plan.blocks;
  *points_per_thread = 1 << plan.variant;
  return 0;
}

// `syncs` grid barriers and nothing else, on `blocks` x 256 threads, one
// cooperative launch: the barriers' cost at the insert's grid.
extern "C" int grid_sync_probe_launch(int blocks, int syncs, cudaStream_t stream) {
  void* args[] = {&syncs};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&grid_sync_probe_kernel), dim3(blocks), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
