// One iteration of the cached-mode iEKF's map rows in one launch, for
// Hopper (sm_90a): the optional probe of the voxel hash, the read of the
// chosen slot's cached plane and every per-point row that the iteration's
// reductions read.
//
// Replaces, on the cached-mode iEKF (odom/iekf.py, query_mode "cached"),
// the Pallas TPU kernels scripts/exp_assoc_kernels.py: exp_a_int_indexing
// (pallas_call at line 61) and exp_b_fori_dynamic_slice (pallas_call at
// lines 92 and 116), the row gather table[idx] that the JAX package's
// map/voxel_hash.py: query_planes makes of the cached plane fields after its
// slot probe (_find_slots), together with the residual and Jacobian rows
// that fastliosam_tpu/odom/iekf.py:93-131 builds from them. Before this
// kernel the port ran each iteration as the query's own launch
// (csrc/query.cu), about twenty tensor operations of rows around it, and,
// on the per-scan path, one host read for the re-query gate.
//
// What it computes (ops/cached_rows_cuda.py's plain version), for point i
// of lane b at the lane's state (R, p):
//   pw    = q_b @ R^T + p
//   slot  = probe ? the first of `probes` slots (h0 + k) & (C - 1) of the
//           voxel floor(pq * f32(1 / voxel_size)) whose fingerprint matches,
//           where mask holds (-1: none), pq = pw or q_query @ R^T + p
//         : slots_in[i]
//   n, d  = normal[max(slot, 0)], d[max(slot, 0)]   (the lane's own table)
//   assoc = slot >= 0 && plane_valid[max(slot, 0)] > 0 && mask
//   r     = sum(n * pw) + d,  valid = assoc && |r| < max_residual
//   w     = valid / point_cov,  v = n @ R
//   A     = [q_b x v, n] (+ [p_l x (v @ R_ext), v] with the extrinsic)
//   Aw    = A * w,  wc = valid * wc_scale,  nwc = n * wc
//   n_matched[b] = sum_i valid,  slots_out[i] = slot.
// probe is 1 (every lane), 0 (none: read the carried slots) or a device flag
// per lane (the re-query gate, read here: no host read on the path).
//
// Arithmetic: each operation rounds alone, as the plain version's tensor
// operations do on the card (explicit __fadd_rn / __fmul_rn / __fdiv_rn /
// __fmaf_rn; nvcc contracts nothing): the K = 3 products (q_b @ R^T, n @ R,
// v @ R_ext) as the FMA chain cuBLAS runs for them, the 3-element sum in
// PyTorch's reduction order, torch.linalg.cross as its CUDA kernel was
// compiled, the division by point_cov a true division (a tensor divisor in
// the plain version) and the Python scalars rounded to float32 first. So
// every output equals the plain version's bit for bit. The match count is
// an integer sum (atomics on integers: any order gives the same count).
//
// Bound on the card: bytes. Per point the 12-byte q_b and 1-byte mask, a
// probing lane's fingerprint sectors (one or two 32-byte sectors a point)
// or a carried 4-byte slot, the chosen row's three sectors (normal, d and
// plane_valid: three arrays), and 105 bytes of output rows (153 with the
// extrinsic); about 1.5 MB at 8192 points, half a microsecond at 3.35 TB/s.
// The launch sets the time.
//
// Design: one thread per point, one grid row of blocks per lane; each
// block loads its lane's R, p and R_ext into shared memory once; the
// probe's fingerprint loads are all issued before any compare (their
// addresses do not depend on each other); the multi-word rows (n, A, Aw,
// nwc) are staged in shared memory and stored by the block as one
// contiguous run (coalesced); the match count is summed per block
// (__syncthreads_count), added into a per-lane integer counter, and the
// block that takes the lane's last ticket writes it and resets the
// counter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "voxel_keys.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxProbes = 8;
constexpr int kMaxLanes = 1024;

__device__ unsigned long long g_count[kMaxLanes];  // matches so far; the last block resets
__device__ unsigned int g_ticket[kMaxLanes];  // blocks done; the last block resets

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// x @ M for a row x (3) and a row-major 3 x 3 M read with strides (si, sj):
// out[j] = sum_k x[k] M[k * si + j * sj], as cuBLAS's FMA chain over
// k = 0, 1, 2 from 0
__device__ __forceinline__ void row_times(const float x[3], const float* M, int si, int sj,
                                          float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = __fmaf_rn(x[k], M[k * si + j * sj], acc);
    out[j] = acc;
  }
}

// torch.sum over a contiguous last dim of 3 as its CUDA reduction runs it:
// two accumulators from 0 (x0 then x2 in one, x1 in the other), then their
// sum; the additions to 0 turn a -0 into +0
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(add(0.0f, x0), x2), add(0.0f, x1));
}

// torch.linalg.cross as its CUDA kernel rounds: a[u] b[v] - a[v] b[u],
// the second product rounded, the first fused with the subtraction
__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int u = (j + 1) % 3, v = (j + 2) % 3;
    out[j] = __fmaf_rn(a[u], b[v], -mul(a[v], b[u]));
  }
}

struct Args {
  const float* R;  // (lanes, 3, 3)
  const float* p;  // (lanes, 3)
  const float* R_ext;  // (lanes, 3, 3) or null
  const float* q_b;  // (lanes * n, 3)
  const float* q_query;  // (lanes * n, 3) or null: probe at pw
  const float* p_l;  // (lanes * n, 3) or null
  const uint8_t* mask;  // (lanes * n)
  int mode;  // 0 no probe, 1 probe, 2 probe where flag[lane]
  const uint8_t* flag;  // (lanes) or null
  const int32_t* fp;  // (lanes, cap)
  const float* normal;  // (lanes, cap, 3)
  const float* d;  // (lanes, cap)
  const int32_t* plane_valid;  // (lanes, cap)
  uint32_t cap_mask;
  int n;  // points a lane
  const int32_t* slots_in;  // (lanes * n) or null (every lane probes)
  int probes;
  float inv_vs, point_cov, max_residual, wc_scale;
  float* n_out;  // (lanes * n, 3)
  float* r_out;
  uint8_t* valid_out;
  float* A_out;  // (lanes * n, K)
  float* Aw_out;
  float* wc_out;
  float* nwc_out;  // (lanes * n, 3)
  long long* n_matched;  // (lanes)
  int32_t* slots_out;
};

// the block's rows of W words (row t of the block in buf[t * W ...]) stored
// as one contiguous run; every thread of the block calls it
template <int W>
__device__ __forceinline__ void store_rows(float* buf, const float* row, bool active,
                                           float* out, size_t first_row, int rows) {
  if (active) {
#pragma unroll
    for (int w = 0; w < W; ++w) buf[threadIdx.x * W + w] = row[w];
  }
  __syncthreads();
  float* dst = out + first_row * W;
  for (int k = threadIdx.x; k < rows * W; k += kThreads) dst[k] = buf[k];
  __syncthreads();
}

template <bool kExt>
__global__ void __launch_bounds__(kThreads) cached_rows_kernel(const Args a) {
  constexpr int K = kExt ? 12 : 6;
  __shared__ float sR[9], sp[3], sRe[9];
  __shared__ int s_probe;
  __shared__ float buf[kThreads * K];
  const int lane = blockIdx.y;
  const int i0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, a.n - i0);
  const bool active = (int)threadIdx.x < rows;
  const size_t g = (size_t)lane * a.n + i0 + threadIdx.x;  // this point's row
  if (threadIdx.x < 9) {
    sR[threadIdx.x] = a.R[9 * lane + threadIdx.x];
    if (kExt) sRe[threadIdx.x] = a.R_ext[9 * lane + threadIdx.x];
  }
  if (threadIdx.x < 3) sp[threadIdx.x] = a.p[3 * lane + threadIdx.x];
  if (threadIdx.x == 0) s_probe = a.mode == 1 || (a.mode == 2 && a.flag[lane] != 0);
  __syncthreads();

  float nrm[3] = {0.0f, 0.0f, 0.0f}, A[K], Aw[K], nwc[3];
  bool valid = false;
  if (active) {
    const float qb[3] = {a.q_b[3 * g], a.q_b[3 * g + 1], a.q_b[3 * g + 2]};
    const bool live = a.mask[g] != 0;
    float pw[3];
    row_times(qb, sR, 1, 3, pw);  // q_b @ R^T: M[k][j] = R[j][k]
#pragma unroll
    for (int j = 0; j < 3; ++j) pw[j] = add(pw[j], sp[j]);

    // the association: a probe of the lane's table, or the carried slot
    const size_t base = (size_t)lane * ((size_t)a.cap_mask + 1);
    int slot = -1;
    if (s_probe) {
      if (live) {
        float pq[3] = {pw[0], pw[1], pw[2]};
        if (a.q_query != nullptr) {
          const float qq[3] = {a.q_query[3 * g], a.q_query[3 * g + 1], a.q_query[3 * g + 2]};
          row_times(qq, sR, 1, 3, pq);
#pragma unroll
          for (int j = 0; j < 3; ++j) pq[j] = add(pq[j], sp[j]);
        }
        int c[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) c[j] = (int)floorf(mul(pq[j], a.inv_vs));
        const uint32_t h0 = voxel_keys::hash_slot(c[0], c[1], c[2]) & a.cap_mask;
        const int32_t want = voxel_keys::fingerprint(c[0], c[1], c[2]);
        int32_t seen[kMaxProbes];
#pragma unroll
        for (int k = 0; k < kMaxProbes; ++k) {
          seen[k] = k < a.probes ? __ldg(a.fp + base + ((h0 + k) & a.cap_mask)) : 0;
        }
#pragma unroll
        for (int k = 0; k < kMaxProbes; ++k) {
          if (k < a.probes && slot < 0 && seen[k] == want) slot = (int)((h0 + k) & a.cap_mask);
        }
      }
    } else {
      slot = a.slots_in[g];
    }
    a.slots_out[g] = slot;
    const size_t row = base + (size_t)(slot < 0 ? 0 : slot);
#pragma unroll
    for (int j = 0; j < 3; ++j) nrm[j] = __ldg(a.normal + 3 * row + j);
    const float dd = __ldg(a.d + row);
    const bool assoc = slot >= 0 && __ldg(a.plane_valid + row) > 0 && live;

    // the residual, its gate and weight
    const float r = add(sum3(mul(nrm[0], pw[0]), mul(nrm[1], pw[1]), mul(nrm[2], pw[2])), dd);
    valid = assoc && fabsf(r) < a.max_residual;
    const float one = valid ? 1.0f : 0.0f;
    const float w = __fdiv_rn(one, a.point_cov);
    const float wc = mul(one, a.wc_scale);
    a.r_out[g] = r;
    a.valid_out[g] = valid ? 1 : 0;
    a.wc_out[g] = wc;

    // the Jacobian rows
    float v[3];
    row_times(nrm, sR, 3, 1, v);  // n @ R
    cross3(qb, v, A);
#pragma unroll
    for (int j = 0; j < 3; ++j) A[3 + j] = nrm[j];
    if (kExt) {
      const float pl[3] = {a.p_l[3 * g], a.p_l[3 * g + 1], a.p_l[3 * g + 2]};
      float ve[3];
      row_times(v, sRe, 3, 1, ve);  // v @ R_ext
      cross3(pl, ve, A + 6);
#pragma unroll
      for (int j = 0; j < 3; ++j) A[9 + j] = v[j];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) Aw[k] = mul(A[k], w);
#pragma unroll
    for (int j = 0; j < 3; ++j) nwc[j] = mul(nrm[j], wc);
  }

  const size_t first = (size_t)lane * a.n + i0;
  store_rows<3>(buf, nrm, active, a.n_out, first, rows);
  store_rows<K>(buf, A, active, a.A_out, first, rows);
  store_rows<K>(buf, Aw, active, a.Aw_out, first, rows);
  store_rows<3>(buf, nwc, active, a.nwc_out, first, rows);

  // the lane's match count: the block's, then the lane's last block writes
  const int matched = __syncthreads_count(active && valid);
  if (threadIdx.x == 0) {
    atomicAdd(&g_count[lane], (unsigned long long)matched);
    __threadfence();  // the count is in before the ticket is taken
    if (atomicAdd(&g_ticket[lane], 1u) == gridDim.x - 1) {
      a.n_matched[lane] = (long long)atomicExch(&g_count[lane], 0ull);
      atomicExch(&g_ticket[lane], 0u);
    }
  }
}

}  // namespace

// R (lanes, 3, 3), p (lanes, 3), R_ext (lanes, 3, 3) or null; q_b, q_query
// (or null), p_l (or null, with R_ext) (lanes * n, 3) f32; mask (lanes * n)
// bool bytes; mode 0/1/2 with flag (lanes) bool bytes for 2; the lane-major
// map fp (lanes, cap) i32, normal (lanes, cap, 3) f32, d (lanes, cap) f32,
// plane_valid (lanes, cap) i32 (cap a power of two); slots_in (lanes * n)
// i32 or null (mode 1 only); 1 <= probes <= 8; the float32 constants; writes
// n (lanes * n, 3), r, valid, A and Aw (lanes * n, 6 or 12 with ext), wc,
// nwc (lanes * n, 3), n_matched (lanes) i64 and slots_out (lanes * n) i32 on
// `stream`. Returns the launch's cudaError_t (0 = success).
extern "C" int cached_rows_launch(
    const float* R, const float* p, const float* R_ext, const float* q_b, const float* q_query,
    const float* p_l, const uint8_t* mask, int mode, const uint8_t* flag, const int32_t* fp,
    const float* normal, const float* d, const int32_t* plane_valid, long long cap, int lanes,
    int n, const int32_t* slots_in, int probes, float inv_vs, int ext, float point_cov,
    float max_residual, float wc_scale, float* n_out, float* r_out,
    uint8_t* valid_out, float* A_out, float* Aw_out, float* wc_out, float* nwc_out,
    long long* n_matched, int32_t* slots_out, cudaStream_t stream) {
  if (cap <= 0 || (cap & (cap - 1)) != 0 || cap > (1LL << 31) || probes < 1 ||
      probes > kMaxProbes || lanes < 1 || lanes > kMaxLanes || n < 0 || mode < 0 || mode > 2 ||
      (mode == 2 && flag == nullptr) || (mode != 1 && slots_in == nullptr) ||
      (ext != 0) != (R_ext != nullptr && p_l != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) {
    return static_cast<int>(cudaMemsetAsync(n_matched, 0, sizeof(long long) * lanes, stream));
  }
  const Args a{R, p, R_ext, q_b, q_query, p_l, mask, mode, flag, fp, normal, d, plane_valid,
               (uint32_t)(cap - 1), n, slots_in, probes, inv_vs, point_cov, max_residual,
               wc_scale, n_out, r_out, valid_out, A_out, Aw_out, wc_out, nwc_out, n_matched,
               slots_out};
  const dim3 grid((n + kThreads - 1) / kThreads, lanes);
  if (ext) {
    cached_rows_kernel<true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    cached_rows_kernel<false><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
