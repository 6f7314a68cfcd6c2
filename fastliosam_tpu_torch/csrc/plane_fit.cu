// The voxel-hash map's plane refresh in one launch, for Hopper (sm_90a).
//
// Replaces, on the plane-refresh path, the Pallas TPU kernels
// scripts/exp_assoc_kernels.py: exp_a_int_indexing (pallas_call at line 61)
// and exp_b_fori_dynamic_slice (pallas_call at lines 92 and 116), the row
// gather table[idx] that the JAX package's map/voxel_hash.py: _fit_planes
// makes of the moment and coordinate tables at the insert's slots
// (insert(refresh_planes=True), lines 265-292). Before this kernel the port
// ran each refresh as two row gathers (csrc/gather.cu), the covariance and
// the closed-form eigenvector of core/eigh3.py in plain torch, and three
// drop-row scatters: about 80 device operations.
//
// What it computes (ops/plane_fit_cuda.py's plain version), for n slots sl
// into a table of C rows:
//   * where sl is the drop row C (or outside [0, C)), nothing: the JAX
//     package fits the clipped slot and then drops the write;
//   * else, from the slot's moment row [c, s (3), o (6)] and coordinate row:
//     mean = s / max(c, 1), cov = unpack(o) / max(c, 1) - mean mean^T;
//     the smallest eigenvalue l0 and its unit eigenvector of cov in
//     core/eigh3.py's closed form (the trigonometric cubic; the largest
//     column of (cov - l1 I)(cov - l2 I); e_x where that column is ~0);
//     centre = (f32(coords) + 0.5) * voxel_size; d = -normal . (centre +
//     mean); valid = c >= min_points and l0 < plane_var_thresh;
//   * normal, d and plane_valid written at the slot's row. Every other row
//     keeps the old tables' words (copied first, cudaMemcpyAsync on the
//     call's stream, before the kernel: the map functions return new tables).
// Duplicate slots write identical words, so the result needs no atomics.
//
// Arithmetic: each operation rounds alone, in the order of the plain
// version's tensor operations as PyTorch runs them on the card: explicit
// __fadd_rn / __fmul_rn / __fdiv_rn (no contraction into FMAs), libdevice
// acosf / cosf, a division by a Python float as PyTorch's CUDA kernel does
// it (a multiply by the float reciprocal), the sums over three elements in
// PyTorch's reduction order (a strided sum (x0 + x1) + x2; a contiguous one,
// split over two lanes, (x0 + x2) + x1). The one product the plain version
// leaves to cuBLAS, the batched 3 x 3 matmul of the eigenvector's column,
// is an FMA chain over k = 0, 1, 2 here. On an H100 with CUDA 12.8 that is
// cuBLAS's order too and every row comes out bit for bit; cuBLAS does not
// document it, so the card check holds the kernel to its plain version
// within a stated tolerance (ops/plane_fit_cuda.py: compare) and counts
// the rows that differ.
//
// Lanes (the batched rollout's cached mode, eval/batch_eval.py): B
// lane-major tables (moments (B, C, 10), coords (B, C, 3), normal (B, C, 3),
// d (B, C), plane_valid (B, C)) and B blocks of n/B lane-local slots; slot i
// belongs to lane b = i / (n/B) and touches lane b's rows only. With B = 1
// this is the unbatched call.
//
// Bound on the card: bytes. Per live slot an 8-byte slot, the 40-byte
// moment row (two sectors), the 12-byte coordinate row (one sector) and
// the 20 bytes written; plus the copy of the three old tables (read and
// written once, 20 bytes a row). At 16,384 slots into 2^14 rows that is
// ~2 MB, under a microsecond at 3.35 TB/s: the launch sets the time.
//
// Design: one thread per slot; each thread's loads (slot, then its two
// rows) are one dependent pair, and ~150 float operations follow in
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// core/eigh3.py: eigvalsh3 on the symmetric A, then _eigvec of the
// smallest eigenvalue: writes the unit eigenvector v and returns l0
__device__ float smallest_eigvec3(const float A[3][3], float v[3]) {
  const float third = 1.0f / 3.0f;  // x / 3.0 on the card: x * f32(1 / 3)
  const float a00 = A[0][0], a01 = A[0][1], a02 = A[0][2];
  const float a11 = A[1][1], a12 = A[1][2], a22 = A[2][2];
  const float q = mul(add(add(a00, a11), a22), third);
  const float b00 = sub(a00, q), b11 = sub(a11, q), b22 = sub(a22, q);
  const float p2 = add(add(add(mul(b00, b00), mul(b11, b11)), mul(b22, b22)),
                       mul(add(add(mul(a01, a01), mul(a02, a02)), mul(a12, a12)), 2.0f));
  const float p = __fsqrt_rn(clamp_min(mul(p2, 1.0f / 6.0f), (float)1e-12));
  const float inv_p = __frcp_rn(p);
  const float c00 = mul(b00, inv_p), c11 = mul(b11, inv_p), c22 = mul(b22, inv_p);
  const float c01 = mul(a01, inv_p), c02 = mul(a02, inv_p), c12 = mul(a12, inv_p);
  const float x = sub(mul(c11, c22), mul(c12, c12));
  const float y = sub(mul(c01, c22), mul(c12, c02));
  const float z = sub(mul(c01, c12), mul(c11, c02));
  const float half_det = clamp(mul(add(sub(mul(c00, x), mul(c01, y)), mul(c02, z)), 0.5f),
                               -1.0f, 1.0f);
  const float phi = mul(acosf(half_det), third);
  const float two_p = mul(p, 2.0f);
  const float lam2 = add(q, mul(two_p, cosf(phi)));
  const float lam0 = add(q, mul(two_p, cosf(add(phi, (float)2.0943951023931953))));
  const float lam1 = sub(sub(mul(q, 3.0f), lam0), lam2);

  // (A - l1 I)(A - l2 I); the off-diagonal terms subtract l * 0 as the
  // plain version's `l * eye` does (signed zeros included)
  float b1[3][3], b2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      b1[i][j] = sub(A[i][j], mul(lam1, e));
      b2[i][j] = sub(A[i][j], mul(lam2, e));
    }
  }
  float m[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m[i][j] = __fmaf_rn(b1[i][2], b2[2][j],
                          __fmaf_rn(b1[i][1], b2[1][j], mul(b1[i][0], b2[0][j])));
    }
  }
  // the largest column (torch.argmax: the first of equal norms, NaN largest)
  int k = 0;
  float best = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float nj = add(add(mul(m[0][j], m[0][j]), mul(m[1][j], m[1][j])),
                         mul(m[2][j], m[2][j]));
    if (j == 0 || (!isnan(best) && (isnan(nj) || nj > best))) {
      best = nj;
      k = j;
    }
  }
  const float col[3] = {m[0][k], m[1][k], m[2][k]};
  const float n = __fsqrt_rn(add(add(mul(col[0], col[0]), mul(col[2], col[2])),
                                 mul(col[1], col[1])));
  if (n > (float)1e-20) {
    const float den = clamp_min(n, (float)1e-12);
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = div(col[i], den);
  } else {  // repeated eigenvalues: e_x
    v[0] = 1.0f;
    v[1] = 0.0f;
    v[2] = 0.0f;
  }
  return lam0;
}

__global__ void __launch_bounds__(kThreads)
refresh_planes_kernel(const float* __restrict__ moments, const int32_t* __restrict__ coords,
                      long long cap, const int64_t* __restrict__ slots, long long n,
                      long long per_lane, float voxel_size, float min_points, float thresh,
                      float* __restrict__ normal, float* __restrict__ d,
                      int32_t* __restrict__ plane_valid) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const long long s = slots[i];
  if (s < 0 || s >= cap) return;  // the drop row: the write is dropped
  const long long row = (i / per_lane) * cap + s;
  const float* mo = moments + row * 10;
  float mom[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) mom[k] = __ldg(mo + k);
  const int32_t* co = coords + row * 3;
  const int cx = __ldg(co), cy = __ldg(co + 1), cz = __ldg(co + 2);

  const float c = mom[0];
  const float safe_c = clamp_min(c, 1.0f);
  const float mean[3] = {div(mom[1], safe_c), div(mom[2], safe_c), div(mom[3], safe_c)};
  // [xx, xy, xz, yy, yz, zz] -> symmetric 3 x 3
  const int sym[3][3] = {{4, 5, 6}, {5, 7, 8}, {6, 8, 9}};
  float cov[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) cov[r][q] = sub(div(mom[sym[r][q]], safe_c), mul(mean[r], mean[q]));
  }
  float v[3];
  const float lam0 = smallest_eigvec3(cov, v);
  const float w[3] = {add(mul(add((float)cx, 0.5f), voxel_size), mean[0]),
                      add(mul(add((float)cy, 0.5f), voxel_size), mean[1]),
                      add(mul(add((float)cz, 0.5f), voxel_size), mean[2])};
  // -sum(normal * mean_world, dim=-1): a contiguous 3-element sum
  const float dd = -add(add(mul(v[0], w[0]), mul(v[2], w[2])), mul(v[1], w[1]));
  normal[row * 3] = v[0];
  normal[row * 3 + 1] = v[1];
  normal[row * 3 + 2] = v[2];
  d[row] = dd;
  plane_valid[row] = (c >= min_points && lam0 < thresh) ? 1 : 0;
}

}  // namespace

// moments (lanes, cap, 10) f32, coords (lanes, cap, 3) i32, slots (n,) i64
// lane-major and lane-local (n a multiple of lanes), the old normal
// (lanes, cap, 3) f32, d (lanes, cap) f32, plane_valid (lanes, cap) i32 and
// the new tables of the same shapes; all contiguous on the device. Copies
// the old tables into the new ones (unless they are the same memory), then
// refits the slots' rows in the new ones. Runs on `stream` and returns the
// first cudaError_t (0 = success).
extern "C" int refresh_planes_launch(const float* moments, const int32_t* coords, long long cap,
                                     int lanes, const int64_t* slots, long long n,
                                     const float* normal_in, const float* d_in,
                                     const int32_t* pv_in, float* normal_out, float* d_out,
                                     int32_t* pv_out, float voxel_size, float min_points,
                                     float thresh, cudaStream_t stream) {
  if (cap <= 0 || lanes < 1 || n < 0 || n % lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = (size_t)lanes * (size_t)cap;
  cudaError_t err = cudaSuccess;
  if (normal_out != normal_in)
    err = cudaMemcpyAsync(normal_out, normal_in, rows * 3 * sizeof(float),
                          cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess && d_out != d_in)
    err = cudaMemcpyAsync(d_out, d_in, rows * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess && pv_out != pv_in)
    err = cudaMemcpyAsync(pv_out, pv_in, rows * sizeof(int32_t), cudaMemcpyDeviceToDevice,
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  refresh_planes_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      moments, coords, cap, slots, n, n / lanes, voxel_size, min_points, thresh, normal_out,
      d_out, pv_out);
  return static_cast<int>(cudaGetLastError());
}
