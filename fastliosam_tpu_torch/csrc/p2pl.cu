// The point-to-plane ICP step's row reads and normal equations, for Hopper
// (sm_90a).
//
// Replaces, on the point-to-plane ICP path (loop/icp.py: icp_align_p2pl),
// the Pallas TPU kernels scripts/exp_assoc_kernels.py: exp_a_int_indexing
// (pallas_call at line 61) and exp_b_fori_dynamic_slice (pallas_call at
// lines 92 and 116), the row gather table[idx] that the JAX package's
// fastliosam_tpu/loop/icp.py: icp_align_p2pl (corr_weights and step, lines
// 256-289) makes of the destination's valid flags, normals and points at
// the nearest-neighbour indices. Before these kernels the port ran each
// step as three row gathers (csrc/gather.cu) and about a dozen tensor
// operations for the residuals, the rows and the two products.
//
// What it computes (ops/p2pl_cuda.py's plain version), for N source points
// ps moved by the current pose, their neighbours idx (the index rule of
// table[idx]: a negative index wraps once, the rest clamps to [0, M - 1])
// at squared distance d2:
//   corr = mask & (d2 < max_d2) & nvalid[idx],   w = corr & (d2 <= thr),
//   r = n . (ps - q),  a = [ps x n, n],  n = normals[idx], q = dst[idx],
//   G = sum_i w_i a_i a_i^T (6 x 6),  b = sum_i w_i a_i r_i (6).
// thr is a device scalar (the trimmed step's threshold) or absent (no trim:
// w = corr). corr_keys_kernel writes corr and where(corr, d2, 1e12), the
// sort keys of the trim, in the trimmed step's first launch.
//
// Reduction, in a fixed order (no float atomics): each block sums its
// points' 27 distinct terms (21 of G, 6 of b) with a fixed shuffle tree
// per warp and the warps in order, and writes them as one partial row;
// the block that takes the last integer ticket then reads every partial
// row into shared memory, sums them in block order and writes G
// (symmetric) and b. The result is the same words from run to run. It is
// not the plain version's words: that one leaves both products to a cuBLAS
// matmul, whose order of summation is not documented, so the card check
// holds the two to a stated tolerance.
//
// Bound on the card: bytes. Per point the 12-byte source point, the 4-byte
// index, the 4-byte distance and the 1-byte mask (contiguous) and three
// random sectors (the neighbour's point, normal and flag); ~117 bytes a
// point, ~1.9 MB at 16,384 points, ~0.6 microseconds at 3.35 TB/s. The
// launch and the dependent reads (index, then rows) set the time.
//
// Design: one thread per point in a grid of 256-thread blocks (a
// grid-stride loop beyond kMaxBlocks); each thread's terms stay in
// registers until the block's tree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;
constexpr int kTerms = 27;  // G's upper triangle (21), then b (6)
constexpr float kBig = 1.0e12f;

__device__ unsigned int g_ticket = 0;  // blocks done; the last one resets it

__device__ __forceinline__ long long clamp_index(long long i, long long m) {
  if (i < 0) i += m;
  return i < 0 ? 0 : (i >= m ? m - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
corr_keys_kernel(const int32_t* __restrict__ idx, const float* __restrict__ d2,
                 const uint8_t* __restrict__ mask, const uint8_t* __restrict__ nvalid,
                 long long m, long long n, float max_d2, uint8_t* __restrict__ corr,
                 float* __restrict__ key) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const float di = d2[i];
  const bool c = mask[i] && di < max_d2 && nvalid[clamp_index(idx[i], m)];
  corr[i] = c;
  key[i] = c ? di : kBig;
}

__global__ void __launch_bounds__(kThreads)
normal_eq_kernel(const float* __restrict__ ps, const int32_t* __restrict__ idx,
                 const float* __restrict__ d2, const uint8_t* __restrict__ mask,
                 const float* __restrict__ dst, const float* __restrict__ normals,
                 const uint8_t* __restrict__ nvalid, long long m, long long n, float max_d2,
                 const float* __restrict__ thr, float* __restrict__ partial,
                 float* __restrict__ out) {
  float t[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;
  const float lim = thr == nullptr ? 0.0f : *thr;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float di = d2[i];
    if (!mask[i] || !(di < max_d2) || (thr != nullptr && !(di <= lim))) continue;
    const long long j = clamp_index(idx[i], m);
    if (!nvalid[j]) continue;
    const float px = ps[3 * i], py = ps[3 * i + 1], pz = ps[3 * i + 2];
    const float nx = normals[3 * j], ny = normals[3 * j + 1], nz = normals[3 * j + 2];
    const float qx = dst[3 * j], qy = dst[3 * j + 1], qz = dst[3 * j + 2];
    const float r = nx * (px - qx) + ny * (py - qy) + nz * (pz - qz);
    const float a[6] = {py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx, nx, ny, nz};
    int k = 0;
#pragma unroll
    for (int u = 0; u < 6; ++u) {
#pragma unroll
      for (int v = u; v < 6; ++v) t[k++] += a[u] * a[v];
    }
#pragma unroll
    for (int u = 0; u < 6; ++u) t[21 + u] += a[u] * r;
  }
  // the block's sums: a fixed shuffle tree in each warp, then the warps in order
  __shared__ float warp_sums[kWarps][kTerms];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float s = t[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partial[blockIdx.x * kTerms + threadIdx.x] = s;
    __threadfence();  // the partial row is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // every partial row into shared memory at once (independent L2 reads),
  // then each term summed over the blocks in block order
  __shared__ float rows[kMaxBlocks * kTerms];
  const int total = gridDim.x * kTerms;
  for (int k = threadIdx.x; k < total; k += kThreads) rows[k] = __ldcg(partial + k);
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.0f;
    for (unsigned b = 0; b < gridDim.x; ++b) s += rows[b * kTerms + threadIdx.x];
    warp_sums[0][threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) g_ticket = 0;
  if (threadIdx.x < 36) {  // G (6 x 6, row-major) from its upper triangle
    const int u = threadIdx.x / 6, v = threadIdx.x % 6;
    const int lo = u < v ? u : v, hi = u < v ? v : u;
    out[threadIdx.x] = warp_sums[0][lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];
  } else if (threadIdx.x < 42) {  // b
    out[threadIdx.x] = warp_sums[0][21 + threadIdx.x - 36];
  }
}

}  // namespace

// idx (n,) i32, d2 (n,) f32, mask (n,) bool, nvalid (m,) bool; writes corr
// (n,) bool and key (n,) f32. Returns the launch's cudaError_t.
extern "C" int p2pl_corr_keys_launch(const int32_t* idx, const float* d2, const uint8_t* mask,
                                     const uint8_t* nvalid, long long m, long long n,
                                     float max_d2, uint8_t* corr, float* key,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  corr_keys_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(idx, d2, mask, nvalid, m, n,
                                                              max_d2, corr, key);
  return static_cast<int>(cudaGetLastError());
}

// The number of partial rows (kTerms floats each) the normal equations of
// n points need as scratch.
extern "C" int p2pl_partial_rows(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

// ps (n, 3) f32, idx (n,) i32, d2 (n,) f32, mask (n,) bool, dst (m, 3) f32,
// normals (m, 3) f32, nvalid (m,) bool, thr a device f32 or null (no
// trim), partial (p2pl_partial_rows(n), 27) f32 scratch; writes out (42,)
// f32: G (6 x 6, row-major), then b (6). Returns the launch's cudaError_t.
extern "C" int p2pl_normal_eq_launch(const float* ps, const int32_t* idx, const float* d2,
                                     const uint8_t* mask, const float* dst,
                                     const float* normals, const uint8_t* nvalid, long long m,
                                     long long n, float max_d2, const float* thr,
                                     float* partial, float* out, cudaStream_t stream) {
  if (m <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = p2pl_partial_rows(n);
  normal_eq_kernel<<<blocks, kThreads, 0, stream>>>(ps, idx, d2, mask, dst, normals, nvalid, m,
                                                    n, max_d2, thr, partial, out);
  return static_cast<int>(cudaGetLastError());
}
