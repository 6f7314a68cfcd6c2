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
// 256 MB table does not fit the 50 MB L2, so the sectors come from HBM,
// where random 32-byte reads run well below the sequential 3.35 TB/s
// (random_read_launch below measures that ceiling).
//
// Design: a thread takes 8 consecutive output elements of one output row
// (the vector path): two int4 index loads, then all 8 table loads issued
// before any is used, as streaming loads (ld.global.cs, evict first: the
// sectors are read once and should not evict anything), then two float4
// stores. The row and column of the group come from a shift and a mask
// when out_cols is a power of two (a template parameter), else from one
// 64-bit division per 8 elements. The vector path needs out_cols a
// multiple of 8, idx and out 16-byte aligned, and enough elements to give
// every SM a block of 256 threads (8 x 256 x 132); below that, as at the
// (64, 128) shape, it spreads over fewer SMs (0.0038 ms on an H100 where
// the general path takes 0.0032). The general path serves every other
// shape: one element per thread in row-major order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this
constexpr long long kVecMinElements = kVec * kThreads * 132LL;  // a block per SM

__device__ __forceinline__ float nan_fill() { return __int_as_float(0x7fc00000); }

template <int kAxis, bool kPow2>
__global__ void __launch_bounds__(kThreads)
take_along_vec_kernel(const float* __restrict__ tab, long long rows, long long cols,
                      const int4* __restrict__ idx, long long groups, long long out_cols,
                      int out_cols_log2, float4* __restrict__ out) {
  const long long extent = kAxis == 0 ? rows : cols;
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const long long e0 = g * kVec;
    long long i, j0;
    if (kPow2) {
      i = e0 >> out_cols_log2;
      j0 = e0 & (out_cols - 1);
    } else {
      i = e0 / out_cols;
      j0 = e0 - i * out_cols;
    }
    const int4 a = __ldcs(idx + 2 * g);
    const int4 b = __ldcs(idx + 2 * g + 1);
    const int ks[kVec] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float v[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      long long k = ks[q];
      if (k < 0) k += extent;
      const bool inside = k >= 0 && k < extent;
      const long long at = kAxis == 0 ? k * cols + j0 + q : i * cols + k;
      v[q] = inside ? __ldcs(tab + at) : nan_fill();
    }
    __stcs(out + 2 * g, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(out + 2 * g + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
}

template <int kAxis>
__global__ void __launch_bounds__(kThreads)
take_along_kernel(const float* __restrict__ tab, long long rows, long long cols,
                  const int32_t* __restrict__ idx, long long total, long long out_cols,
                  float* __restrict__ out) {
  const long long extent = kAxis == 0 ? rows : cols;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const long long i = e / out_cols;
    const long long j = e - i * out_cols;
    long long k = idx[e];
    if (k < 0) k += extent;
    float v = nan_fill();
    if (k >= 0 && k < extent) v = kAxis == 0 ? tab[k * cols + j] : tab[i * cols + k];
    out[e] = v;
  }
}

// the random-read ceiling: 8 reads a thread of pseudo-random words
__device__ __forceinline__ uint32_t probe_hash(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kThreads)
random_read_kernel(const float* __restrict__ buf, uint32_t buf_mask, long long groups,
                   uint32_t seed, float4* __restrict__ out) {
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    float v[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const uint32_t e = (uint32_t)(g * kVec + q);
      v[q] = __ldcs(buf + (probe_hash(e * 0x9E3779B1u + seed) & buf_mask));
    }
    __stcs(out + 2 * g, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(out + 2 * g + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
}

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <int kAxis>
void launch(const float* tab, long long rows, long long cols, const int32_t* idx,
            long long out_rows, long long out_cols, float* out, cudaStream_t stream) {
  const long long total = out_rows * out_cols;
  const bool vec = total >= kVecMinElements && out_cols % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) {
    take_along_kernel<kAxis><<<grid_for(total), kThreads, 0, stream>>>(
        tab, rows, cols, idx, total, out_cols, out);
    return;
  }
  const long long groups = total / kVec;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  if ((out_cols & (out_cols - 1)) == 0) {
    int log2 = 0;
    while ((1LL << log2) < out_cols) ++log2;
    take_along_vec_kernel<kAxis, true><<<grid_for(groups), kThreads, 0, stream>>>(
        tab, rows, cols, idx4, groups, out_cols, log2, out4);
  } else {
    take_along_vec_kernel<kAxis, false><<<grid_for(groups), kThreads, 0, stream>>>(
        tab, rows, cols, idx4, groups, out_cols, 0, out4);
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
  if (out_rows * out_cols <= 0) return 0;
  if (axis == 0) {
    launch<0>(tab, rows, cols, idx, out_rows, out_cols, out, stream);
  } else {
    launch<1>(tab, rows, cols, idx, out_rows, out_cols, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The random-read ceiling of the map-size take_along_axis: out[e] =
// buf[hash(e * 0x9E3779B1 + seed) & (n_buf - 1)] for e < n (n a multiple of
// 8, n_buf a power of two <= 2^32, out 16-byte aligned): one random 4-byte
// read per element and the contiguous writes, no index read. Returns the
// launch's cudaError_t.
extern "C" int random_read_launch(const float* buf, long long n_buf, long long n,
                                  unsigned seed, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n % kVec != 0 || n_buf <= 0 || (n_buf & (n_buf - 1)) != 0 || n_buf > (1LL << 32) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = n / kVec;
  random_read_kernel<<<grid_for(groups), kThreads, 0, stream>>>(
      buf, (uint32_t)(n_buf - 1), groups, seed, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
