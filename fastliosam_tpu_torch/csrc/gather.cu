// Row gather out[r] = table[idx[r]] of 4-byte elements, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels scripts/exp_assoc_kernels.py:
// exp_a_int_indexing (pallas_call at line 61) and exp_b_fori_dynamic_slice
// (pallas_call at lines 92 and 116): both compute table[idx] for a
// (C, 16) float32 table and 8192 int32 indices, the first as vector
// indexing, the second as one dynamic_slice per row. On the engine path the
// same kernel is the plane refresh's read of the moment table (C, 10) and
// the voxel coordinates (C, 3) (the loop closure's throwaway map); the
// association's reads are fused into csrc/assoc.cu, the insert's into
// csrc/insert.cu.
//
// Semantics (the JAX rule for table[idx], and the plain version's):
//   * a negative index wraps once (-1 -> C-1); what is still out of range
//     clamps to [0, C-1];
//   * where valid[r] is false (valid may be null) the row is all zero bits;
//   * elements are copied as 32-bit words, so float32 and int32 tables both
//     come out bit-exact.
//
// Bound on the card: bytes. Each row is a random read of 4*D bytes, i.e.
// one to three 32-byte sectors; the index read and the output write are
// contiguous. At 8192 rows that is well under 1 MB, so a call is bound by
// its launch and the latency of one dependent read (index, then row).
//
// Design (simple and right first): one thread per output word, in output
// order, so neighbouring threads write neighbouring words (coalesced
// stores) and read neighbouring words of the same row; a grid-stride loop
// covers any size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint32_t* __restrict__ table, long long c, int d,
                   const Index* __restrict__ idx, long long n,
                   const uint8_t* __restrict__ valid, uint32_t* __restrict__ out) {
  const long long total = n * d;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const long long r = e / d;
    const int col = (int)(e - r * d);
    uint32_t v = 0u;
    if (valid == nullptr || valid[r]) {
      long long i = (long long)idx[r];
      if (i < 0) i += c;
      i = i < 0 ? 0 : (i >= c ? c - 1 : i);
      v = table[i * d + col];
    }
    out[e] = v;
  }
}

}  // namespace

// table (c, d) 4-byte words, idx (n,) int32 (idx64 == 0) or int64, valid (n,)
// bool bytes or null, out (n, d); all contiguous on the device. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int gather_rows_launch(const uint32_t* table, long long c, int d,
                                  const void* idx, int idx64, long long n,
                                  const uint8_t* valid, uint32_t* out,
                                  cudaStream_t stream) {
  const long long total = n * d;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (idx64) {
    gather_rows_kernel<int64_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, c, d, static_cast<const int64_t*>(idx), n, valid, out);
  } else {
    gather_rows_kernel<int32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, c, d, static_cast<const int32_t*>(idx), n, valid, out);
  }
  return static_cast<int>(cudaGetLastError());
}
