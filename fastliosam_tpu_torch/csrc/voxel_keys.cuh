// Voxel keys of the hash map, shared by the kernels that probe it
// (assoc.cu, insert.cu): the slot hash, the fingerprint and the voxel
// centre.
//
// The hash and the fingerprint are native uint32 arithmetic: wrapping
// products and a logical >>, the words of the JAX package's uint32 and of
// the port's int64 emulation (core/voxel.py). build.py hashes this header
// into every library's name, so an edit here rebuilds every kernel.
#pragma once

#include <stdint.h>

namespace voxel_keys {

constexpr uint32_t kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;
constexpr uint32_t kQ1 = 2654435761u, kQ2 = 805459861u, kQ3 = 3674653429u;

// avalanche finalizer (murmur3 fmix variant)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// slot hash of voxel (x, y, z), before the capacity mask
__device__ __forceinline__ uint32_t hash_slot(int x, int y, int z) {
  return mix32((uint32_t)x * kP1 + (uint32_t)y * kP2 + (uint32_t)z * kP3);
}

// odd (hence nonzero) identity word of voxel (x, y, z)
__device__ __forceinline__ int32_t fingerprint(int x, int y, int z) {
  return (int32_t)(mix32((uint32_t)x * kQ1 + (uint32_t)y * kQ2 + (uint32_t)z * kQ3) | 1u);
}

// (float(c) + 0.5) * vs, rounded as the plain version's voxel_center
__device__ __forceinline__ float center(int c, float vs) {
  return __fmul_rn(__fadd_rn(__int2float_rn(c), 0.5f), vs);
}

}  // namespace voxel_keys
