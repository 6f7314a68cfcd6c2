// Open-addressing hash from a cell's key to a 64-bit value: the k-NN's
// cell grid (csrc/knn.cu; the value packs the cell's [start, end) in the
// sorted points).
//
// The table is `mask + 1` 16-byte slots (a power of two, at least twice the
// number of cells), each a key (all ones: empty) and a value, filled with
// -1 by the wrapper: a probe is one 16-byte load. A build kernel inserts
// every cell once with `insert` (one integer atomicCAS a probe, no float
// atomics), and the lookups run in a later launch with `find`. Linear
// probing: which slot a cell lands in depends on the order of the inserts,
// but a lookup returns the same value on every run, since each key is
// inserted once and a lookup stops only at its key or at an empty slot.
#pragma once

namespace cell_hash {

constexpr unsigned long long kEmpty = ~0ULL;

struct alignas(16) Slot {
  unsigned long long key;
  long long value;
};

// splitmix64's finalizer: every input bit reaches every output bit
__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

// Put `key` (not all ones) with `value` (>= 0) in the slot chain of hash
// `h`. Each key is inserted once.
__device__ __forceinline__ void insert(Slot* slots, unsigned long long mask, unsigned long long h,
                                       unsigned long long key, long long value) {
  unsigned long long s = h & mask;
  while (atomicCAS(&slots[s].key, kEmpty, key) != kEmpty) s = (s + 1) & mask;
  slots[s].value = value;
}

// The value of `key` in the chain of hash `h`, or -1 when it is not there.
// The table is never full (at most half its slots are taken), so the probe
// ends.
__device__ __forceinline__ long long find(const Slot* __restrict__ slots, unsigned long long mask,
                                          unsigned long long h, unsigned long long key) {
  const longlong2* s2 = reinterpret_cast<const longlong2*>(slots);
  for (unsigned long long s = h & mask;; s = (s + 1) & mask) {
    const longlong2 e = s2[s];
    if ((unsigned long long)e.x == kEmpty) return -1;
    if ((unsigned long long)e.x == key) return e.y;
  }
}

}  // namespace cell_hash
