"""Voxel keys of the hash map: voxel coordinates, slot hash, fingerprint and
voxel centre.

The hash and the fingerprint are uint32 arithmetic in the JAX package
(``fastliosam_tpu/map/voxel_hash.py: _hash, _fingerprint``): coordinates
wrap into uint32, products wrap modulo 2^32 and ``>>`` is a logical shift.
Torch's uint32 support is thin and ``>>`` on int32 is arithmetic, so these
emulate them in int64 masked with 0xFFFFFFFF, splitting each multiplier
into 16-bit halves so no product leaves int64. Both words match the JAX
package bit for bit, which is what lets the parity tests compare slot
tables; the kernels that probe the map (``csrc/voxel_keys.cuh``) compute
the same words in native uint32.

Used by the map (``map/voxel_hash.py``) and by the plain versions of the
association and the insert (``ops/assoc_cuda.py``, ``ops/insert_cuda.py``),
which is why they live here and not in any of them.
"""
from __future__ import annotations

import torch

P1, P2, P3 = 73856093, 19349669, 83492791  # slot hash
Q1, Q2, Q3 = 2654435761, 805459861, 3674653429  # fingerprint hash
_MASK32 = 0xFFFFFFFF


def voxel_coords(xyz, voxel_size):
    """int32 voxel coordinates of float32 points (..., 3). Multiplies by the
    float32 reciprocal: XLA compiles the JAX package's ``xyz / voxel_size``
    that way, and a point on a voxel boundary must land in the same voxel
    as in the (always compiled) JAX package."""
    return torch.floor(xyz * (1.0 / voxel_size)).to(torch.int32)


def _mul32(a, k: int):
    """``(a * k) mod 2^32`` for int64 ``a`` in [0, 2^32) and a uint32
    constant ``k``, without int64 overflow."""
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(h):
    """Avalanche finalizer (murmur3 fmix variant) on uint32 values held in
    int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _as_u32(coords):
    return coords.to(torch.int64) & _MASK32


def hash_slot(coords, capacity):
    """Slot index (int32) of int32 voxel coords (..., 3)."""
    c = _as_u32(coords)
    h = (_mul32(c[..., 0], P1) + _mul32(c[..., 1], P2) + _mul32(c[..., 2], P3)) & _MASK32
    return (_mix32(h) & (capacity - 1)).to(torch.int32)


def fingerprint(coords):
    """Odd (hence nonzero) int32 identity word per voxel coordinate: the
    uint32 hash bit-cast to int32."""
    c = _as_u32(coords)
    h = (_mul32(c[..., 0], Q1) + _mul32(c[..., 1], Q2) + _mul32(c[..., 2], Q3)) & _MASK32
    h = _mix32(h) | 1
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def voxel_center(coords, voxel_size):
    return (coords.to(torch.float32) + 0.5) * voxel_size
