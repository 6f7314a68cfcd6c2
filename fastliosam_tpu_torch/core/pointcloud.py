"""Fixed-capacity padded point clouds and sort-based voxel downsampling
(port of ``fastliosam_tpu/core/pointcloud.py``).

Every cloud is a ``(capacity, 3)`` float32 tensor plus a bool ``(capacity,)``
mask; invalid lanes hold a far-away sentinel. The downsample's output order
decides which points survive a point budget downstream, so it reproduces
the JAX package's order exactly: int32 packed keys, a stable sort, segment
sums over the sorted runs and a pack-to-front scatter.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .segment import scatter_add

PAD_VALUE = 1.0e6
_SENTINEL_KEY = 0x3FFFFFFF


class Cloud(NamedTuple):
    """Padded point cloud. ``xyz (N, 3)`` float32, ``mask (N,)`` bool."""

    xyz: torch.Tensor
    mask: torch.Tensor


def _pack_voxel_keys(xyz, mask, voxel_size):
    """Per-point voxel coords relative to the masked min corner, 10 bits per
    axis, packed into a sortable int32 key; invalid points get the maximum
    key so they sort to the end."""
    big = torch.where(mask[:, None], xyz, torch.inf)
    lo = torch.amin(big, dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    # x * (1/voxel) as XLA compiles the JAX package's division (see
    # map/voxel_hash._voxel_coords): same voxel for boundary points
    ij = torch.floor((xyz - lo) * (1.0 / voxel_size)).to(torch.int32)
    ij = torch.clamp(ij, 0, 1022)
    key = (ij[:, 0] << 20) | (ij[:, 1] << 10) | ij[:, 2]
    return torch.where(mask, key, _SENTINEL_KEY).to(torch.int32)


def voxel_downsample(cloud: Cloud, voxel_size: float) -> Cloud:
    """VoxelGrid-style centroid downsample. The output keeps the input
    capacity with the occupied-voxel centroids packed to the front, in
    ascending key order (the JAX package's order)."""
    xyz, mask = cloud.xyz, cloud.mask
    n = xyz.shape[0]
    dev = xyz.device
    keys = _pack_voxel_keys(xyz, mask, voxel_size)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    sxyz = xyz[order]
    smask = mask[order]
    # segment ids: 0-based index of each distinct key run; invalid lanes
    # share the sentinel key and form one segment at the tail
    is_start = torch.ones((n,), dtype=torch.int64, device=dev)
    is_start[1:] = (skeys[1:] != skeys[:-1]).to(torch.int64)
    seg = torch.cumsum(is_start, 0) - 1
    w = smask.to(torch.float32)
    # segment sums of [xyz * w, w] in sorted order, in the same fixed order
    # on the card as on the CPU (no atomics: see core/segment.py); invalid
    # lanes form the sentinel segment alone, whose sums are never used
    acc = scatter_add(seg, torch.cat([sxyz * w[:, None], w[:, None]], dim=1), n,
                      dead=~smask)
    sums, cnts = acc[:, :3], acc[:, 3]
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    occupied = cnts > 0.0
    # pack occupied segments to the front; row n takes the dropped writes
    dest = torch.where(occupied, torch.cumsum(occupied.to(torch.int64), 0) - 1, n)
    out_xyz = torch.full((n + 1, 3), PAD_VALUE, dtype=torch.float32, device=dev)
    out_xyz[dest] = centroids
    out_mask = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    out_mask[dest] = occupied
    return Cloud(xyz=out_xyz[:n], mask=out_mask[:n])
