"""Odometry over the slot-sharded voxel map (port of
``fastliosam_tpu/parallel/sharded_odom.py``).

``odom/pipeline.py: odom_step`` takes a ``map_ops`` backend;
:func:`sharded_map_ops` is the multi-rank one. The voxel-surfel tables
live sharded along the slot axis (each rank holds C/n slots, the memory
story for ~7 km maps) while the scan, the navigation state and the iEKF
solve stay replicated:

* query: ``sharded_map.query_planes_merged3_sharded`` (one ``pmin`` probe
  resolution and one ``psum`` of the ``(3, N, 10)`` stencil rows);
* insert: ``sharded_map.insert_sharded`` (owner-local claim tournaments,
  fingerprint ``psum`` per probe round);
* evict: the FoV slide's keep test and clear are elementwise over slots,
  so each rank evicts its shard alone, with no collective.
"""
from __future__ import annotations

from typing import NamedTuple

from ..map.voxel_hash import VoxelMap, VoxelMapConfig, evict_far
from .mesh import Mesh, shard_leading
from .sharded_map import insert_sharded, query_planes_merged3_sharded


def shard_map_arrays(m: VoxelMap, mesh: Mesh, axis: str = "kf") -> VoxelMap:
    """This rank's slot range of a whole map (every field cut along its
    slot axis), on the rank's device."""
    if m.fp.shape[0] % mesh.size:
        raise ValueError(f"capacity {m.fp.shape[0]} is not a multiple of the mesh ({mesh.size})")
    return VoxelMap(*(shard_leading(mesh, t) for t in m))


class MapOps(NamedTuple):
    """A pluggable voxel-map backend for ``odom/pipeline.py: odom_step``."""

    query: object  # (vmap, map_cfg, pts_world, mask) -> (n, d, valid, rvar)
    insert: object  # (vmap, map_cfg, pts_world, mask) -> (vmap, n_dropped)
    evict: object  # (vmap, map_cfg, center, det_range) -> vmap


def evict_far_sharded(m: VoxelMap, cfg: VoxelMapConfig, center_xyz, det_range, mesh: Mesh,
                      axis: str = "kf") -> VoxelMap:
    """FoV-sliding eviction on the slot-sharded map: each slot's keep or
    clear depends on its own coordinates only, so every rank evicts its
    shard locally, with no collective."""
    return evict_far(m, cfg, center_xyz, det_range)


def sharded_map_ops(mesh: Mesh, axis: str = "kf") -> MapOps:
    """The slot-sharded map backend (see the module docstring)."""
    return MapOps(
        query=lambda m, cfg, pts, msk: query_planes_merged3_sharded(m, cfg, pts, msk, mesh, axis),
        insert=lambda m, cfg, pts, msk: insert_sharded(m, cfg, pts, msk, mesh, axis),
        evict=lambda m, cfg, c, r: evict_far_sharded(m, cfg, c, r, mesh, axis),
    )
