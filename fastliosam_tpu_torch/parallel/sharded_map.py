"""Slot-range sharding of the voxel-surfel hash map (port of
``fastliosam_tpu/parallel/sharded_map.py``).

Partition: the hash-slot axis is split contiguously; rank d owns the slots
``[d·C/n, (d+1)·C/n)`` and holds only those rows (a map of ``C/n`` rows a
field; the capacity in ``VoxelMapConfig`` stays the whole table's ``C``).
Points are replicated; each rank resolves the probe candidates that fall
in its slot range and one small collective combines the per-point results:

* probe resolution: each rank takes its local first matching probe offset
  and a ``pmin`` picks the global one (sentinel 127; a probe window may
  cross a shard boundary, so ownership is per candidate, not per point);
* moment read: the owner contributes the ``(N, 10)`` moment rows, zeros
  elsewhere, so the ``psum`` is the owner's row exactly; then the plane
  fit runs as on the replicated path (``map/voxel_hash.py: _fit_merged``).
  The JAX package sends one ``pmin`` and one ``psum`` per stencil
  position; the port sends one of each per query, over the ``(3, N)``
  offsets and the ``(3, N, 10)`` rows of all three positions: the same
  values (each is exact), a third of the calls, which is what a gloo
  collective costs on one card (``parallel/mesh.py``);
* insert: the claim tournaments and the moment scatter stay with each
  slot's owner (a slot has exactly one owner, so the scatter-max of a
  tournament needs no other rank); each probe round shares the candidates'
  fingerprints with one ``psum`` before the claim and one after it.

Ownership is tested on the slot index in int64: the uint32 slot hash is
emulated in int64 (``core/voxel.py``). Each rank's scatters write a local
drop row, row ``C/n`` of its shard, appended for the scatter and cut off
after it (as the replicated insert appends row ``C``, ``map/voxel_hash.py:
_with_drop_row``): a point that no slot of this rank takes writes there.
The moment scatter sums in the fixed order of ``core/segment.py``, no
float atomics, so each owner's rows get the replicated insert's sums bit
for bit.

This module is plain torch on the card: the JAX package has no Pallas
source behind it, and a kernel for the owner-resolved probe waits until a
trace shows it among the costs.
"""
from __future__ import annotations

import torch

from ..core import segment
from ..core.voxel import fingerprint, hash_slot, voxel_center, voxel_coords
from ..map.voxel_hash import VoxelMap, VoxelMapConfig, _fit_merged, merged3_pools
from ..ops.assoc_cuda import rereferenced_sums
from ..ops.insert_cuda import outer6
from .mesh import Mesh

_NO_MATCH = 127  # probe-offset sentinel (> any real probe window)


def _shard_rows(cfg: VoxelMapConfig, mesh: Mesh) -> int:
    if cfg.capacity % mesh.size:
        raise ValueError(f"capacity {cfg.capacity} is not a multiple of the mesh ({mesh.size})")
    return cfg.capacity // mesh.size


def make_map_sharded(cfg: VoxelMapConfig, mesh: Mesh, axis: str = "kf") -> VoxelMap:
    """An empty map shard: this rank's ``C/n`` slots only, on its device."""
    kl = _shard_rows(cfg, mesh)
    z = dict(device=mesh.device)
    return VoxelMap(
        fp=torch.zeros((kl,), dtype=torch.int32, **z),
        coords=torch.zeros((kl, 3), dtype=torch.int32, **z),
        moments=torch.zeros((kl, 10), dtype=torch.float32, **z),
        normal=torch.zeros((kl, 3), dtype=torch.float32, **z),
        d=torch.zeros((kl,), dtype=torch.float32, **z),
        plane_valid=torch.zeros((kl,), dtype=torch.int32, **z),
    )


def _owned(cand, lo: int, kl: int):
    """``(own, local row)`` of global slots ``cand`` (int64): whether this
    rank's range ``[lo, lo + kl)`` holds each, and its row there (clipped)."""
    own = (cand >= lo) & (cand < lo + kl)
    return own, torch.clamp(cand - lo, 0, kl - 1)


def _local_probe_offsets(fp_l, lo, kl, h0, want, mask, probes, cap):
    """This rank's first matching probe offset per point (or ``_NO_MATCH``):
    the ``pmin`` over ranks of it is the global one."""
    best = torch.full(h0.shape, _NO_MATCH, dtype=torch.int32, device=h0.device)
    for p in range(probes):
        own, li = _owned((h0 + p) & (cap - 1), lo, kl)
        hit = own & mask & (fp_l[li] == want)
        best = torch.minimum(best, torch.where(hit, p, _NO_MATCH).to(torch.int32))
    return best


def query_planes_merged3_sharded(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask, mesh: Mesh,
                                 axis: str = "kf"):
    """The slot-sharded map's ``voxel_hash.query_planes_merged3``:
    replicated points, this rank's shard ``m``; returns ``(normal, d,
    valid, rvar)``, the same on every rank."""
    cap = cfg.capacity
    kl = _shard_rows(cfg, mesh)
    lo = mesh.rank * kl
    coords0, pools = merged3_pools(xyz, cfg.voxel_size)
    h0 = hash_slot(pools, cap).to(torch.int64)  # (3, N)
    want = fingerprint(pools)
    # the three stencil positions' offsets in one pmin, their rows in one psum
    poff = mesh.pmin(torch.stack([
        _local_probe_offsets(m.fp, lo, kl, h0[i], want[i], mask, cfg.query_probes, cap)
        for i in range(len(pools))]))
    found = poff < _NO_MATCH
    own, li = _owned((h0 + torch.where(found, poff, 0)) & (cap - 1), lo, kl)
    # the owner's row, zeros elsewhere: the psum is that row exactly
    moms = mesh.psum(torch.where((own & found)[..., None], m.moments[li], 0.0))
    tot = rereferenced_sums(moms, pools, coords0, cfg.voxel_size)
    return _fit_merged(cfg, xyz, mask, coords0, tot)


def insert_sharded(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask, mesh: Mesh,
                   axis: str = "kf"):
    """The slot-sharded map's ``voxel_hash.insert`` (fused match-or-claim
    probing; the plane cache is not refreshed: merged-moment queries only).
    Returns ``(map shard, n_dropped)``."""
    cap = cfg.capacity
    kl = _shard_rows(cfg, mesh)
    lo = mesh.rank * kl
    dev = xyz.device
    vc = voxel_coords(xyz, cfg.voxel_size)
    h0 = hash_slot(vc, cap).to(torch.int64)
    want = fingerprint(vc)
    n = xyz.shape[0]
    pid1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev)

    fp_l = torch.cat([m.fp, m.fp.new_zeros((1,))])  # row kl: the drop row
    slots = torch.full((n,), -1, dtype=torch.int64, device=dev)
    poff = torch.zeros((n,), dtype=torch.int64, device=dev)
    won_local = torch.full((n,), kl, dtype=torch.int64, device=dev)  # kl: no win here
    for _ in range(max(cfg.insert_probes, cfg.claim_probes)):
        cand = (h0 + poff) & (cap - 1)
        own, li = _owned(cand, lo, kl)
        unassigned = (slots < 0) & mask
        # the candidates' fingerprints, shared (one psum)
        cur = mesh.psum(torch.where(own, fp_l[li], 0))
        slots = torch.where(unassigned & (cur == want), cand, slots)
        # the tournament on owned empty candidates: highest pid + 1 wins
        tl = unassigned & (cur == 0) & own
        row = torch.where(tl, li, kl)
        claim = torch.zeros((kl + 1,), dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, row, torch.where(tl, pid1, 0), "amax")
        won = tl & (claim[li] == pid1)
        # one winner per slot: an empty slot takes exactly its fingerprint
        fp_l[torch.where(won, li, kl)] = torch.where(won, want, 0)
        fp_l[kl] = 0
        won_local = torch.where(won, li, won_local)
        cur2 = mesh.psum(torch.where(own, fp_l[li], 0))
        slots = torch.where((slots < 0) & mask & (cur2 == want), cand, slots)
        poff = torch.where((slots < 0) & mask & (cur2 != 0) & (cur2 != want), poff + 1, poff)
    coords_l = torch.cat([m.coords, m.coords.new_zeros((1, 3))])
    coords_l[won_local] = vc  # winners hold distinct rows; the rest write the drop row

    assigned = (slots >= 0) & mask
    # every rank counts the same points: the psum over n ranks, divided
    n_dropped = mesh.psum(torch.sum((mask & ~assigned).to(torch.int32))) // mesh.size
    own, li = _owned(torch.where(assigned, slots, cap + lo), lo, kl)
    sl = torch.where(own & assigned, li, kl)
    room = m.moments[torch.clamp(sl, max=kl - 1), 0] < cfg.max_points_per_voxel
    w = (own & assigned & room).to(torch.float32)
    rel = xyz - voxel_center(vc, cfg.voxel_size)
    upd = torch.cat([torch.ones_like(w)[:, None], rel, outer6(rel)], dim=-1) * w[:, None]
    moments = torch.cat([m.moments, m.moments.new_zeros((1, 10))])
    segment.index_add_(moments, segment.segment_plan(sl, dead=sl == kl), upd)
    return m._replace(fp=fp_l[:kl], coords=coords_l[:kl], moments=moments[:kl]), n_dropped
