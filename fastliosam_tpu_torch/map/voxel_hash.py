"""Device-resident voxel-surfel hash map (port of
``fastliosam_tpu/map/voxel_hash.py``).

An open-addressing hash table of voxels; each voxel accumulates Gaussian
surfel statistics ``[count, Σ(p-c) (3), Σ outer (6)]`` relative to its
centre in one fused ``(C, 10)`` moment tensor. Identity checks use one
int32 fingerprint word per slot (odd, so 0 means empty).

The slot hash and the fingerprint (``core/voxel.py``) are uint32
arithmetic emulated in int64; both match the JAX package bit for bit,
which is what lets the parity tests compare slot tables.

Every ``mode="drop"`` scatter of the JAX package becomes a write into a
buffer with one extra row that takes the dropped indices
(``core/segment.py: with_drop_row``). Functions return
new tensors and leave the input map untouched, as the JAX functions do.

The merged plane queries make one call of
:func:`ops.assoc_cuda.merged_moments` per association: probe, moment read
and re-referenced sums, one hand-written CUDA launch on the card; the
cached-plane query is one call of :func:`ops.query_cuda.query_cached`
(probe and the read of the cached plane fields, one launch too). The
insert's probe-and-claim rounds, saturation check and moment-update rows
are one call of :func:`ops.insert_cuda.insert_claim`, one launch too; the
plane refresh (the touched voxels' moment and coordinate reads, their
plane fit and the writes of ``normal``, ``d`` and ``plane_valid``) is one
call of :func:`ops.plane_fit_cuda.refresh_planes`, one launch too. The
moment scatter sums duplicates in a fixed order (``core/segment.py``), so
the map is bit-deterministic run to run.

Lanes (the batched rollout, ``eval/batch_eval.py``; ``jax.vmap`` of these
functions in the JAX package): ``make_map(cfg, lanes=B)`` makes a lane-major
map, every field ``(B, C, ...)``, one table per lane. :func:`insert`, the
plane queries and :func:`evict_far` take it with ``(B, n, ...)`` points and
run every lane in the same launches: the kernels take the lane axis, and
the fixed-order scatter plans the lanes as one (lane b's rows from ``b *
(C + 1)``, its drop row its own). Lane b's result is the unbatched call's
on lane b's map.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import segment
from ..core.eigh3 import smallest_eigvec3
from ..core.voxel import voxel_center as _voxel_center
from ..core.voxel import voxel_coords as _voxel_coords
from ..ops.assoc_cuda import merged_moments
from ..ops.insert_cuda import insert_claim
from ..ops.plane_fit_cuda import refresh_planes as _refresh_planes
from ..ops.query_cuda import query_cached
from ..utils.device import resolve_device


class VoxelMapConfig(NamedTuple):
    capacity: int = 1 << 20  # hash slots (power of two, keep load < 0.25)
    voxel_size: float = 0.5
    insert_probes: int = 4
    claim_probes: int = 4
    query_probes: int = 4
    min_points: int = 5
    plane_var_thresh: float = 0.01
    fit_noise_floor: float = 1e-4
    max_points_per_voxel: float = 1000.0


class VoxelMap(NamedTuple):
    """SoA hash table. All tensors have leading dim = capacity (after the
    lane dim of a lane-major map)."""

    fp: torch.Tensor  # (C,) int32 fingerprint; 0 = empty, else odd
    coords: torch.Tensor  # (C, 3) int32 voxel integer coords
    moments: torch.Tensor  # (C, 10) float32 [count, psum(3), pouter(6)]
    normal: torch.Tensor  # (C, 3) float32 cached plane normal
    d: torch.Tensor  # (C,) float32 cached plane offset
    plane_valid: torch.Tensor  # (C,) int32 0/1


def make_map(cfg: VoxelMapConfig, device=None, lanes: int | None = None) -> VoxelMap:
    """An empty map; with ``lanes``, a lane-major one (every field ``(lanes,
    C, ...)``)."""
    c = cfg.capacity
    if c & (c - 1):
        raise ValueError("capacity must be a power of two")
    dev = resolve_device(device)
    z = dict(device=dev)
    lead = (c,) if lanes is None else (lanes, c)
    return VoxelMap(
        fp=torch.zeros(lead, dtype=torch.int32, **z),
        coords=torch.zeros(lead + (3,), dtype=torch.int32, **z),
        moments=torch.zeros(lead + (10,), dtype=torch.float32, **z),
        normal=torch.zeros(lead + (3,), dtype=torch.float32, **z),
        d=torch.zeros(lead, dtype=torch.float32, **z),
        plane_valid=torch.zeros(lead, dtype=torch.int32, **z),
    )


def insert(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask, refresh_planes=True):
    """Insert a masked batch of world-frame points. Returns ``(map,
    n_dropped)``.

    Fused match-or-claim probing (:func:`ops.insert_cuda.insert_claim`, one
    CUDA launch on the card): each round reads the fingerprints once,
    adopts a slot whose fingerprint matches, or claims an empty one in a
    tournament on ``pid + 1`` (highest point index wins, as in the JAX
    package); same-voxel losers adopt the winner's entry on the re-check,
    true collisions advance to the next probe offset. The moment scatter
    after it sums duplicates in a fixed order.

    Lane-major (``m`` from ``make_map(cfg, lanes=B)``, ``xyz (B, n, 3)``,
    ``mask (B, n)``): every lane in the same launches, ``n_dropped`` one
    count per lane.
    """
    cap = cfg.capacity
    lm = m.fp.dim() == 2
    fp, coords_tbl, sl, upd, n_dropped = insert_claim(
        m.fp, m.coords, m.moments, xyz.contiguous(), mask.contiguous(), cfg.voxel_size,
        max(cfg.insert_probes, cfg.claim_probes), cfg.max_points_per_voxel)
    # duplicates sum in index order on the CPU and on the card alike (no
    # atomics: core/segment.py), so the map is bit-deterministic as in JAX;
    # unassigned points go to the (lane's) drop row
    if lm:
        plan = segment.lane_plan(sl, cap + 1, dead=sl == cap)
    else:
        plan = segment.segment_plan(sl, dead=sl == cap)
    moments = segment.without_drop_row(segment.index_add_(
        segment.with_drop_row(m.moments, lm), plan, upd.reshape(-1, 10)), cap, lm)

    m = m._replace(fp=fp, coords=coords_tbl, moments=moments)
    if refresh_planes:  # the touched voxels' planes, one launch on the card
        normal, d, plane_valid = _refresh_planes(
            m.moments, m.coords, sl, m.normal, m.d, m.plane_valid, cfg.voxel_size,
            cfg.min_points, cfg.plane_var_thresh)
        m = m._replace(normal=normal, d=d, plane_valid=plane_valid)
    return m, n_dropped


def _fit_rvar(xyz, mean_world, cov, normal, lam, tot_c, cfg):
    """Per-query residual-variance inflation from surfel-fit uncertainty:
    ``(λ₀/c)·(1 + in-plane Mahalanobis offset)`` with λ and Σ floored by
    ``cfg.fit_noise_floor`` (see the JAX docstring for the derivation)."""
    eps = cfg.fit_noise_floor
    rq = xyz - mean_world
    t0 = torch.sum(normal * rq, dim=-1)
    rp = rq - t0[..., None] * normal
    a = cov[..., 0, 0] + eps
    b = cov[..., 0, 1]
    c = cov[..., 0, 2]
    d = cov[..., 1, 1] + eps
    e = cov[..., 1, 2]
    f = cov[..., 2, 2] + eps
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = torch.clamp(a * A + b * B + c * C, min=1e-18)
    x, y, z = rp[..., 0], rp[..., 1], rp[..., 2]
    sx = A * x + B * y + C * z
    sy = B * x + (a * f - c * c) * y + (b * c - a * e) * z
    sz = C * x + (b * c - a * e) * y + (a * d - b * b) * z
    inplane = torch.clamp((x * sx + y * sy + z * sz) / det, min=0.0)
    lam0 = torch.clamp(lam[..., 0], min=0.0)
    return (lam0 + eps) / torch.clamp(tot_c, min=1.0) * (1.0 + inplane)


def query_planes(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask):
    """Per-point cached plane lookup in the point's own voxel. Returns
    ``(normal (N, 3), d (N,), valid (N,) bool)``; where no slot matched,
    ``normal`` and ``d`` are slot 0's (the JAX package's clipped read)."""
    return query_cached(m.fp, m.normal, m.d, m.plane_valid, xyz.contiguous(),
                        mask.contiguous(), cfg.voxel_size, cfg.query_probes)


_STENCIL7 = np.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.int32,
)


def _merged_fit(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask, coords0, pools):
    """Merge the moments of the voxels ``pools`` ((P, N, 3) coords),
    re-referenced to the query voxel's centre, and fit one plane per query.
    Returns ``(normal, d, valid, rvar)``; lane-major, over ``(B, n)``
    queries and ``(P, B, n, 3)`` pools."""
    tot = merged_moments(m.fp, m.moments, pools, coords0, mask, cfg.voxel_size,
                         cfg.query_probes)
    return _fit_merged(cfg, xyz, mask, coords0, tot)


def _fit_merged(cfg: VoxelMapConfig, xyz, mask, coords0, tot):
    """One plane per query from its merged sums ``tot (..., 13)`` (of
    :func:`ops.assoc_cuda.merged_moments`, relative to the centre of the
    query voxel ``coords0``). Returns ``(normal, d, valid, rvar)``."""
    c0 = _voxel_center(coords0, cfg.voxel_size)
    tot_c, tot_s = tot[..., 0], tot[..., 1:4]
    tot_o = tot[..., 4:13].reshape(tuple(tot.shape[:-1]) + (3, 3))
    safe_c = torch.clamp(tot_c, min=1.0)
    mean = tot_s / safe_c[..., None]
    cov = tot_o / safe_c[..., None, None] - mean[..., :, None] * mean[..., None, :]
    normal, lam = smallest_eigvec3(cov)
    mean_world = c0 + mean
    d = -torch.sum(normal * mean_world, dim=-1)
    valid = mask & (tot_c >= cfg.min_points) & (lam[..., 0] < cfg.plane_var_thresh)
    rvar = _fit_rvar(xyz, mean_world, cov, normal, lam, tot_c, cfg)
    return normal, d, valid, rvar


def merged_pools(xyz, voxel_size):
    """``(coords0 (N, 3), pools (7, N, 3))``: each query's voxel and the
    7-voxel face stencil around it, the pools of :func:`query_planes_merged`
    (over any leading dims of ``xyz``, as the two below)."""
    coords0 = _voxel_coords(xyz, voxel_size)
    pools = torch.stack([
        torch.stack([coords0[..., i] + int(off[i]) for i in range(3)], dim=-1)
        for off in _STENCIL7
    ])
    return coords0, pools


def merged2_pools(xyz, voxel_size):
    """``(coords0 (N, 3), pools (2, N, 3))``: each query's voxel and its
    dominant face neighbour (the axis of the largest in-voxel offset, the
    first on a tie; a zero offset there gives the own voxel again, counted
    twice as in the JAX package), the pools of :func:`query_planes_merged2`."""
    coords0 = _voxel_coords(xyz, voxel_size)
    off = xyz - _voxel_center(coords0, voxel_size)
    ax = torch.argmax(torch.abs(off), dim=-1)
    onehot = (torch.arange(3, device=xyz.device) == ax[..., None]).to(torch.int32)
    step = torch.sign(torch.sum(off * onehot, dim=-1)).to(torch.int32)
    return coords0, torch.stack((coords0, coords0 + step[..., None] * onehot))


def merged3_pools(xyz, voxel_size):
    """``(coords0 (N, 3), pools (3, N, 3))``: each query's voxel and its two
    dominant face neighbours (one per largest in-voxel offset axis), the
    pools of :func:`query_planes_merged3`."""
    coords0 = _voxel_coords(xyz, voxel_size)
    off = xyz - _voxel_center(coords0, voxel_size)
    aoff = torch.abs(off)
    axes = torch.arange(3, device=xyz.device)
    ax1 = torch.argmax(aoff, dim=-1)
    oh1 = (axes == ax1[..., None]).to(torch.float32)
    # second-largest axis: mask out the winner and argmax again
    ax2 = torch.argmax(aoff * (1.0 - oh1) - oh1, dim=-1)
    oh2 = (axes == ax2[..., None]).to(torch.float32)
    sgn = torch.sign(off)
    nb1 = coords0 + (sgn * oh1).to(torch.int32)
    nb2 = coords0 + (sgn * oh2).to(torch.int32)
    return coords0, torch.stack((coords0, nb1, nb2))


def query_planes_merged(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask):
    """Plane fit from moments merged over the 7-voxel face stencil.
    Returns ``(normal, d, valid, rvar)``."""
    return _merged_fit(m, cfg, xyz, mask, *merged_pools(xyz, cfg.voxel_size))


def query_planes_merged2(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask):
    """Plane fit from the query's own voxel merged with its dominant face
    neighbour. Returns ``(normal, d, valid, rvar)``."""
    return _merged_fit(m, cfg, xyz, mask, *merged2_pools(xyz, cfg.voxel_size))


def query_planes_merged3(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask):
    """Plane fit from the query's own voxel merged with its two dominant
    face neighbours. Returns ``(normal, d, valid, rvar)``."""
    return _merged_fit(m, cfg, xyz, mask, *merged3_pools(xyz, cfg.voxel_size))


def evict_far(m: VoxelMap, cfg: VoxelMapConfig, center_xyz, det_range, do_evict=None):
    """Clear voxels farther than ``det_range`` from ``center_xyz``.

    Lane-major: ``center_xyz (B, 3)`` per lane, and ``do_evict (B,)`` bool
    (the JAX package's ``lax.cond`` under ``vmap``): a lane where it is
    false keeps every word of its map (multiplied by one)."""
    centers = _voxel_center(m.coords, cfg.voxel_size)
    dist2 = torch.sum((centers - center_xyz[..., None, :]) ** 2, dim=-1)
    keep = (m.fp != 0) & (dist2 < det_range * det_range)
    if do_evict is not None:
        keep = keep | ~do_evict[..., None]
    keepf = keep.to(torch.float32)
    keepi = keep.to(torch.int32)
    return m._replace(
        fp=m.fp * keepi,
        coords=m.coords * keepi[..., None],
        moments=m.moments * keepf[..., None],
        normal=m.normal * keepf[..., None],
        d=m.d * keepf,
        plane_valid=m.plane_valid * keepi,
    )


def occupied_centroids(m: VoxelMap, cfg: VoxelMapConfig):
    """Per-voxel mean points (world frame) + occupancy mask: a compact map
    snapshot (the localizer's ICP target)."""
    safe_c = torch.clamp(m.moments[:, 0], min=1.0)
    pts = _voxel_center(m.coords, cfg.voxel_size) + m.moments[:, 1:4] / safe_c[:, None]
    occ = m.fp != 0
    return torch.where(occ[:, None], pts, 1.0e6), occ
