"""The reference's voxel-surfel hash map and its scan downsample, one lane.

A frozen copy of the plain PyTorch versions of the program's map
(``map/voxel_hash.py`` with the plain versions of its kernels:
``merged_moments``, ``insert_claim``, ``refresh_planes``, ``cached_rows``)
and of ``core/pointcloud.py: voxel_downsample``, as they stood at the
benchmark's first version. An open-addressing table of 0.5 m voxels, each
holding ``[count, Σ(p - c) (3), Σ outer (6)]`` about its centre, an odd
fingerprint word per slot (0: empty) and, where planes are cached, each
voxel's fitted plane.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .geometry import (fingerprint, hash_slot, index_add_, scatter_add,
                       smallest_eigvec3, voxel_center, voxel_coords)

PAD_VALUE = 1.0e6


class VoxelMapConfig(NamedTuple):
    capacity: int = 1 << 20
    voxel_size: float = 0.5
    insert_probes: int = 4
    claim_probes: int = 4
    query_probes: int = 4
    min_points: int = 5
    plane_var_thresh: float = 0.01
    fit_noise_floor: float = 1e-4
    max_points_per_voxel: float = 1000.0


class VoxelMap(NamedTuple):
    fp: torch.Tensor  # (C,) int32, 0 = empty, else odd
    coords: torch.Tensor  # (C, 3) int32
    moments: torch.Tensor  # (C, 10) float32
    normal: torch.Tensor  # (C, 3) float32 cached plane
    d: torch.Tensor  # (C,) float32
    plane_valid: torch.Tensor  # (C,) int32


def make_map(cfg: VoxelMapConfig, device) -> VoxelMap:
    c = cfg.capacity
    if c & (c - 1):
        raise ValueError("capacity must be a power of two")
    z = dict(device=device)
    return VoxelMap(torch.zeros((c,), dtype=torch.int32, **z),
                    torch.zeros((c, 3), dtype=torch.int32, **z),
                    torch.zeros((c, 10), dtype=torch.float32, **z),
                    torch.zeros((c, 3), dtype=torch.float32, **z),
                    torch.zeros((c,), dtype=torch.float32, **z),
                    torch.zeros((c,), dtype=torch.int32, **z))


def _rows(table, idx, valid=None):
    """``table[idx]`` with negative indices wrapped once and clamped; zero
    rows where ``valid`` is false."""
    c = table.shape[0]
    i = idx.to(torch.int64)
    out = table[torch.clamp(torch.where(i < 0, i + c, i), 0, c - 1)]
    if valid is not None:
        keep = valid.reshape(tuple(valid.shape) + (1,) * (out.dim() - valid.dim()))
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def find_slots(fp, coords, mask, probes: int):
    """``(slots (int64, -1 where none), found)``: the first slot of the
    probe window whose fingerprint matches, where ``mask`` holds."""
    cap = fp.shape[0]
    h0 = hash_slot(coords, cap).to(torch.int64)
    want = fingerprint(coords)
    slots = torch.full(coords.shape[:-1], -1, dtype=torch.int64, device=coords.device)
    for p in range(probes):
        cand = (h0 + p) & (cap - 1)
        slots = torch.where((slots < 0) & (_rows(fp, cand) == want) & mask, cand, slots)
    return slots, slots >= 0


# --- association: merged moments of pools of voxels ----------------------
_STENCIL7 = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                      [0, 0, -1]], dtype=np.int32)


def merged_pools(xyz, voxel_size):
    """The query's voxel and its 7-voxel face stencil."""
    coords0 = voxel_coords(xyz, voxel_size)
    return coords0, torch.stack([
        torch.stack([coords0[..., i] + int(off[i]) for i in range(3)], dim=-1)
        for off in _STENCIL7])


def merged2_pools(xyz, voxel_size):
    """The query's voxel and its dominant face neighbour."""
    coords0 = voxel_coords(xyz, voxel_size)
    off = xyz - voxel_center(coords0, voxel_size)
    ax = torch.argmax(torch.abs(off), dim=-1)
    onehot = (torch.arange(3, device=xyz.device) == ax[..., None]).to(torch.int32)
    step = torch.sign(torch.sum(off * onehot, dim=-1)).to(torch.int32)
    return coords0, torch.stack((coords0, coords0 + step[..., None] * onehot))


def merged3_pools(xyz, voxel_size):
    """The query's voxel and its two dominant face neighbours."""
    coords0 = voxel_coords(xyz, voxel_size)
    off = xyz - voxel_center(coords0, voxel_size)
    aoff = torch.abs(off)
    axes = torch.arange(3, device=xyz.device)
    oh1 = (axes == torch.argmax(aoff, dim=-1)[..., None]).to(torch.float32)
    oh2 = (axes == torch.argmax(aoff * (1.0 - oh1) - oh1, dim=-1)[..., None]).to(torch.float32)
    sgn = torch.sign(off)
    return coords0, torch.stack((coords0, coords0 + (sgn * oh1).to(torch.int32),
                                 coords0 + (sgn * oh2).to(torch.int32)))


POOLS = {"merged": merged_pools, "merged2": merged2_pools, "merged3": merged3_pools}


def merged_moments(m: VoxelMap, pools, coords0, mask, voxel_size: float, probes: int):
    """``(n, 13)`` ``[count, Σ (3), Σ outer (3x3)]`` of every pool voxel found,
    shifted to the query voxel's centre and summed over the pools."""
    c0 = voxel_center(coords0, voxel_size)
    lead = tuple(coords0.shape[:-1])
    dev = coords0.device
    tot_c = torch.zeros(lead, dtype=torch.float32, device=dev)
    tot_s = torch.zeros(lead + (3,), dtype=torch.float32, device=dev)
    tot_o = torch.zeros(lead + (3, 3), dtype=torch.float32, device=dev)
    for coords in pools:
        slots, found = find_slots(m.fp, coords, mask, probes)
        mom = _rows(m.moments, slots, valid=found)
        ci, si = mom[..., 0], mom[..., 1:4]
        xx, xy, xz, yy, yz, zz = mom[..., 4:10].unbind(-1)
        oi = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(lead + (3, 3))
        dc = voxel_center(coords, voxel_size) - c0
        tot_c = tot_c + ci
        tot_s = tot_s + si + ci[..., None] * dc
        cross = si[..., :, None] * dc[..., None, :]
        tot_o = (tot_o + oi + cross + cross.transpose(-1, -2)
                 + ci[..., None, None] * (dc[..., :, None] * dc[..., None, :]))
    return torch.cat([tot_c[..., None], tot_s, tot_o.reshape(lead + (9,))], dim=-1)


def _fit_rvar(xyz, mean_world, cov, normal, lam, tot_c, cfg: VoxelMapConfig):
    """Residual-variance inflation from the surfel fit's uncertainty."""
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


def query_planes_merged(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask, mode: str):
    """One plane per query from the merged moments of its pools: ``(normal,
    d, valid, rvar)``."""
    coords0, pools = POOLS[mode](xyz, cfg.voxel_size)
    tot = merged_moments(m, pools, coords0, mask, cfg.voxel_size, cfg.query_probes)
    c0 = voxel_center(coords0, cfg.voxel_size)
    tot_c, tot_s = tot[..., 0], tot[..., 1:4]
    tot_o = tot[..., 4:13].reshape(tuple(tot.shape[:-1]) + (3, 3))
    safe_c = torch.clamp(tot_c, min=1.0)
    mean = tot_s / safe_c[..., None]
    cov = tot_o / safe_c[..., None, None] - mean[..., :, None] * mean[..., None, :]
    normal, lam = smallest_eigvec3(cov)
    mean_world = c0 + mean
    d = -torch.sum(normal * mean_world, dim=-1)
    valid = mask & (tot_c >= cfg.min_points) & (lam[..., 0] < cfg.plane_var_thresh)
    return normal, d, valid, _fit_rvar(xyz, mean_world, cov, normal, lam, tot_c, cfg)


# --- the cached-plane rows of one iEKF iteration -------------------------
class CachedRows(NamedTuple):
    n: torch.Tensor
    r: torch.Tensor
    valid: torch.Tensor
    A: torch.Tensor
    Aw: torch.Tensor
    wc: torch.Tensor
    nwc: torch.Tensor
    n_matched: torch.Tensor
    slots: torch.Tensor  # int32 association (-1: none), carried between iterations


def cached_rows(R, p, q_b, mask, m: VoxelMap, slots, probe, voxel_size: float, probes: int,
                point_cov: float, max_residual: float, degen_conf_ratio: float,
                q_query=None, p_l=None, R_ext=None) -> CachedRows:
    """The cached-plane query (where ``probe`` asks: True, False, or a 0-dim
    bool tensor) and every per-point row of one iteration at ``(R, p)``."""
    pw = q_b @ R.mT + p
    if probe is False:
        sl = slots
    else:
        pq = pw if q_query is None else q_query @ R.mT + p
        fresh = find_slots(m.fp, voxel_coords(pq, voxel_size), mask, probes)[0].to(torch.int32)
        sl = fresh if probe is True else torch.where(probe, fresh, slots)
    i = torch.clamp(sl, min=0)
    n = _rows(m.normal, i)
    assoc = (sl >= 0) & (_rows(m.plane_valid, i) > 0) & mask
    rvar = torch.zeros(assoc.shape, dtype=torch.float32, device=assoc.device)
    r = torch.sum(n * pw, dim=-1) + _rows(m.d, i)
    valid = assoc & (torch.abs(r) < max_residual)
    w = valid.to(torch.float32) / (point_cov + rvar)
    v = n @ R
    cols = [torch.linalg.cross(q_b, v, dim=-1), n]
    if p_l is not None:
        cols.append(torch.linalg.cross(p_l, v @ R_ext, dim=-1))
        cols.append(v)
    A = torch.cat(cols, dim=-1)
    wc = (valid & (rvar < degen_conf_ratio * point_cov)).to(torch.float32) * (1.0 / point_cov)
    return CachedRows(n=n, r=r, valid=valid, A=A, Aw=A * w[..., None], wc=wc,
                      nwc=n * wc[..., None], n_matched=torch.sum(valid.to(torch.int32), dim=-1),
                      slots=sl)


# --- insert ----------------------------------------------------------------
def _outer6(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def _claim(m: VoxelMap, xyz, mask, voxel_size: float, rounds: int, max_points: float):
    """Match-or-claim rounds: adopt a slot whose fingerprint matches, or
    claim an empty one (the highest point index wins). Returns the new
    fingerprint and coordinate tables, each point's slot (``C`` where
    unassigned), its moment update and the count left unassigned."""
    cap = m.fp.shape[0]
    dev = xyz.device
    vc = voxel_coords(xyz, voxel_size)
    h0 = hash_slot(vc, cap).to(torch.int64)
    want = fingerprint(vc)
    n = xyz.shape[0]
    pid1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    fp = m.fp.clone()
    slots = torch.full((n,), -1, dtype=torch.int64, device=dev)
    poff = torch.zeros((n,), dtype=torch.int64, device=dev)
    won_slot = torch.full((n,), cap, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        cand = (h0 + poff) & (cap - 1)
        unassigned = (slots < 0) & mask
        cur = _rows(fp, cand)
        slots = torch.where(unassigned & (cur == want), cand, slots)
        tryclaim = unassigned & (cur == 0)
        claim = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, cand, torch.where(tryclaim, pid1, 0), "amax")
        won = tryclaim & (claim[cand] == pid1)
        fp.index_add_(0, cand, want * won.to(torch.int32))
        won_slot = torch.where(won, cand, won_slot)
        cur2 = _rows(fp, cand)
        slots = torch.where((slots < 0) & mask & (cur2 == want), cand, slots)
        poff = torch.where((slots < 0) & mask & (cur2 != 0) & (cur2 != want), poff + 1, poff)
    coords = torch.cat([m.coords, torch.zeros_like(m.coords[:1])])
    coords[won_slot] = vc
    coords = coords[:cap].contiguous()
    assigned = (slots >= 0) & mask
    n_dropped = torch.sum(mask & ~assigned, dtype=torch.int32)
    sl = torch.where(assigned, slots, cap)
    room = _rows(m.moments, sl)[..., 0] < max_points
    w = (assigned & room).to(torch.float32)
    rel = xyz - voxel_center(vc, voxel_size)
    upd = torch.cat([torch.ones_like(w)[..., None], rel, _outer6(rel)], dim=-1) * w[..., None]
    return fp, coords, sl, upd, n_dropped


def _unpack_sym(m6):
    xx, xy, xz, yy, yz, zz = (m6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1), torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def _refresh_planes(m: VoxelMap, slots, cfg: VoxelMapConfig):
    """Refit the planes of the voxels at ``slots`` from their moments."""
    cap = m.moments.shape[0]
    mom = _rows(m.moments, slots)
    c = mom[..., 0]
    safe_c = torch.clamp(c, min=1.0)
    mean_rel = mom[..., 1:4] / safe_c[..., None]
    cov = _unpack_sym(mom[..., 4:10]) / safe_c[..., None, None] - (
        mean_rel[..., :, None] * mean_rel[..., None, :])
    nrm, lam = smallest_eigvec3(cov)
    mean_world = voxel_center(_rows(m.coords, slots), cfg.voxel_size) + mean_rel
    dd = -torch.sum(nrm * mean_world, dim=-1)
    pv = ((c >= cfg.min_points) & (lam[..., 0] < cfg.plane_var_thresh)).to(torch.int32)
    out = []
    for table, value in ((m.normal, nrm), (m.d, dd), (m.plane_valid, pv)):
        t = torch.cat([table, torch.zeros_like(table[:1])])
        t[slots] = value  # duplicates write identical values
        out.append(t[:cap])
    return m._replace(normal=out[0], d=out[1], plane_valid=out[2])


def refit_planes(m: VoxelMap, cfg: VoxelMapConfig) -> VoxelMap:
    """Every occupied voxel's plane refitted from its moments."""
    return _refresh_planes(m, torch.nonzero(m.fp != 0).squeeze(1), cfg)


def insert(m: VoxelMap, cfg: VoxelMapConfig, xyz, mask, refresh_planes: bool):
    """Insert masked world points. Returns ``(map, n_dropped)``."""
    cap = cfg.capacity
    fp, coords, sl, upd, n_dropped = _claim(
        m, xyz, mask, cfg.voxel_size, max(cfg.insert_probes, cfg.claim_probes),
        cfg.max_points_per_voxel)
    moments = torch.cat([m.moments, torch.zeros_like(m.moments[:1])])
    moments = index_add_(moments, sl, upd.reshape(-1, 10), dead=sl == cap)[:cap]
    m = m._replace(fp=fp, coords=coords, moments=moments)
    if refresh_planes:
        m = _refresh_planes(m, sl, cfg)
    return m, n_dropped


def evict_far(m: VoxelMap, cfg: VoxelMapConfig, center_xyz, det_range):
    """Clear the voxels farther than ``det_range`` from ``center_xyz``."""
    centers = voxel_center(m.coords, cfg.voxel_size)
    keep = (m.fp != 0) & (torch.sum((centers - center_xyz) ** 2, dim=-1) < det_range ** 2)
    keepf, keepi = keep.to(torch.float32), keep.to(torch.int32)
    return VoxelMap(m.fp * keepi, m.coords * keepi[:, None], m.moments * keepf[:, None],
                    m.normal * keepf[:, None], m.d * keepf, m.plane_valid * keepi)


# --- the scan's voxel downsample ------------------------------------------
_SENTINEL_KEY = 0x3FFFFFFF


def voxel_downsample(xyz, mask, voxel_size: float):
    """Centroid per occupied voxel of a grid anchored at the masked minimum
    corner, packed to the front in ascending key order; ``(xyz, mask)`` at
    the input's capacity."""
    n = xyz.shape[0]
    dev = xyz.device
    big = torch.where(mask[..., None], xyz, torch.inf)
    lo = torch.amin(big, dim=-2, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    ij = torch.clamp(torch.floor((xyz - lo) * (1.0 / voxel_size)).to(torch.int32), 0, 1022)
    keys = torch.where(mask, (ij[..., 0] << 20) | (ij[..., 1] << 10) | ij[..., 2],
                       _SENTINEL_KEY).to(torch.int32)
    order = torch.argsort(keys, stable=True)
    skeys, sxyz, smask = keys[order], xyz[order], mask[order]
    is_start = torch.ones((n,), dtype=torch.int64, device=dev)
    is_start[1:] = (skeys[1:] != skeys[:-1]).to(torch.int64)
    seg = torch.cumsum(is_start, 0) - 1
    w = smask.to(torch.float32)
    acc = scatter_add(seg, torch.cat([sxyz * w[:, None], w[:, None]], dim=1), n, dead=~smask)
    cnts = acc[:, 3]
    centroids = acc[:, :3] / torch.clamp(cnts, min=1.0)[:, None]
    occupied = cnts > 0.0
    dest = torch.where(occupied, torch.cumsum(occupied.to(torch.int64), 0) - 1, n)
    out_xyz = torch.full((n + 1, 3), PAD_VALUE, dtype=torch.float32, device=dev)
    out_xyz[dest] = centroids
    out_mask = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    out_mask[dest] = occupied
    return out_xyz[:n], out_mask[:n]
