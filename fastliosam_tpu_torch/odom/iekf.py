"""Iterated error-state Kalman update with point-to-plane map matching (port
of ``fastliosam_tpu/odom/iekf.py``).

Each iteration transforms the downsampled, deskewed scan into the world
frame, takes per-point planes from the voxel-surfel map, and solves the
MAP system built from the (N, 6) residual Jacobian's Gram matrix, with the
``rvar`` heteroscedastic weights and the degeneracy-aware remap of the
translation block. The adaptive re-association gate is a ``lax.cond`` in
JAX. Here it is either a host branch on one counted device read per gated
iteration (the per-scan path), or, with ``gate_on_device=True`` (the
chunked path, which reads nothing back inside a chunk), a device-side
select between a fresh association, always computed, and the previous
one: the same result for one more association pass per gated iteration
that the gate would have skipped. Linear algebra uses the ``*_ex`` forms,
which skip the error check that would otherwise sync with the device.

:func:`iekf_update` also takes B lanes at once (the batched rollout,
``eval/batch_eval.py``): a batched state, ``(B, n)`` points and a
lane-major map. Every operation runs over the leading lane dim, each lane
has its own lever arm ``r_max``, and the re-query gate is the device-side
select, per lane (the JAX package's ``lax.cond`` under ``vmap``).
"""
from __future__ import annotations

import torch

from ..core.eigh3 import eigh3
from ..map import voxel_hash as vh
from ..utils.sync import host_read
from .state import NavState, OdomConfig, boxminus, boxplus, matvec


def _query_planes(x, pts_body, mask, vmap, map_cfg, cfg: OdomConfig):
    """``(normal, d, valid, rvar)`` of each point's plane at state ``x``;
    ``rvar`` is 0 in the cached single-voxel mode, whose stored planes carry
    no moment record. Batched states take ``(B, n, 3)`` points and a
    lane-major map."""
    pw = pts_body @ x.R.mT + x.p[..., None, :]
    if cfg.query_mode == "merged":
        return vh.query_planes_merged(vmap, map_cfg, pw, mask)
    if cfg.query_mode == "merged2":
        return vh.query_planes_merged2(vmap, map_cfg, pw, mask)
    if cfg.query_mode == "merged3":
        return vh.query_planes_merged3(vmap, map_cfg, pw, mask)
    n, d, valid = vh.query_planes(vmap, map_cfg, pw, mask)
    return n, d, valid, torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)


def _degeneracy_remap(G, bvec, n, valid, rvar, cfg: OdomConfig, eye3):
    """Project the translation block of the measurement system onto its
    observable subspace, from confident evidence only (see the JAX
    docstring); over leading lane dims."""
    dev = G.device
    wc = (
        valid & (rvar < cfg.degen_conf_ratio * cfg.point_cov)
    ).to(torch.float32) * (1.0 / cfg.point_cov)
    Gt = (n * wc[..., None]).mT @ n
    lam, V = eigh3(0.5 * (Gt + Gt.mT))
    scale = torch.clamp(torch.sum(wc, dim=-1), min=1e-6)
    thr = (cfg.degen_rel_thresh * scale)[..., None]
    keep0 = lam > thr
    dropped_max = torch.amax(torch.where(keep0, 0.0, lam), dim=-1, keepdim=True)
    keep = (lam > torch.maximum(thr, 2.0 * dropped_max)).to(torch.float32)
    proj = torch.where(
        torch.all(keep > 0.5, dim=-1)[..., None, None], eye3,
        (V * keep[..., None, :]) @ V.mT,
    )
    Q = torch.eye(G.shape[-1], dtype=G.dtype, device=dev).expand(G.shape).contiguous()
    Q[..., 3:6, 3:6] = proj
    return Q @ G @ Q, matvec(Q, bvec)


def _map_step(x, x_prop, P_inv, q_b, p_l, planes, cfg: OdomConfig, eye3):
    """One iteration's MAP step at the association ``planes``: residuals
    and weights, the Jacobian's Gram matrix and rhs (with the degeneracy
    remap), the 24x24 solve. Returns ``(x_next, dx, S, valid)``."""
    plane_n, plane_d, assoc, rvar = planes
    pw = q_b @ x.R.mT + x.p[..., None, :]
    n = plane_n
    r = torch.sum(n * pw, dim=-1) + plane_d
    valid = assoc & (torch.abs(r) < cfg.max_residual)
    w = valid.to(torch.float32) / (cfg.point_cov + rvar)
    v = n @ x.R  # Rᵀ n per point
    cols = [torch.linalg.cross(q_b, v, dim=-1), n]
    if cfg.extrinsic_est_en:
        v_ext = v @ x.R_ext
        cols.append(torch.linalg.cross(p_l, v_ext, dim=-1))
        cols.append(v)
    A = torch.cat(cols, dim=-1)
    Aw = A * w[..., None]
    G = A.mT @ Aw
    bvec = matvec(Aw.mT, r)
    if cfg.degen_rel_thresh > 0.0:
        G, bvec = _degeneracy_remap(G, bvec, n, valid, rvar, cfg, eye3)
    # state columns of the Jacobian: pose (0:6) and, when estimated, the
    # extrinsic (18:24) — slices, so nothing is uploaded per scan
    cols_of = [slice(0, 6)] + ([slice(18, 24)] if cfg.extrinsic_est_en else [])
    lead = tuple(G.shape[:-2])
    HtRH = torch.zeros(lead + (24, 24), dtype=torch.float32, device=G.device)
    Htr = torch.zeros(lead + (24,), dtype=torch.float32, device=G.device)
    for a, sa in enumerate(cols_of):
        Htr[..., sa] = bvec[..., 6 * a: 6 * a + 6]
        for b, sb in enumerate(cols_of):
            HtRH[..., sa, sb] = G[..., 6 * a: 6 * a + 6, 6 * b: 6 * b + 6]
    dxi = boxminus(x, x_prop)
    S = HtRH + P_inv
    rhs = -(Htr + matvec(P_inv, dxi))
    dx = torch.linalg.solve_ex(S, rhs).result
    return boxplus(x, dx), dx, S, valid


def iekf_update(
    x_prop: NavState,
    pts_body,
    mask,
    vmap: vh.VoxelMap,
    map_cfg: vh.VoxelMapConfig,
    cfg: OdomConfig,
    gate_on_device: bool = False,
):
    """Iterated MAP update. Returns ``(state, n_matched)``. A batched
    ``x_prop`` takes ``(B, n, 3)`` points with ``(B, n)`` masks and a
    lane-major map, needs ``gate_on_device``, and returns ``n_matched
    (B,)``."""
    if x_prop.R.dim() > 2 and not gate_on_device and cfg.requery_thresh > 0.0:
        raise ValueError("a batched update gates its re-query per lane: pass gate_on_device")
    dev = pts_body.device
    P_inv = torch.linalg.inv_ex(x_prop.P).inverse
    x = x_prop

    planes = _query_planes(x, pts_body, mask, vmap, map_cfg, cfg)
    # LiDAR-frame points through the propagated extrinsic; the model below
    # re-applies the current extrinsic each iteration
    p_l = (pts_body - x_prop.t_ext[..., None, :]) @ x_prop.R_ext
    # lever arm of the re-query trigger: the farthest valid point (per lane)
    r_max = torch.amax(torch.linalg.vector_norm(pts_body, dim=-1) * mask.to(torch.float32),
                       dim=-1)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    S = None
    dp_last = None  # association displacement of the previous iteration
    n_matched = torch.zeros(mask.shape[:-1], dtype=torch.int32, device=dev)
    for it in range(cfg.max_iteration):
        q_b = p_l @ x.R_ext.mT + x.t_ext[..., None, :] if cfg.extrinsic_est_en else pts_body
        if 0 < it <= cfg.requery_iters:
            # adaptive: re-associate only when the previous step moved far
            # enough to invalidate the association
            if cfg.requery_thresh <= 0.0:
                planes = _query_planes(x, q_b, mask, vmap, map_cfg, cfg)
            elif gate_on_device:
                fresh = _query_planes(x, q_b, mask, vmap, map_cfg, cfg)
                moved = dp_last > cfg.requery_thresh
                planes = tuple(
                    torch.where(moved.reshape(moved.shape + (1,) * (a.dim() - moved.dim())), a, b)
                    for a, b in zip(fresh, planes)
                )
            elif bool(host_read(dp_last > cfg.requery_thresh)):  # one host read
                planes = _query_planes(x, q_b, mask, vmap, map_cfg, cfg)
        x, dx, S, valid = _map_step(x, x_prop, P_inv, q_b, p_l, planes, cfg, eye3)
        n_matched = torch.sum(valid.to(torch.int32), dim=-1)
        dp_last = (torch.linalg.vector_norm(dx[..., 3:6], dim=-1)
                   + r_max * torch.linalg.vector_norm(dx[..., 0:3], dim=-1))

    P_new = torch.linalg.inv_ex(S).inverse
    P_new = 0.5 * (P_new + P_new.mT)
    return x._replace(P=P_new), n_matched
