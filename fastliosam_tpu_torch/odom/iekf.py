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
"""
from __future__ import annotations

import torch

from ..core.eigh3 import eigh3
from ..map import voxel_hash as vh
from ..utils.sync import host_read
from .state import NavState, OdomConfig, boxminus, boxplus


def _query_planes(x, pts_body, mask, vmap, map_cfg, cfg: OdomConfig):
    """``(normal, d, valid, rvar)`` of each point's plane at state ``x``;
    ``rvar`` is 0 in the cached single-voxel mode, whose stored planes carry
    no moment record."""
    pw = pts_body @ x.R.T + x.p
    if cfg.query_mode == "merged":
        return vh.query_planes_merged(vmap, map_cfg, pw, mask)
    if cfg.query_mode == "merged2":
        return vh.query_planes_merged2(vmap, map_cfg, pw, mask)
    if cfg.query_mode == "merged3":
        return vh.query_planes_merged3(vmap, map_cfg, pw, mask)
    n, d, valid = vh.query_planes(vmap, map_cfg, pw, mask)
    return n, d, valid, torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)


def iekf_update(
    x_prop: NavState,
    pts_body,
    mask,
    vmap: vh.VoxelMap,
    map_cfg: vh.VoxelMapConfig,
    cfg: OdomConfig,
    gate_on_device: bool = False,
):
    """Iterated MAP update. Returns ``(state, n_matched)``."""
    dev = pts_body.device
    P_inv = torch.linalg.inv_ex(x_prop.P).inverse
    x = x_prop
    inv_R = 1.0 / cfg.point_cov

    plane_n, plane_d, assoc, rvar = _query_planes(
        x, pts_body, mask, vmap, map_cfg, cfg
    )
    # LiDAR-frame points through the propagated extrinsic; the model below
    # re-applies the current extrinsic each iteration
    p_l = (pts_body - x_prop.t_ext) @ x_prop.R_ext
    # lever arm of the re-query trigger: the farthest valid point
    r_max = torch.max(
        torch.linalg.vector_norm(pts_body, dim=-1) * mask.to(torch.float32)
    )
    # state columns of the Jacobian: pose (0:6) and, when estimated, the
    # extrinsic (18:24) — slices, so nothing is uploaded per scan
    cols_of = [slice(0, 6)] + ([slice(18, 24)] if cfg.extrinsic_est_en else [])
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    S = None
    dp_last = None  # association displacement of the previous iteration
    n_matched = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(cfg.max_iteration):
        q_b = p_l @ x.R_ext.T + x.t_ext if cfg.extrinsic_est_en else pts_body
        if 0 < it <= cfg.requery_iters:
            # adaptive: re-associate only when the previous step moved far
            # enough to invalidate the association
            if cfg.requery_thresh <= 0.0:
                plane_n, plane_d, assoc, rvar = _query_planes(
                    x, q_b, mask, vmap, map_cfg, cfg
                )
            elif gate_on_device:
                fresh = _query_planes(x, q_b, mask, vmap, map_cfg, cfg)
                moved = dp_last > cfg.requery_thresh
                plane_n, plane_d, assoc, rvar = (
                    torch.where(moved, a, b)
                    for a, b in zip(fresh, (plane_n, plane_d, assoc, rvar))
                )
            elif bool(host_read(dp_last > cfg.requery_thresh)):  # one host read
                plane_n, plane_d, assoc, rvar = _query_planes(
                    x, q_b, mask, vmap, map_cfg, cfg
                )
        pw = q_b @ x.R.T + x.p
        n = plane_n
        r = torch.sum(n * pw, dim=-1) + plane_d
        valid = assoc & (torch.abs(r) < cfg.max_residual)
        w = valid.to(torch.float32) / (cfg.point_cov + rvar)
        n_matched = torch.sum(valid.to(torch.int32))
        v = n @ x.R  # Rᵀ n per point
        cols = [torch.linalg.cross(q_b, v, dim=-1), n]
        if cfg.extrinsic_est_en:
            v_ext = v @ x.R_ext
            cols.append(torch.linalg.cross(p_l, v_ext, dim=-1))
            cols.append(v)
        A = torch.cat(cols, dim=-1)
        Aw = A * w[:, None]
        G = A.T @ Aw
        bvec = Aw.T @ r
        if cfg.degen_rel_thresh > 0.0:
            # degeneracy-aware remap from confident evidence only (see the
            # JAX docstring): project the translation block of the
            # measurement system onto the observable subspace
            wc = (
                valid & (rvar < cfg.degen_conf_ratio * cfg.point_cov)
            ).to(torch.float32) * inv_R
            Gt = (n * wc[:, None]).T @ n
            lam, V = eigh3(0.5 * (Gt + Gt.T))
            scale = torch.clamp(torch.sum(wc), min=1e-6)
            thr = cfg.degen_rel_thresh * scale
            keep0 = lam > thr
            dropped_max = torch.max(torch.where(keep0, 0.0, lam))
            keep = (lam > torch.maximum(thr, 2.0 * dropped_max)).to(torch.float32)
            proj = torch.where(
                torch.all(keep > 0.5), eye3, (V * keep[None, :]) @ V.T
            )
            Q = torch.eye(G.shape[0], dtype=G.dtype, device=dev)
            Q[3:6, 3:6] = proj
            G = Q @ G @ Q
            bvec = Q @ bvec
        HtRH = torch.zeros((24, 24), dtype=torch.float32, device=dev)
        Htr = torch.zeros((24,), dtype=torch.float32, device=dev)
        for a, sa in enumerate(cols_of):
            Htr[sa] = bvec[6 * a: 6 * a + 6]
            for b, sb in enumerate(cols_of):
                HtRH[sa, sb] = G[6 * a: 6 * a + 6, 6 * b: 6 * b + 6]
        dxi = boxminus(x, x_prop)
        S = HtRH + P_inv
        rhs = -(Htr + P_inv @ dxi)
        dx = torch.linalg.solve_ex(S, rhs).result
        dp_last = torch.linalg.vector_norm(dx[3:6]) + r_max * torch.linalg.vector_norm(dx[0:3])
        x = boxplus(x, dx)

    P_new = torch.linalg.inv_ex(S).inverse
    P_new = 0.5 * (P_new + P_new.T)
    return x._replace(P=P_new), n_matched
