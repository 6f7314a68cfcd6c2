"""The reference odometry step: FAST-LIO2's IMU propagation, deskew, voxel
downsample, iterated error-state Kalman update against the voxel-surfel
map, and map insert, for one lane.

A frozen copy of the plain PyTorch of the program's unbatched
``odom/pipeline.py: odom_step`` with ``odom/state.py``, ``odom/imu.py``
and ``odom/iekf.py``, as they stood at the benchmark's first version. The
iEKF's re-query gate is the device-side select (the host branch gives the
same result). Run it with TF32 off (:func:`slam_bench.check`): the
configurations state float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import voxel_map as vm
from .geometry import eigh3, hat, normalize_matrix, so3_exp, so3_log

GRAVITY = 9.81


class OdomConfig(NamedTuple):
    acc_cov: float = 0.1
    gyr_cov: float = 0.1
    b_acc_cov: float = 0.0001
    b_gyr_cov: float = 0.0001
    init_vel_cov: float = 0.01
    max_iteration: int = 3
    point_cov: float = 0.001
    max_residual: float = 1.0
    query_mode: str = "merged"
    requery_iters: int = 1
    requery_thresh: float = 0.125
    blind: float = 1.0
    point_filter_num: int = 4
    filter_size_surf: float = 0.5
    det_range: float = 300.0
    extrinsic_T: tuple = (0.0, 0.0, 0.0)
    extrinsic_R: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    extrinsic_est_en: bool = False
    extrinsic_prior_cov: float = 1e-4
    max_imu_per_scan: int = 32
    num_ds_points: int = 8192
    evict_every: int = 50
    init_gravity_samples: int = 10
    cv_rot_cov: float = 0.05
    cv_pos_cov: float = 0.5
    cv_vel_cov: float = 5.0
    cv_max_rate: float = 2.0
    cv_vel_alpha: float = 0.5
    degen_rel_thresh: float = 5e-3
    degen_conf_ratio: float = 1.0


class NavState(NamedTuple):
    R: torch.Tensor  # body -> world
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    g: torch.Tensor  # gravity in the world frame
    R_ext: torch.Tensor  # LiDAR -> IMU
    t_ext: torch.Tensor
    P: torch.Tensor  # (24, 24) error covariance


class ImuBatch(NamedTuple):
    stamps: torch.Tensor  # (M,) seconds since the previous scan end
    gyro: torch.Tensor
    acc: torch.Tensor
    mask: torch.Tensor


class OdomState(NamedTuple):
    nav: NavState
    vmap: vm.VoxelMap
    scan_idx: int
    initialized: bool
    w_cv: torch.Tensor


def init_state(cfg: OdomConfig, device) -> NavState:
    ext_cov = cfg.extrinsic_prior_cov if cfg.extrinsic_est_en else 1e-12
    diag = ([1e-4] * 3 + [1e-8] * 3 + [cfg.init_vel_cov] * 3 + [1e-4] * 3 + [1e-3] * 3
            + [1e-4] * 3 + [ext_cov] * 6)
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return NavState(
        R=torch.eye(3, dtype=torch.float32, device=device), p=z3.clone(), v=z3.clone(),
        bg=z3.clone(), ba=z3.clone(),
        g=torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float32, device=device),
        R_ext=torch.tensor(cfg.extrinsic_R, dtype=torch.float32, device=device).reshape(3, 3),
        t_ext=torch.tensor(cfg.extrinsic_T, dtype=torch.float32, device=device),
        P=torch.diag(torch.tensor(diag, dtype=torch.float32, device=device)))


def init_odom(map_cfg: vm.VoxelMapConfig, cfg: OdomConfig, device, R, p, v) -> OdomState:
    """A fresh lane at the pose ``(R, p)`` and velocity ``v``."""
    nav = init_state(cfg, device)._replace(R=R, p=p, v=v)
    return OdomState(nav, vm.make_map(map_cfg, device), 0, False,
                     torch.zeros((3,), dtype=torch.float32, device=device))


def boxplus(x: NavState, dx) -> NavState:
    return x._replace(
        R=normalize_matrix(x.R @ so3_exp(dx[..., 0:3])), p=x.p + dx[..., 3:6],
        v=x.v + dx[..., 6:9], bg=x.bg + dx[..., 9:12], ba=x.ba + dx[..., 12:15],
        g=x.g + dx[..., 15:18], R_ext=normalize_matrix(x.R_ext @ so3_exp(dx[..., 18:21])),
        t_ext=x.t_ext + dx[..., 21:24])


def boxminus(a: NavState, b: NavState):
    return torch.cat([so3_log(b.R.mT @ a.R), a.p - b.p, a.v - b.v, a.bg - b.bg,
                      a.ba - b.ba, a.g - b.g, so3_log(b.R_ext.mT @ a.R_ext),
                      a.t_ext - b.t_ext], dim=-1)


# --- IMU propagation and deskew -------------------------------------------
def _interval_dts(imu: ImuBatch, scan_dt):
    next_valid = torch.zeros_like(imu.mask)
    next_valid[..., :-1] = imu.mask[..., 1:]
    t_next = torch.zeros_like(imu.stamps)
    t_next[..., :-1] = imu.stamps[..., 1:]
    t_next = torch.where(next_valid, t_next, scan_dt)
    return torch.where(imu.mask, torch.clamp(t_next - imu.stamps, 0.0, 1.0), 0.0)


def _transition(R, dR, a, dts, cfg: OdomConfig):
    lead = tuple(dts.shape)
    dev = dts.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    dt3 = dts[..., None, None]
    F = torch.eye(24, dtype=torch.float32, device=dev).expand(lead + (24, 24)).clone()
    F[..., 0:3, 0:3] = dR.transpose(-1, -2)
    F[..., 0:3, 9:12] = -eye3 * dt3
    F[..., 3:6, 6:9] = eye3 * dt3
    F[..., 6:9, 0:3] = -(R @ hat(a)) * dt3
    F[..., 6:9, 12:15] = -R * dt3
    F[..., 6:9, 15:18] = eye3 * dt3
    Q = torch.zeros(lead + (24, 24), dtype=torch.float32, device=dev)
    dt2 = (dts * dts)[..., None, None]
    Q[..., 0:3, 0:3] = eye3 * cfg.gyr_cov * dt2
    Q[..., 6:9, 6:9] = eye3 * cfg.acc_cov * dt2
    Q[..., 9:12, 9:12] = eye3 * cfg.b_gyr_cov * dt2
    Q[..., 12:15, 12:15] = eye3 * cfg.b_acc_cov * dt2
    return F, Q


def propagate(x: NavState, imu: ImuBatch, cfg: OdomConfig, scan_dt):
    """State and covariance at the scan's end, and the states at the start
    of every IMU interval (for the deskew)."""
    dts = _interval_dts(imu, scan_dt)
    M = dts.shape[-1]
    w = imu.gyro - x.bg
    a = imu.acc - x.ba
    dR = so3_exp(w * dts[..., None])
    prods = [dR[0]]
    for k in range(1, M):
        prods.append(prods[-1] @ dR[k])
    R_incl = x.R[None] @ torch.stack(prods)
    R_excl = torch.cat([x.R[None], R_incl[:-1]])
    a_w = torch.einsum("mij,mj->mi", R_excl, a) + x.g
    v_incl = x.v + torch.cumsum(a_w * dts[..., None], 0)
    v_excl = torch.cat([x.v[None], v_incl[:-1]])
    p_incl = x.p + torch.cumsum(v_excl * dts[..., None] + 0.5 * a_w * dts[..., None] ** 2, 0)
    # covariance: the pairwise tree over (F, Q), (F2,Q2)∘(F1,Q1) = (F2 F1, F2 Q1 F2ᵀ + Q2)
    Fr, Qr = _transition(R_excl, dR, a, dts, cfg)
    eye24 = torch.eye(24, dtype=torch.float32, device=dts.device)
    while Fr.shape[0] > 1:
        if Fr.shape[0] % 2:
            Fr = torch.cat([Fr, eye24[None]])
            Qr = torch.cat([Qr, torch.zeros_like(Qr[:1])])
        Fa, Qa, Fb, Qb = Fr[0::2], Qr[0::2], Fr[1::2], Qr[1::2]
        Fr, Qr = Fb @ Fa, Fb @ Qa @ Fb.transpose(-1, -2) + Qb
    P_e = Fr[0] @ x.P @ Fr[0].mT + Qr[0]
    x_end = x._replace(R=normalize_matrix(R_incl[-1]), p=p_incl[-1], v=v_incl[-1], P=P_e)
    p_excl = torch.cat([x.p[None], p_incl[:-1]])
    return x_end, (R_excl, p_excl, v_excl, w, a_w, imu.stamps)


def deskew(pts_lidar, t_offsets, pt_mask, traj, x_end: NavState, imu_mask):
    """Every point moved into the scan-end body frame along the IMU path."""
    Rs, ps, vs, ws, aws, stamps = traj
    pb = pts_lidar @ x_end.R_ext.mT + x_end.t_ext
    key_stamps = torch.where(imu_mask, stamps, torch.inf).contiguous()
    idx = torch.clamp(torch.searchsorted(key_stamps, t_offsets.contiguous(), right=True) - 1,
                      0, stamps.shape[-1] - 1)
    dt = torch.clamp(t_offsets - stamps[idx], 0.0, 0.5)
    R_t = Rs[idx] @ so3_exp(ws[idx] * dt[..., None])
    p_t = ps[idx] + vs[idx] * dt[..., None] + 0.5 * aws[idx] * dt[..., None] ** 2
    pw = torch.einsum("nij,nj->ni", R_t, pb) + p_t
    return torch.where(pt_mask[..., None], (pw - x_end.p) @ x_end.R, 1.0e6)


# --- the iterated update --------------------------------------------------
def _degeneracy_remap(G, bvec, n, wc, nwc, cfg: OdomConfig, eye3):
    """The translation block projected onto its observable subspace."""
    Gt = nwc.mT @ n
    lam, V = eigh3(0.5 * (Gt + Gt.mT))
    thr = cfg.degen_rel_thresh * torch.clamp(torch.sum(wc, dim=-1), min=1e-6)
    keep0 = lam > thr
    dropped_max = torch.amax(torch.where(keep0, 0.0, lam), dim=-1, keepdim=True)
    keep = (lam > torch.maximum(thr, 2.0 * dropped_max)).to(torch.float32)
    proj = torch.where(torch.all(keep > 0.5, dim=-1), eye3, (V * keep[None, :]) @ V.mT)
    Q = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device).contiguous()
    Q[3:6, 3:6] = proj
    return Q @ G @ Q, Q @ bvec


def _solve(x, x_prop, P_inv, n, r, A, Aw, wc, nwc, cfg: OdomConfig, eye3):
    """The MAP step from the rows: ``(x_next, dx, S)``."""
    G = A.mT @ Aw
    bvec = Aw.mT @ r
    if cfg.degen_rel_thresh > 0.0:
        G, bvec = _degeneracy_remap(G, bvec, n, wc, nwc, cfg, eye3)
    cols_of = [slice(0, 6)] + ([slice(18, 24)] if cfg.extrinsic_est_en else [])
    HtRH = torch.zeros((24, 24), dtype=torch.float32, device=G.device)
    Htr = torch.zeros((24,), dtype=torch.float32, device=G.device)
    for i, sa in enumerate(cols_of):
        Htr[sa] = bvec[6 * i: 6 * i + 6]
        for j, sb in enumerate(cols_of):
            HtRH[sa, sb] = G[6 * i: 6 * i + 6, 6 * j: 6 * j + 6]
    S = HtRH + P_inv
    rhs = -(Htr + P_inv @ boxminus(x, x_prop))
    dx = torch.linalg.solve_ex(S, rhs).result
    return boxplus(x, dx), dx, S


def _map_step(x, x_prop, P_inv, q_b, p_l, planes, cfg: OdomConfig, eye3):
    plane_n, plane_d, assoc, rvar = planes
    pw = q_b @ x.R.mT + x.p
    r = torch.sum(plane_n * pw, dim=-1) + plane_d
    valid = assoc & (torch.abs(r) < cfg.max_residual)
    w = valid.to(torch.float32) / (cfg.point_cov + rvar)
    v = plane_n @ x.R
    cols = [torch.linalg.cross(q_b, v, dim=-1), plane_n]
    if cfg.extrinsic_est_en:
        cols.append(torch.linalg.cross(p_l, v @ x.R_ext, dim=-1))
        cols.append(v)
    A = torch.cat(cols, dim=-1)
    wc = nwc = None
    if cfg.degen_rel_thresh > 0.0:
        wc = (valid & (rvar < cfg.degen_conf_ratio * cfg.point_cov)).to(torch.float32) * (
            1.0 / cfg.point_cov)
        nwc = plane_n * wc[..., None]
    return (*_solve(x, x_prop, P_inv, plane_n, r, A, A * w[..., None], wc, nwc, cfg, eye3),
            valid)


def iekf_update(x_prop: NavState, pts_body, mask, vmap: vm.VoxelMap,
                map_cfg: vm.VoxelMapConfig, cfg: OdomConfig):
    """The iterated MAP update. Returns ``(state, n_matched)``."""
    dev = pts_body.device
    P_inv = torch.linalg.inv_ex(x_prop.P).inverse
    x = x_prop
    cached = cfg.query_mode not in vm.POOLS

    def planes_at(state, pts):
        return vm.query_planes_merged(vmap, map_cfg, pts @ state.R.mT + state.p, mask,
                                      cfg.query_mode)

    if cached:
        slots = None
    else:
        planes = planes_at(x, pts_body)
    p_l = (pts_body - x_prop.t_ext) @ x_prop.R_ext
    r_max = torch.amax(torch.linalg.vector_norm(pts_body, dim=-1) * mask.to(torch.float32))
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    S = dp_last = None
    n_matched = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(cfg.max_iteration):
        q_b = p_l @ x.R_ext.mT + x.t_ext if cfg.extrinsic_est_en else pts_body
        if cached:
            if it == 0 or (it <= cfg.requery_iters and cfg.requery_thresh <= 0.0):
                probe = True
            elif it <= cfg.requery_iters:
                probe = dp_last > cfg.requery_thresh
            else:
                probe = False
            ext = cfg.extrinsic_est_en
            rows = vm.cached_rows(
                x.R, x.p, q_b, mask, vmap, slots, probe, map_cfg.voxel_size,
                map_cfg.query_probes, cfg.point_cov, cfg.max_residual, cfg.degen_conf_ratio,
                q_query=pts_body if it == 0 and ext else None, p_l=p_l if ext else None,
                R_ext=x.R_ext if ext else None)
            x, dx, S = _solve(x, x_prop, P_inv, rows.n, rows.r, rows.A, rows.Aw, rows.wc,
                              rows.nwc, cfg, eye3)
            n_matched, slots = rows.n_matched, rows.slots
        else:
            if 0 < it <= cfg.requery_iters:
                if cfg.requery_thresh <= 0.0:
                    planes = planes_at(x, q_b)
                else:  # re-associate only where the last step moved far enough
                    fresh = planes_at(x, q_b)
                    moved = dp_last > cfg.requery_thresh
                    planes = tuple(torch.where(moved, a, b) for a, b in zip(fresh, planes))
            x, dx, S, valid = _map_step(x, x_prop, P_inv, q_b, p_l, planes, cfg, eye3)
            n_matched = torch.sum(valid.to(torch.int32), dim=-1)
        dp_last = (torch.linalg.vector_norm(dx[3:6], dim=-1)
                   + r_max * torch.linalg.vector_norm(dx[0:3], dim=-1))
    P_new = torch.linalg.inv_ex(S).inverse
    return x._replace(P=0.5 * (P_new + P_new.mT)), n_matched


# --- one scan -------------------------------------------------------------
def _cv_predict(nav: NavState, w_cv, scan_dt, cfg: OdomConfig) -> NavState:
    R_new = nav.R @ so3_exp(w_cv * scan_dt)
    v_new = R_new @ (nav.R.mT @ nav.v)
    dev = nav.P.device
    q = torch.cat([torch.full((3,), cfg.cv_rot_cov * scan_dt, device=dev),
                   torch.full((3,), cfg.cv_pos_cov * scan_dt, device=dev),
                   torch.full((3,), cfg.cv_vel_cov * scan_dt, device=dev),
                   torch.full((15,), 1e-8, device=dev)])
    return nav._replace(R=R_new, p=nav.p + 0.5 * (nav.v + v_new) * scan_dt, v=v_new,
                        P=nav.P + torch.diag(q))


def odom_step(state: OdomState, xyz, t_offset, pt_mask, imu: ImuBatch, scan_dt: float,
              cfg: OdomConfig, map_cfg: vm.VoxelMapConfig):
    """Advance one lane by one scan: ``(state, (R, p))``."""
    d2 = torch.sum(xyz * xyz, dim=-1)
    pt_mask = pt_mask & (d2 > cfg.blind ** 2) & (d2 < cfg.det_range ** 2)
    if cfg.point_filter_num > 1:
        idx = torch.arange(xyz.shape[0], device=xyz.device)
        pt_mask = pt_mask & ((idx % cfg.point_filter_num) == 0)
    has_imu = torch.any(imu.mask)
    nav_imu, traj = propagate(state.nav, imu, cfg, scan_dt)
    nav0 = state.nav
    nav_prop = NavState(*(torch.where(has_imu, a, b) for a, b in
                          zip(nav_imu, _cv_predict(nav0, state.w_cv, scan_dt, cfg))))
    pts_body = deskew(xyz, t_offset, pt_mask, traj, nav_prop, imu.mask)
    pts_cv = torch.where(pt_mask[:, None], xyz @ nav0.R_ext.T + nav0.t_ext
                         - (nav0.R.T @ nav0.v)[None, :] * (scan_dt - t_offset)[:, None], 1.0e6)
    pts_body = torch.where(has_imu, pts_body, pts_cv)
    ds_xyz, ds_mask = vm.voxel_downsample(pts_body, pt_mask, cfg.filter_size_surf)
    budget = min(cfg.num_ds_points, ds_xyz.shape[0])
    pts, msk = ds_xyz[:budget], ds_mask[:budget]

    nav_upd, _ = iekf_update(nav_prop, pts, msk, state.vmap, map_cfg, cfg)
    v_fd = (nav_upd.p - nav0.p) / max(scan_dt, 1e-3)
    v_sm = cfg.cv_vel_alpha * v_fd + (1.0 - cfg.cv_vel_alpha) * nav0.v
    nav_upd = nav_upd._replace(v=torch.where(has_imu, nav_upd.v, v_sm))
    nav_new = nav_upd if state.initialized else nav_prop
    w_fd = so3_log(nav0.R.T @ nav_new.R) / max(scan_dt, 1e-3)
    w_mag = torch.linalg.vector_norm(w_fd)
    w_fd = w_fd * torch.clamp(cfg.cv_max_rate / torch.clamp(w_mag, min=1e-9), max=1.0)
    w_cv_new = torch.where(has_imu, state.w_cv, w_fd)

    vmap, _ = vm.insert(state.vmap, map_cfg, pts @ nav_new.R.T + nav_new.p, msk,
                        refresh_planes=cfg.query_mode == "cached")
    if state.scan_idx % cfg.evict_every == cfg.evict_every - 1:
        vmap = vm.evict_far(vmap, map_cfg, nav_new.p, cfg.det_range)
    return OdomState(nav_new, vmap, state.scan_idx + 1, True, w_cv_new), (nav_new.R, nav_new.p)
