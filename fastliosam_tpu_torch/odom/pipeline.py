"""The per-scan odometry step: preprocess → propagate → deskew → downsample
→ iterated update → map insert → periodic eviction (port of
``fastliosam_tpu/odom/pipeline.py``).

Where the JAX step uses ``lax.cond``:
  * IMU vs. IMU-less prediction: both are computed and selected with
    ``torch.where`` (the IMU-less branch is a handful of 3x3 ops);
  * ``initialized`` and the eviction cadence: host branches on host state —
    ``OdomState.scan_idx`` and ``initialized`` are Python values here, since
    they evolve identically on every run and reading them back from the
    device would cost a sync per scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import so3
from ..core.pointcloud import Cloud, voxel_downsample
from ..map import voxel_hash as vh
from ..utils.device import resolve_device, to_device
from ..utils.precision import geometry_precision
from .iekf import iekf_update
from .imu import ImuBatch, deskew, propagate
from .state import GRAVITY, NavState, OdomConfig, init_state


class Scan(NamedTuple):
    """One LiDAR sweep in the sensor frame; ``t_offset`` is seconds since
    the previous scan end (the IMU batch's clock)."""

    xyz: torch.Tensor  # (N, 3)
    t_offset: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)


class OdomState(NamedTuple):
    nav: NavState
    vmap: vh.VoxelMap
    scan_idx: int  # host counter
    initialized: bool  # host flag (map bootstrapped)
    w_cv: torch.Tensor  # (3,) rad/s, IMU-less coordinated-turn rate


def init_odom(map_cfg: vh.VoxelMapConfig, odom_cfg: OdomConfig | None = None,
              g_world=None, device=None) -> OdomState:
    dev = resolve_device(device)
    return OdomState(
        nav=init_state(g_world, odom_cfg, dev),
        vmap=vh.make_map(map_cfg, dev),
        scan_idx=0,
        initialized=False,
        w_cv=torch.zeros((3,), dtype=torch.float32, device=dev),
    )


def gravity_from_imu(imu: ImuBatch):
    """Initial gravity estimate from averaged static accelerometer samples
    (FAST-LIO init capability). Returns world gravity assuming R0 = I."""
    w = imu.mask.to(torch.float32)
    mean_acc = torch.sum(imu.acc * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    return -mean_acc / torch.clamp(torch.linalg.vector_norm(mean_acc), min=1e-6) * GRAVITY


def _preprocess(scan: Scan, cfg: OdomConfig) -> Scan:
    """Blind/range filter + point stride (FAST-LIO preprocess contract)."""
    d2 = torch.sum(scan.xyz * scan.xyz, dim=-1)
    mask = scan.mask & (d2 > cfg.blind**2) & (d2 < cfg.det_range**2)
    if cfg.point_filter_num > 1:
        idx = torch.arange(scan.xyz.shape[0], device=scan.xyz.device)
        mask = mask & ((idx % cfg.point_filter_num) == 0)
    return scan._replace(mask=mask)


def _select(cond, a: NavState, b: NavState) -> NavState:
    """Field-wise ``torch.where(cond, a, b)`` over two nav states."""
    return NavState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _cv_predict(nav: NavState, w_cv, scan_dt, cfg: OdomConfig) -> NavState:
    """IMU-less coordinated-turn prediction: constant body velocity and
    angular rate, with inflated process noise."""
    R_new = nav.R @ so3.exp(w_cv * scan_dt)
    v_new = R_new @ (nav.R.T @ nav.v)
    p_new = nav.p + 0.5 * (nav.v + v_new) * scan_dt
    dev = nav.P.device
    q = torch.cat([
        torch.full((3,), cfg.cv_rot_cov * scan_dt, device=dev),
        torch.full((3,), cfg.cv_pos_cov * scan_dt, device=dev),
        torch.full((3,), cfg.cv_vel_cov * scan_dt, device=dev),
        torch.full((15,), 1e-8, device=dev),
    ])
    P = nav.P + torch.diag(q)
    return nav._replace(R=R_new, p=p_new, v=v_new, P=P)


@geometry_precision()
def odom_step(
    state: OdomState,
    scan: Scan,
    imu: ImuBatch,
    scan_dt: float,
    cfg: OdomConfig,
    map_cfg: vh.VoxelMapConfig,
    map_ops=None,
    device=None,
    gate_on_device: bool = False,
):
    """Advance odometry by one scan. Returns ``(new_state, aux)`` with the
    world pose (R, p, v), the world-frame downsampled cloud and its mask,
    and the diagnostics ``n_matched`` / ``n_dropped`` (device scalars).
    ``gate_on_device`` makes the iEKF re-query gate a device-side select
    (no host read; see ``odom/iekf.py``)."""
    if map_ops is not None:
        raise NotImplementedError("map_ops (sharded map backends) is not ported yet")
    dev = resolve_device(device)
    state, scan, imu = to_device((state, scan, imu), dev)
    scan_dt = float(scan_dt)
    scan = _preprocess(scan, cfg)

    has_imu = torch.any(imu.mask)
    nav_imu, traj = propagate(state.nav, imu, cfg, scan_dt)
    nav_prop = _select(has_imu, nav_imu, _cv_predict(state.nav, state.w_cv, scan_dt, cfg))
    pts_body = deskew(
        scan.xyz, scan.t_offset, scan.mask, traj, nav_prop, cfg, imu.mask, scan_dt
    )
    # without IMU: constant-velocity translation-only deskew
    nav0 = state.nav
    pts_cv = torch.where(
        scan.mask[:, None],
        scan.xyz @ nav0.R_ext.T
        + nav0.t_ext
        - (nav0.R.T @ nav0.v)[None, :] * (scan_dt - scan.t_offset)[:, None],
        1.0e6,
    )
    pts_body = torch.where(has_imu, pts_body, pts_cv)

    # spatial downsample to the iEKF budget (output comes packed)
    ds = voxel_downsample(Cloud(xyz=pts_body, mask=scan.mask), cfg.filter_size_surf)
    budget = min(cfg.num_ds_points, ds.xyz.shape[0])
    pts = ds.xyz[:budget]
    msk = ds.mask[:budget]

    nav_upd, n_matched = iekf_update(nav_prop, pts, msk, state.vmap, map_cfg, cfg,
                                     gate_on_device)
    # IMU-less: velocity from the pose correction, EMA-smoothed
    v_fd = (nav_upd.p - nav0.p) / max(scan_dt, 1e-3)
    v_sm = cfg.cv_vel_alpha * v_fd + (1.0 - cfg.cv_vel_alpha) * nav0.v
    nav_upd = nav_upd._replace(v=torch.where(has_imu, nav_upd.v, v_sm))
    nav_new = nav_upd if state.initialized else nav_prop

    w_fd = so3.log(nav0.R.T @ nav_new.R) / max(scan_dt, 1e-3)
    w_mag = torch.linalg.vector_norm(w_fd)
    w_fd = w_fd * torch.clamp(cfg.cv_max_rate / torch.clamp(w_mag, min=1e-9), max=1.0)
    w_cv_new = torch.where(has_imu, state.w_cv, w_fd)

    # map insert of the updated world-frame cloud (the cached-plane refit
    # only where the query mode reads cached planes)
    pw = pts @ nav_new.R.T + nav_new.p
    vmap_new, n_dropped = vh.insert(state.vmap, map_cfg, pw, msk,
                                    refresh_planes=(cfg.query_mode == "cached"))
    if state.scan_idx % cfg.evict_every == cfg.evict_every - 1:
        vmap_new = vh.evict_far(vmap_new, map_cfg, nav_new.p, cfg.det_range)

    new_state = OdomState(
        nav=nav_new,
        vmap=vmap_new,
        scan_idx=state.scan_idx + 1,
        initialized=True,
        w_cv=w_cv_new,
    )
    aux = {
        "R": nav_new.R,
        "p": nav_new.p,
        "v": nav_new.v,
        "cloud_world": pw,
        "cloud_mask": msk,
        "n_matched": n_matched,
        "n_dropped": n_dropped,
    }
    return new_state, aux


def odom_rollout(state: OdomState, scans: Scan, imus: ImuBatch, scan_dt,
                 cfg: OdomConfig, map_cfg: vh.VoxelMapConfig, device=None):
    """Run ``S`` stacked scans through :func:`odom_step` (a Python loop; the
    JAX package's ``lax.scan``). Returns the final state plus per-scan
    poses and match counts."""
    Rs, ps, matched = [], [], []
    for k in range(scans.xyz.shape[0]):
        scan = Scan(*(t[k] for t in scans))
        imu = ImuBatch(*(t[k] for t in imus))
        state, aux = odom_step(state, scan, imu, scan_dt, cfg, map_cfg, device=device)
        Rs.append(aux["R"])
        ps.append(aux["p"])
        matched.append(aux["n_matched"])
    return state, {"R": torch.stack(Rs), "p": torch.stack(ps),
                   "n_matched": torch.stack(matched)}
