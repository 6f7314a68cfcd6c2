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

:func:`odom_step_batched` and :func:`odom_rollout_batched` run B lanes at
once (the batched rollout, ``eval/batch_eval.py``; ``jax.vmap`` of
:func:`odom_step` in the JAX package). There ``scan_idx`` and
``initialized`` are ``(B,)`` device tensors, and every ``lax.cond`` with a
per-lane predicate (``has_imu``, ``initialized``, the iEKF re-query gate,
the eviction cadence) is a per-lane select: both sides computed, each lane
taking its own. Every operation and kernel launch of a step covers all
lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import so3
from ..core.pointcloud import Cloud, voxel_downsample, voxel_downsample_lanes
from ..map import voxel_hash as vh
from ..utils.device import resolve_device, to_device
from ..utils.precision import geometry_precision
from .iekf import iekf_update
from .imu import ImuBatch, deskew, propagate
from .state import GRAVITY, NavState, OdomConfig, init_state, matvec


class Scan(NamedTuple):
    """One LiDAR sweep in the sensor frame; ``t_offset`` is seconds since
    the previous scan end (the IMU batch's clock)."""

    xyz: torch.Tensor  # (N, 3)
    t_offset: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)


class OdomState(NamedTuple):
    """The odometry's state; batched (``init_odom(..., lanes=B)``), every
    tensor has a leading lane dim and ``scan_idx`` / ``initialized`` are
    ``(B,)`` int32 / bool tensors."""

    nav: NavState
    vmap: vh.VoxelMap
    scan_idx: int  # host counter
    initialized: bool  # host flag (map bootstrapped)
    w_cv: torch.Tensor  # (3,) rad/s, IMU-less coordinated-turn rate


def init_odom(map_cfg: vh.VoxelMapConfig, odom_cfg: OdomConfig | None = None,
              g_world=None, device=None, lanes: int | None = None,
              vmap: vh.VoxelMap | None = None) -> OdomState:
    """The initial state; with ``lanes``, the batched state of ``lanes``
    fresh lanes (a lane-major map, per-lane counters on the device). A
    given ``vmap`` (a map shard of ``parallel/sharded_map.py``) takes the
    place of a fresh whole map, which is then never allocated."""
    dev = resolve_device(device)
    if lanes is not None:
        return OdomState(
            nav=init_state(g_world, odom_cfg, dev, lanes=lanes),
            vmap=vh.make_map(map_cfg, dev, lanes=lanes),
            scan_idx=torch.zeros((lanes,), dtype=torch.int32, device=dev),
            initialized=torch.zeros((lanes,), dtype=torch.bool, device=dev),
            w_cv=torch.zeros((lanes, 3), dtype=torch.float32, device=dev),
        )
    return OdomState(
        nav=init_state(g_world, odom_cfg, dev),
        vmap=vh.make_map(map_cfg, dev) if vmap is None else vmap,
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
    """Blind/range filter + point stride (FAST-LIO preprocess contract),
    per lane over a batch of scans."""
    d2 = torch.sum(scan.xyz * scan.xyz, dim=-1)
    mask = scan.mask & (d2 > cfg.blind**2) & (d2 < cfg.det_range**2)
    if cfg.point_filter_num > 1:
        idx = torch.arange(scan.xyz.shape[-2], device=scan.xyz.device)
        mask = mask & ((idx % cfg.point_filter_num) == 0)
    return scan._replace(mask=mask)


def _select(cond, a: NavState, b: NavState) -> NavState:
    """Field-wise ``torch.where(cond, a, b)`` over two nav states; over two
    batched states with a ``(B,)`` ``cond``, lane ``i`` takes ``a`` where
    ``cond[i]`` holds."""
    return NavState(*(torch.where(cond.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
                      for x, y in zip(a, b)))


def _cv_predict(nav: NavState, w_cv, scan_dt, cfg: OdomConfig) -> NavState:
    """IMU-less coordinated-turn prediction: constant body velocity and
    angular rate, with inflated process noise (per lane, batched)."""
    R_new = nav.R @ so3.exp(w_cv * scan_dt)
    v_new = matvec(R_new, matvec(nav.R.mT, nav.v))
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
    (no host read; see ``odom/iekf.py``). ``map_ops`` (query, insert,
    evict) overrides the map backend: the slot-sharded map of the mesh
    (``parallel/sharded_odom.py: sharded_map_ops``) plugs in here."""
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
                                     gate_on_device,
                                     query_fn=None if map_ops is None else map_ops.query)
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
    if map_ops is None:
        vmap_new, n_dropped = vh.insert(state.vmap, map_cfg, pw, msk,
                                        refresh_planes=(cfg.query_mode == "cached"))
    else:
        vmap_new, n_dropped = map_ops.insert(state.vmap, map_cfg, pw, msk)
    if state.scan_idx % cfg.evict_every == cfg.evict_every - 1:
        evict = vh.evict_far if map_ops is None else map_ops.evict
        vmap_new = evict(vmap_new, map_cfg, nav_new.p, cfg.det_range)

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


@geometry_precision()
def odom_step_batched(
    state: OdomState,
    scan: Scan,
    imu: ImuBatch,
    scan_dt: float,
    cfg: OdomConfig,
    map_cfg: vh.VoxelMapConfig,
    device=None,
    map_ops=None,
):
    """:func:`odom_step` of B lanes in one pass: a batched ``state``, ``(B,
    N, ...)`` scans and ``(B, M, ...)`` IMU batches. Each lane's
    ``has_imu``, ``initialized``, re-query gate and eviction cadence select
    its own result. Returns ``(new_state, aux)`` with ``(B, ...)`` members.
    There is no sharded map backend for lanes (nor in the JAX package):
    ``map_ops`` raises."""
    if map_ops is not None:
        raise ValueError("the batched step has no map_ops backend (the JAX package has none)")
    dev = resolve_device(device)
    state, scan, imu = to_device((state, scan, imu), dev)
    scan_dt = float(scan_dt)
    scan = _preprocess(scan, cfg)
    lanes = scan.xyz.shape[0]

    has_imu = torch.any(imu.mask, dim=-1)
    nav_imu, traj = propagate(state.nav, imu, cfg, scan_dt)
    nav_prop = _select(has_imu, nav_imu, _cv_predict(state.nav, state.w_cv, scan_dt, cfg))
    pts_body = deskew(
        scan.xyz, scan.t_offset, scan.mask, traj, nav_prop, cfg, imu.mask, scan_dt
    )
    # without IMU: constant-velocity translation-only deskew
    nav0 = state.nav
    v_body = matvec(nav0.R.mT, nav0.v)
    pts_cv = torch.where(
        scan.mask[..., None],
        scan.xyz @ nav0.R_ext.mT
        + nav0.t_ext[:, None]
        - v_body[:, None] * (scan_dt - scan.t_offset)[..., None],
        1.0e6,
    )
    pts_body = torch.where(has_imu[:, None, None], pts_body, pts_cv)

    # each lane downsampled to the iEKF budget (output comes packed)
    ds = voxel_downsample_lanes(Cloud(xyz=pts_body, mask=scan.mask), cfg.filter_size_surf)
    budget = min(cfg.num_ds_points, ds.xyz.shape[1])
    pts = ds.xyz[:, :budget].contiguous()
    msk = ds.mask[:, :budget].contiguous()

    nav_upd, n_matched = iekf_update(nav_prop, pts, msk, state.vmap, map_cfg, cfg,
                                     gate_on_device=True)
    # IMU-less: velocity from the pose correction, EMA-smoothed
    v_fd = (nav_upd.p - nav0.p) / max(scan_dt, 1e-3)
    v_sm = cfg.cv_vel_alpha * v_fd + (1.0 - cfg.cv_vel_alpha) * nav0.v
    nav_upd = nav_upd._replace(v=torch.where(has_imu[:, None], nav_upd.v, v_sm))
    nav_new = _select(state.initialized, nav_upd, nav_prop)

    w_fd = so3.log(nav0.R.mT @ nav_new.R) / max(scan_dt, 1e-3)
    w_mag = torch.linalg.vector_norm(w_fd, dim=-1)
    w_fd = w_fd * torch.clamp(cfg.cv_max_rate / torch.clamp(w_mag, min=1e-9), max=1.0)[:, None]
    w_cv_new = torch.where(has_imu[:, None], state.w_cv, w_fd)

    pw = pts @ nav_new.R.mT + nav_new.p[:, None]
    vmap_new, n_dropped = vh.insert(state.vmap, map_cfg, pw, msk,
                                    refresh_planes=(cfg.query_mode == "cached"))
    do_evict = state.scan_idx % cfg.evict_every == cfg.evict_every - 1
    vmap_new = vh.evict_far(vmap_new, map_cfg, nav_new.p, cfg.det_range, do_evict)

    new_state = OdomState(
        nav=nav_new,
        vmap=vmap_new,
        scan_idx=state.scan_idx + 1,
        initialized=torch.ones((lanes,), dtype=torch.bool, device=dev),
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


def odom_rollout_batched(state: OdomState, scans: Scan, imus: ImuBatch, scan_dt,
                         cfg: OdomConfig, map_cfg: vh.VoxelMapConfig, device=None):
    """Run ``S`` scans of each of B lanes (``(B, S, ...)`` stacks) through
    :func:`odom_step_batched`, one batched step per scan index. Returns the
    final batched state plus per-scan poses and match counts with leading
    dims ``(B, S)``."""
    Rs, ps, matched = [], [], []
    for k in range(scans.xyz.shape[1]):
        scan = Scan(*(t[:, k] for t in scans))
        imu = ImuBatch(*(t[:, k] for t in imus))
        state, aux = odom_step_batched(state, scan, imu, scan_dt, cfg, map_cfg, device=device)
        Rs.append(aux["R"])
        ps.append(aux["p"])
        matched.append(aux["n_matched"])
    return state, {"R": torch.stack(Rs, 1), "p": torch.stack(ps, 1),
                   "n_matched": torch.stack(matched, 1)}
