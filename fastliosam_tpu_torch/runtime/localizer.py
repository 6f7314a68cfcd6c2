"""Map-based localization against a previously built keyframe map (port of
``fastliosam_tpu/runtime/localizer.py``).

Load a keyframe bundle (``persistence.save_results``), rasterize it into a
frozen voxel-surfel map and run the iterated-ESKF update against it with
map insertion disabled. Global initial alignment is ICP of the first scan
against the map's voxel centroids from a rough pose guess. As in the JAX
package, a step propagates with the IMU batch it is given (``propagate``)
and has no coordinated-turn prediction for IMU-less streams.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import se3
from ..core.pointcloud import Cloud, voxel_downsample
from ..loop.icp import icp_align
from ..map import VoxelMapConfig, insert, make_map, occupied_centroids
from ..odom import ImuBatch, OdomConfig, Scan
from ..odom.iekf import iekf_update
from ..odom.imu import deskew, propagate
from ..odom.state import NavState, init_state
from ..utils.device import resolve_device, to_device, upload
from ..utils.precision import geometry_precision
from ..utils.sync import host_read


def keyframe_world_points(bundle_path: str):
    """Every keyframe point of a .npz bundle in the world frame: ``(xyz
    (K*P, 3) float32, mask (K*P,))``, transformed on the host as the JAX
    package does."""
    blob = np.load(bundle_path)
    poses = blob["poses"]  # (K, 4, 4)
    clouds = blob["clouds"]  # (K, P, 3) body frame
    world = np.einsum("kij,kpj->kpi", poses[:, :3, :3], clouds) + poses[:, None, :3, 3]
    return world.reshape(-1, 3).astype(np.float32), blob["masks"].reshape(-1)


def build_map_from_keyframes(bundle_path: str, map_cfg: VoxelMapConfig, batch: int = 65536,
                             device=None):
    """Load a keyframe .npz bundle and accumulate all world-frame points
    into a voxel-surfel map, ``batch`` points per insert (planes refreshed,
    as the JAX package's ``insert`` does by default)."""
    dev = resolve_device(device)
    flat, fmask = keyframe_world_points(bundle_path)
    m = make_map(map_cfg, dev)
    for s in range(0, len(flat), batch):
        chunk = flat[s: s + batch]
        cmask = fmask[s: s + batch]
        if len(chunk) < batch:
            pad = batch - len(chunk)
            chunk = np.pad(chunk, ((0, pad), (0, 0)), constant_values=1e6)
            cmask = np.pad(cmask, (0, pad))
        m, _ = insert(m, map_cfg, upload(chunk, dev), upload(cmask, dev, torch.bool))
    return m


class MapLocalizer:
    """Relocalize a LiDAR(-inertial) stream against a frozen map."""

    def __init__(
        self,
        bundle_path: str,
        map_cfg: VoxelMapConfig = VoxelMapConfig(),
        odom_cfg: OdomConfig = OdomConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        self.map_cfg = map_cfg
        self.odom_cfg = odom_cfg
        self.vmap = build_map_from_keyframes(bundle_path, map_cfg, device=self.device)
        self.nav: NavState = init_state(cfg=odom_cfg, device=self.device)
        self.initialized = False

    @geometry_precision()
    def _step(self, nav, scan: Scan, imu: ImuBatch, dt: float):
        cfg = self.odom_cfg
        d2 = torch.sum(scan.xyz * scan.xyz, dim=-1)
        mask = scan.mask & (d2 > cfg.blind**2) & (d2 < cfg.det_range**2)
        nav_prop, traj = propagate(nav, imu, cfg, dt)
        pts_body = deskew(scan.xyz, scan.t_offset, mask, traj, nav_prop, cfg, imu.mask, dt)
        ds = voxel_downsample(Cloud(xyz=pts_body, mask=mask), cfg.filter_size_surf)
        budget = min(cfg.num_ds_points, ds.xyz.shape[0])
        return iekf_update(nav_prop, ds.xyz[:budget], ds.mask[:budget], self.vmap,
                           self.map_cfg, cfg)

    def global_init(self, scan: Scan, guess_T=None, max_iterations: int = 40):
        """Align the first scan to the map by ICP from a rough pose guess
        (the relocalization bootstrap). Returns the fitness."""
        dev = self.device
        scan = to_device(scan, dev)
        guess = (torch.eye(4, dtype=torch.float32, device=dev) if guess_T is None
                 else torch.as_tensor(guess_T, dtype=torch.float32).to(dev))
        map_pts, occ = occupied_centroids(self.vmap, self.map_cfg)
        ds = voxel_downsample(Cloud(xyz=scan.xyz, mask=scan.mask), self.odom_cfg.filter_size_surf)
        budget = min(8192, ds.xyz.shape[0])
        T, fitness, _ = icp_align(
            ds.xyz[:budget].contiguous(), ds.mask[:budget], map_pts, occ, init_T=guess,
            max_iterations=max_iterations, max_corr_dist=5.0, trim_fraction=0.8,
        )
        self.nav = self.nav._replace(R=se3.rot(T), p=se3.trans(T))
        self.initialized = True
        return float(host_read(fitness))

    def process(self, scan: Scan, imu: ImuBatch, scan_dt: float):
        """One localization step. Returns ``(pose (4, 4) numpy, n_matched)``."""
        if not self.initialized:
            raise RuntimeError("call global_init() with the first scan first")
        scan, imu = to_device((scan, imu), self.device)
        self.nav, n_matched = self._step(self.nav, scan, imu, float(np.float32(scan_dt)))
        R, p, n = host_read(self.nav.R, self.nav.p, n_matched)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = R, p
        return pose, int(n)
