"""The SLAM engine, per-scan path (port of ``fastliosam_tpu/runtime/engine.py``).

One ``process()`` call per scan advances odometry, decides keyframes,
commits the keyframe cloud and the odometry between-factor, runs loop
detection + ICP verification every ``loop_check_every`` scans, and
re-solves the pose graph when a loop is accepted. Realtime poses use the
reference's delta-chaining, ``corrected(t) = last_corrected_kf ·
(raw_kf⁻¹ · raw(t))``, in host numpy exactly as the JAX engine does.

Loop verification is computed when it is launched (JAX dispatches it
asynchronously), but its result is still resolved at the NEXT loop
attempt, so loop factors land with the same one-attempt lag and the
trajectory matches the JAX engine's.

Not ported yet (they raise): GPS (``use_gps=True``), mesh mode,
``map_ops``, and the chunked/deferred entry points.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import se3
from ..core.pointcloud import Cloud, voxel_downsample
from ..loop import LoopConfig, fetch_closest_keyframe_idx, verify_loop
from ..map import VoxelMapConfig
from ..odom import ImuBatch, OdomConfig, Scan, init_odom, odom_step
from ..pgo import (
    PoseGraph,
    PoseGraphConfig,
    add_between,
    add_keyframe,
    grow,
    make_graph,
    solve,
)
from ..utils.device import resolve_device, upload
from ..utils.precision import geometry_precision
from ..utils.sync import host_read


class EngineConfig(NamedTuple):
    """PGO-node parameter surface; same fields and defaults as the JAX
    package's (its docstrings explain each)."""

    keyframe_threshold: float = 1.0
    loop_check_every: int = 5
    kf_cloud_points: int = 4096
    kf_cloud_voxel: float = 0.3
    use_gps: bool = False
    gps_cov_thres: float = 2.0
    gps_dist_thres: float = 5.0
    min_traj_len: float = 5.0
    use_gps_elevation: bool = False
    gps_time_tol: float = 0.05
    gps_noise_floor: float = 1.0
    gps_anchor_warmup: int = 10
    pose_cov_thres: float = 0.02
    gps_motion_comp: bool = True
    capture_distance: float = 0.0
    capacity_policy: str = "grow"
    odom_trans_sqrt_info: float = 10.0
    odom_rot_sqrt_info: float = 100.0
    loop_device: int | None = None
    defer_depth: int = 1
    solve_per_keyframe: bool = False

    @classmethod
    def reference_exact(cls, **overrides):
        """Every documented engine-level divergence restored to the
        reference spec."""
        base = dict(
            keyframe_threshold=0.0, gps_anchor_warmup=1,
            gps_noise_floor=1.0, gps_dist_thres=5.0,
            solve_per_keyframe=True, gps_motion_comp=False,
        )
        base.update(overrides)
        return cls(**base)


@dataclass
class KeyframeStore:
    """Fixed-capacity keyframe SoA: clouds in the body frame, raw poses,
    stamps. The engine owns it and writes keyframes into it in place."""

    clouds: torch.Tensor  # (K, P, 3)
    masks: torch.Tensor  # (K, P)
    raw_poses: torch.Tensor  # (K, 4, 4) odometry frame
    stamps: torch.Tensor  # (K,)
    n: int = 0

    @staticmethod
    def create(max_kf: int, points: int, device) -> "KeyframeStore":
        return KeyframeStore(
            clouds=torch.zeros((max_kf, points, 3), dtype=torch.float32, device=device),
            masks=torch.zeros((max_kf, points), dtype=torch.bool, device=device),
            raw_poses=torch.eye(4, dtype=torch.float32, device=device).repeat(max_kf, 1, 1),
            stamps=torch.zeros((max_kf,), dtype=torch.float32, device=device),
        )


def _downsample_to_budget(xyz, mask, voxel, budget):
    ds = voxel_downsample(Cloud(xyz=xyz, mask=mask), voxel)  # packed output
    return ds.xyz[:budget], ds.mask[:budget]


class SlamEngine:
    """Odometry + keyframing + loop closure + PGO, one scan per call."""

    def __init__(
        self,
        odom_cfg: OdomConfig = OdomConfig(),
        map_cfg: VoxelMapConfig = VoxelMapConfig(),
        loop_cfg: LoopConfig = LoopConfig(),
        pgo_cfg: PoseGraphConfig = PoseGraphConfig(),
        cfg: EngineConfig = EngineConfig(),
        map_ops=None,
        mesh=None,
        device=None,
    ):
        if cfg.use_gps:
            raise NotImplementedError("use_gps=True is not ported yet")
        if mesh is not None or map_ops is not None:
            raise NotImplementedError("mesh mode and map_ops are not ported yet")
        self.device = resolve_device(device)
        self.odom_cfg = odom_cfg
        self.map_cfg = map_cfg
        self.loop_cfg = loop_cfg
        self.pgo_cfg = pgo_cfg
        self.cfg = cfg
        # keyframe clouds come from the downsampled odometry cloud
        self.kf_points = min(cfg.kf_cloud_points, odom_cfg.num_ds_points)
        self.reset()

    def reset(self):
        """Reset all mutable pipeline state to a fresh run."""
        dev = self.device
        self.odom = init_odom(self.map_cfg, self.odom_cfg, device=dev)
        self.graph: PoseGraph = make_graph(self.pgo_cfg, dev)
        self.kf = KeyframeStore.create(self.pgo_cfg.max_keyframes, self.kf_points, dev)
        self.last_kf_raw = np.eye(4, dtype=np.float32)
        self.last_kf_corrected = np.eye(4, dtype=np.float32)
        self.scan_count = 0
        self.loop_pairs: list[tuple[int, int]] = []
        self.loop_rels: list[np.ndarray] = []
        self.loop_fitness: list[float] = []
        # every verification attempt: (query, cand, fitness, accepted)
        self.loop_attempts: list[tuple] = []
        self.raw_traj: list[np.ndarray] = []
        self.realtime_traj: list[np.ndarray] = []
        self.scan_stamps: list[float] = []
        # per-scan iEKF match counts, kept on the device (read them once,
        # at the end, with host_read(torch.stack(...)))
        self.match_counts: list[torch.Tensor] = []
        self.traj_len = 0.0
        self._last_p = None
        self.solve_count = 0
        self._needs_solve = False
        self._loop_processed_kf = 0
        self._pending_loops: list = []
        self._n_bt_host = 0
        self.capture_hook = None
        self._dist_since_capture = 0.0

    # ------------------------------------------------------------------
    def process(self, scan: Scan, imu: ImuBatch, stamp: float, scan_dt: float,
                gps: Optional[list] = None):
        """Advance the pipeline by one scan. Returns the realtime corrected
        pose (4, 4) numpy."""
        if gps:
            raise NotImplementedError("GPS fixes are not ported yet")
        self.odom, aux = odom_step(
            self.odom, scan, imu, scan_dt, self.odom_cfg, self.map_cfg,
            device=self.device,
        )
        self.match_counts.append(aux["n_matched"])
        # one small readback per scan; pose composition below is host numpy
        R_np, p_np = host_read(aux["R"], aux["p"])
        raw_T = np.eye(4, dtype=np.float32)
        raw_T[:3, :3] = R_np
        raw_T[:3, 3] = p_np

        # realtime correction by delta-chaining
        last_raw = np.asarray(self.last_kf_raw)
        last_corr = np.asarray(self.last_kf_corrected)
        delta = np.linalg.inv(last_raw) @ raw_T
        corrected_T = (last_corr @ delta).astype(np.float32)

        if self._last_p is not None:
            step_d = float(np.linalg.norm(p_np - self._last_p))
            self.traj_len += step_d
            self._dist_since_capture += step_d
        self._last_p = p_np
        if (
            self.capture_hook is not None
            and self.cfg.capture_distance > 0.0
            and self._dist_since_capture >= self.cfg.capture_distance
        ):
            self._dist_since_capture = 0.0
            self.capture_hook(float(stamp), corrected_T)
        self.raw_traj.append(raw_T)
        self.realtime_traj.append(corrected_T)
        self.scan_stamps.append(float(stamp))

        # keyframe decision
        if self.kf.n == 0:
            self._add_keyframe(raw_T, corrected_T, aux, stamp)
        else:
            dist = float(np.linalg.norm(raw_T[:3, 3] - last_raw[:3, 3]))
            if dist > self.cfg.keyframe_threshold:
                self._add_keyframe(raw_T, corrected_T, aux, stamp)

        # loop-closure cadence
        if self.scan_count % self.cfg.loop_check_every == 0 and self.kf.n > 1:
            self._attempt_loop()

        if self._needs_solve:
            self._solve()

        self.scan_count += 1
        return np.asarray(corrected_T)

    # ------------------------------------------------------------------
    # capacity policy: grow (double) or fail loudly — never drop silently
    # ------------------------------------------------------------------
    def _capacity_event(self, what: str, old: int, new: int):
        import warnings

        if self.cfg.capacity_policy == "error":
            raise RuntimeError(
                f"pose-graph {what} capacity exhausted at {old} "
                f"(capacity_policy='error'; use 'grow' or raise the limit)"
            )
        warnings.warn(f"pose-graph {what} capacity {old} reached — growing to {new}",
                      stacklevel=3)

    def _grow_keyframes(self):
        old = self.pgo_cfg.max_keyframes
        new = old * 2
        self._capacity_event("keyframe", old, new)
        self.pgo_cfg = self.pgo_cfg._replace(max_keyframes=new)
        self.graph = grow(self.graph, self.pgo_cfg)
        fresh = KeyframeStore.create(old, self.kf_points, self.device)
        self.kf = KeyframeStore(
            clouds=torch.cat([self.kf.clouds, fresh.clouds]),
            masks=torch.cat([self.kf.masks, fresh.masks]),
            raw_poses=torch.cat([self.kf.raw_poses, fresh.raw_poses]),
            stamps=torch.cat([self.kf.stamps, fresh.stamps]),
            n=self.kf.n,
        )

    def _grow_between(self):
        old = self.pgo_cfg.max_between
        new = old * 2
        self._capacity_event("between-factor", old, new)
        self.pgo_cfg = self.pgo_cfg._replace(max_between=new)
        self.graph = grow(self.graph, self.pgo_cfg)

    # ------------------------------------------------------------------
    @geometry_precision()
    def _commit_keyframe(self, k, cloud_world, cloud_mask, raw_T, corrected_T,
                         prev_raw_T, stamp):
        """Store the body-frame downsampled cloud + pose/stamp in the
        keyframe store and append the graph entries."""
        cfg = self.cfg
        dev = self.device
        raw = upload(raw_T, dev)
        body = se3.apply_inverse(raw, cloud_world[None])[0]
        cl, mk = _downsample_to_budget(body, cloud_mask, cfg.kf_cloud_voxel, self.kf_points)
        self.kf.clouds[k] = cl
        self.kf.masks[k] = mk
        self.kf.raw_poses[k] = raw
        self.kf.stamps[k] = float(np.float32(stamp))
        self.graph = add_keyframe(self.graph, upload(corrected_T, dev))
        if k > 0:
            prev = upload(prev_raw_T, dev)
            sqrt_info = torch.cat([
                torch.full((3,), cfg.odom_trans_sqrt_info, device=dev),
                torch.full((3,), cfg.odom_rot_sqrt_info, device=dev),
            ])
            self.graph = add_between(self.graph, k - 1, k, se3.between(prev, raw), sqrt_info)

    def _add_keyframe(self, raw_T, corrected_T, aux, stamp):
        k = self.kf.n
        if k >= self.pgo_cfg.max_keyframes:
            self._grow_keyframes()
        if k > 0:
            if self._n_bt_host >= self.pgo_cfg.max_between:
                self._grow_between()
            self._n_bt_host += 1
        self._commit_keyframe(k, aux["cloud_world"], aux["cloud_mask"], raw_T,
                              corrected_T, self.last_kf_raw, stamp)
        self.kf.n = k + 1
        self.last_kf_raw = np.asarray(raw_T)
        self.last_kf_corrected = np.asarray(corrected_T)
        if self.cfg.solve_per_keyframe:
            self._needs_solve = True

    # ------------------------------------------------------------------
    def _attempt_loop(self):
        # resolve the previously launched verification first (one-attempt lag)
        self._resolve_pending_loop()
        k = self.kf.n
        # processed-flag dedup: each keyframe is loop-attempted at most once
        if k - 1 <= self._loop_processed_kf:
            return
        self._loop_processed_kf = k - 1
        idx, _ = fetch_closest_keyframe_idx(
            se3.trans(self.graph.poses), self.kf.stamps, self.graph.kf_valid, k - 1,
            self.loop_cfg.radius, self.loop_cfg.time_gap,
        )
        cand = int(host_read(idx))  # -1 = not found
        if cand < 0:
            return
        self._launch_verify(k - 1, cand)

    def _launch_verify(self, query: int, cand: int):
        out = verify_loop(
            self.kf.clouds, self.kf.masks, self.graph.poses, self.graph.kf_valid,
            query, cand, self.loop_cfg, device=self.device,
        )
        self._pending_loops.append((query, cand, out))

    def _resolve_pending_loop(self):
        while self._pending_loops:
            qi, ci, (rel, sqrt_info, accepted, fitness) = self._pending_loops.pop(0)
            fit_np, acc_np = host_read(fitness, accepted)
            fit, acc = float(fit_np), bool(acc_np)
            self.loop_attempts.append((qi, ci, fit, acc))
            if acc:
                if self._n_bt_host >= self.pgo_cfg.max_between:
                    self._grow_between()
                self._n_bt_host += 1
                self.graph = add_between(self.graph, qi, ci, rel, sqrt_info)
                self.loop_pairs.append((qi, ci))
                self.loop_rels.append(host_read(rel))
                self.loop_fitness.append(fit)
                self._needs_solve = True

    # ------------------------------------------------------------------
    def _solve(self):
        self.graph, _ = solve(self.graph, self.pgo_cfg, device=self.device)
        self.solve_count += 1
        self._needs_solve = False
        k = self.kf.n
        # re-anchor the realtime correction at the latest keyframe
        self.last_kf_corrected, self.last_kf_raw = host_read(
            self.graph.poses[k - 1], self.kf.raw_poses[k - 1]
        )

    # ------------------------------------------------------------------
    def finish(self):
        """Resolve any in-flight loop verification and run a final solve."""
        self._resolve_pending_loop()
        if self._needs_solve:
            self._solve()

    def keyframe_poses(self):
        """Corrected keyframe poses (n, 4, 4) numpy."""
        return host_read(self.graph.poses[: self.kf.n])

    def keyframe_stamps(self):
        return host_read(self.kf.stamps[: self.kf.n])
