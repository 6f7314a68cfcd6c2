"""The SLAM engine (port of ``fastliosam_tpu/runtime/engine.py``).

Two ways to drive it, as in the JAX package:

* ``process()``: one call per scan advances odometry, decides keyframes on
  the host, commits the keyframe cloud and the odometry between-factor,
  runs loop detection + ICP verification every ``loop_check_every`` scans
  and re-solves the pose graph on loop or GPS events. Realtime poses use
  the reference's delta-chaining, ``corrected(t) = last_corrected_kf ·
  (raw_kf⁻¹ · raw(t))``, in host numpy exactly as the JAX engine does.
* ``process_chunk()`` / ``process_chunk_deferred()``: S scans per call
  with nothing read back inside the chunk (the JAX ``lax.scan``). The
  keyframe decision is a device bool, and the keyframe's cloud, pose,
  stamp, graph node and between-factor are masked writes; loop-candidate
  detection runs every scan against the keyframes committed so far; the
  iEKF re-query gate is a device-side select. The chunk's poses,
  keyframe flags, match counts and candidates come back in ONE packed
  host read when the chunk is resolved, and loop verification, GPS
  factors and solves run then. The deferred form dispatches chunk k
  before it resolves chunk k-1 (``EngineConfig.defer_depth`` chunks in
  flight).

GPS fixes (``GpsFix``) go through the ENU anchor (``core/geodesy.py``),
the anchor warmup, the reference's gating and the pose-covariance gate,
which reads the marginal covariance once per solve.

Loop verification is computed when it is launched (JAX dispatches it
asynchronously), but its result is still resolved at the NEXT loop
attempt, so loop factors land with the same one-attempt lag and the
trajectory matches the JAX engine's. ``EngineConfig.loop_device`` runs it
on ``cuda:{loop_device}`` when that card exists and no mesh is set.

Mesh mode (``mesh=``, a ``parallel.Mesh``): every rank of the mesh runs
the same engine calls on the same inputs (SPMD). The voxel map lives
slot-sharded, each rank allocating only its ``C/n`` slots
(``parallel/sharded_odom.py: sharded_map_ops``); the pose-graph solve
shards its factor rows (``parallel/sharded_pgo.py: solve_sharded``); loop
verification shards the source points of its ICP
(``parallel/sharded_loop.py: icp_align_sharded``; untrimmed, so mesh mode
sets ``trim_fraction`` to 1.0). Keyframes, poses and the graph stay
replicated. Every collective hands every rank the same bits, so the host
decisions agree on every rank. ``map_ops`` alone plugs in a map backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import se3
from ..core.geodesy import LocalCartesian
from ..core.pointcloud import Cloud, voxel_downsample
from ..loop import LoopConfig, fetch_closest_keyframe_idx, verify_loop
from ..map import VoxelMapConfig
from ..odom import ImuBatch, OdomConfig, Scan, init_odom, odom_step
from ..pgo import (
    PoseGraph,
    PoseGraphConfig,
    add_between,
    add_gps,
    add_keyframe,
    extrapolate_pose_cov,
    grow,
    make_graph,
    marginal_covariance,
    rotate_cov_to_world,
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


class GpsFix(NamedTuple):
    stamp: float
    lat: float
    lon: float
    alt: float
    cov_xyz: tuple  # (var_x, var_y, var_z)
    status: int = 0


@dataclass
class KeyframeStore:
    """Fixed-capacity keyframe SoA: clouds in the body frame, raw poses,
    stamps. The engine owns it and writes keyframes into it in place (the
    chunked path too: one row per scan, rewritten unchanged unless the
    scan is a keyframe)."""

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


class ChunkHandle(NamedTuple):
    """A dispatched chunk whose packed readback is not resolved yet."""

    packed: torch.Tensor  # (36 S,) float32 on the device
    stamps: np.ndarray  # (S,) float32
    n_scans: int


class SlamEngine:
    """Odometry + keyframing + loop closure + PGO + GPS, per scan or in
    chunks of scans."""

    def __init__(
        self,
        odom_cfg: OdomConfig = OdomConfig(),
        map_cfg: VoxelMapConfig = VoxelMapConfig(),
        loop_cfg: LoopConfig = LoopConfig(),
        pgo_cfg: PoseGraphConfig = PoseGraphConfig(),
        cfg: EngineConfig = EngineConfig(),
        map_ops=None,
        mesh=None,
        shard_axis: str = "kf",
        device=None,
    ):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.odom_cfg = odom_cfg
        self.map_cfg = map_cfg
        self.loop_cfg = loop_cfg
        self.pgo_cfg = pgo_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.shard_axis = shard_axis
        if map_ops is None and mesh is not None:
            from ..parallel.sharded_odom import sharded_map_ops

            map_ops = sharded_map_ops(mesh, shard_axis)
        self.map_ops = map_ops
        if mesh is not None and loop_cfg.trim_fraction != 1.0:
            # the point-sharded ICP is untrimmed (a global trim needs a
            # distributed order statistic): PCL-exact semantics
            self.loop_cfg = loop_cfg._replace(trim_fraction=1.0)
        # keyframe clouds come from the downsampled odometry cloud
        self.kf_points = min(cfg.kf_cloud_points, odom_cfg.num_ds_points)
        self.reset()

    def reset(self):
        """Reset all mutable pipeline state to a fresh run."""
        dev = self.device
        vmap = None
        if self.mesh is not None:
            # each rank allocates its slot range only, never the whole map
            from ..parallel.sharded_map import make_map_sharded

            vmap = make_map_sharded(self.map_cfg, self.mesh, self.shard_axis)
        self.odom = init_odom(self.map_cfg, self.odom_cfg, device=dev, vmap=vmap)
        self.graph: PoseGraph = make_graph(self.pgo_cfg, dev)
        self.kf = KeyframeStore.create(self.pgo_cfg.max_keyframes, self.kf_points, dev)
        # the last keyframe's raw and corrected poses: host numpy, or device
        # tensors after a chunk or a solve (read when a per-scan step needs them)
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
        # GPS state: ENU anchor, warmup buffer of (stamp, raw_enu, noise)
        # (None once finalized), SLAM-frame offset of the ENU frame, queue
        self.gps_anchor: Optional[LocalCartesian] = None
        self._gps_warmup: Optional[list] = []
        self.gps_slam_offset = np.zeros(3)
        self.gps_queue: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.last_gps_factor_pos: Optional[np.ndarray] = None
        self.solve_count = 0
        self._needs_solve = False
        # world-frame 6x6 marginal of the last keyframe at the last solve
        # (None = never solved: the GPS gate stays open) and what the
        # between-solve extrapolation needs
        self._cov6: Optional[np.ndarray] = None
        self._cov_solved_kf = -1
        self._cov_solved_p = np.zeros(2)
        self._cov_solved_trajlen = 0.0
        self._loop_processed_kf = 0
        self._pending_loops: list = []
        self._pending_chunks: list[ChunkHandle] = []
        # host-side factor counters (device adds are masked no-ops at
        # capacity, so the engine grows up front)
        self._n_bt_host = 0
        self._n_gps_host = 0
        self.capture_hook = None
        self._dist_since_capture = 0.0
        # the chunked path's device keyframe counter (None = the host count)
        self._kf_n_dev = None

    # ------------------------------------------------------------------
    def _last_kf_host(self):
        """The last keyframe's (raw, corrected) poses as host arrays: one
        read when they are on the device (after a chunk or a solve)."""
        if isinstance(self.last_kf_raw, torch.Tensor):
            self.last_kf_raw, self.last_kf_corrected = host_read(
                self.last_kf_raw, self.last_kf_corrected)
        return np.asarray(self.last_kf_raw), np.asarray(self.last_kf_corrected)

    def process(self, scan: Scan, imu: ImuBatch, stamp: float, scan_dt: float,
                gps: Optional[list] = None):
        """Advance the pipeline by one scan. Returns the realtime corrected
        pose (4, 4) numpy."""
        for fix in gps or []:
            self._on_gps(fix)
        self.odom, aux = odom_step(
            self.odom, scan, imu, scan_dt, self.odom_cfg, self.map_cfg,
            map_ops=self.map_ops, device=self.device,
        )
        self.match_counts.append(aux["n_matched"])
        # one small readback per scan; pose composition below is host numpy
        R_np, p_np = host_read(aux["R"], aux["p"])
        raw_T = np.eye(4, dtype=np.float32)
        raw_T[:3, :3] = R_np
        raw_T[:3, 3] = p_np

        # realtime correction by delta-chaining
        last_raw, last_corr = self._last_kf_host()
        delta = np.linalg.inv(last_raw) @ raw_T
        corrected_T = (last_corr @ delta).astype(np.float32)

        self._advance(p_np, stamp, raw_T, corrected_T)

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

    def _advance(self, p_np, stamp, raw_T, corrected_T):
        """Host bookkeeping of one scan: path length, capture hook,
        trajectories."""
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

    # ------------------------------------------------------------------
    # chunked entry points: S scans per call, one host read per chunk
    # ------------------------------------------------------------------
    def process_chunk(self, scans: Scan, imus: ImuBatch, stamps, scan_dt,
                      gps: Optional[list] = None):
        """Advance the pipeline by a chunk of S stacked scans with no host
        read inside the chunk; keyframe decisions and commits run on the
        device. Loop verification and solves run at the chunk boundary, so
        S = ``loop_check_every`` reproduces the reference's 2 Hz loop-timer
        cadence. Returns the (S, 4, 4) realtime corrected poses."""
        while self._pending_chunks:
            self._resolve_chunk(self._pending_chunks.pop(0))
        return self._resolve_chunk(self._dispatch_chunk(scans, imus, stamps, scan_dt, gps))

    def process_chunk_deferred(self, scans: Scan, imus: ImuBatch, stamps,
                               scan_dt, gps: Optional[list] = None):
        """Software pipeline: dispatch chunk k, THEN resolve the chunks
        beyond ``defer_depth`` in flight, so their host read overlaps chunk
        k's device work. Loop verification and solves land ``defer_depth``
        chunks later than in :meth:`process_chunk` (a structural lag, still
        deterministic). Returns the oldest resolved chunk's corrected poses
        (None while the pipeline fills); :meth:`finish` resolves the rest."""
        self._pending_chunks.append(self._dispatch_chunk(scans, imus, stamps, scan_dt, gps))
        out = None
        while len(self._pending_chunks) > max(1, self.cfg.defer_depth):
            out = self._resolve_chunk(self._pending_chunks.pop(0))
        return out

    @geometry_precision()
    def _dispatch_chunk(self, scans, imus, stamps, scan_dt, gps) -> ChunkHandle:
        for fix in gps or []:
            self._on_gps(fix)
        cfg = self.cfg
        dev = self.device
        S = scans.xyz.shape[0]
        if self.graph.poses.shape[0] != self.pgo_cfg.max_keyframes:
            raise RuntimeError("pgo_cfg.max_keyframes changed without engine.reset()")
        # pre-grow so no device add can hit its masked capacity no-op; the
        # chunks still in flight may add one keyframe per scan
        pend = sum(h.n_scans for h in self._pending_chunks)
        while self.kf.n + pend + S > self.pgo_cfg.max_keyframes:
            self._grow_keyframes()
        while self._n_bt_host + pend + S > self.pgo_cfg.max_between:
            self._grow_between()

        stamps_np = np.asarray(stamps, np.float32)
        stamps_dev = upload(stamps_np, dev)
        kf_n = self._kf_n_dev
        if kf_n is None:
            kf_n = torch.full((), self.kf.n, dtype=torch.int32, device=dev)
        last_raw = upload(self.last_kf_raw, dev) if isinstance(
            self.last_kf_raw, np.ndarray) else self.last_kf_raw
        last_corr = upload(self.last_kf_corrected, dev) if isinstance(
            self.last_kf_corrected, np.ndarray) else self.last_kf_corrected
        sqrt_info = torch.cat([
            torch.full((3,), cfg.odom_trans_sqrt_info, device=dev),
            torch.full((3,), cfg.odom_rot_sqrt_info, device=dev),
        ])
        K = self.pgo_cfg.max_keyframes
        outs = []
        for s in range(S):
            scan = Scan(*(t[s] for t in scans))
            imu = ImuBatch(*(t[s] for t in imus))
            self.odom, aux = odom_step(
                self.odom, scan, imu, scan_dt, self.odom_cfg, self.map_cfg,
                map_ops=self.map_ops, device=dev, gate_on_device=True,
            )
            self.match_counts.append(aux["n_matched"])
            raw_T = se3.make(aux["R"], aux["p"])
            corrected = se3.compose(last_corr, se3.between(last_raw, raw_T))
            dist = torch.linalg.vector_norm(se3.trans(raw_T) - se3.trans(last_raw))
            is_kf = (kf_n == 0) | (dist > cfg.keyframe_threshold)
            # masked commit: row kf_n is rewritten with itself unless is_kf
            row = torch.clamp(kf_n, max=K - 1).to(torch.int64).reshape(1)
            body = se3.apply_inverse(raw_T, aux["cloud_world"][None])[0]
            cl, mk = _downsample_to_budget(body, aux["cloud_mask"], cfg.kf_cloud_voxel,
                                           self.kf_points)
            for store, new in ((self.kf.clouds, cl), (self.kf.masks, mk),
                               (self.kf.raw_poses, raw_T), (self.kf.stamps, stamps_dev[s])):
                store.index_copy_(0, row, torch.where(is_kf, new, store[row][0])[None])
            self.graph = add_keyframe(self.graph, corrected, when=is_kf)
            self.graph = add_between(self.graph, kf_n - 1, kf_n, se3.between(last_raw, raw_T),
                                     sqrt_info, when=is_kf & (kf_n > 0))
            kf_n = kf_n + is_kf.to(torch.int32)
            last_raw = torch.where(is_kf, raw_T, last_raw)
            last_corr = torch.where(is_kf, corrected, last_corr)
            # per-scan loop-candidate detection against the keyframes
            # committed so far (pre-solve positions, as the reference's loop
            # thread reads whatever poses are current)
            cand, found = fetch_closest_keyframe_idx(
                se3.trans(self.graph.poses), self.kf.stamps, self.graph.kf_valid,
                torch.clamp(kf_n - 1, min=0), self.loop_cfg.radius, self.loop_cfg.time_gap,
            )
            outs.append((raw_T, corrected, is_kf, aux["n_matched"], cand, found))
        raw_Ts, corr_Ts, is_kfs, matched, cands, founds = (torch.stack(t) for t in zip(*outs))
        # every host-facing output in ONE buffer, read once at resolve
        packed = torch.cat([
            raw_Ts.reshape(-1), corr_Ts.reshape(-1),
            is_kfs.to(torch.float32), matched.to(torch.float32),
            cands.to(torch.float32), founds.to(torch.float32),
        ])
        self._kf_n_dev = kf_n
        self.last_kf_raw, self.last_kf_corrected = last_raw, last_corr
        return ChunkHandle(packed, stamps_np, S)

    def _resolve_chunk(self, handle: ChunkHandle):
        S = handle.n_scans
        flat = host_read(handle.packed)  # the chunk's one host read
        raw_np = flat[: 16 * S].reshape(S, 4, 4)
        corr_np = flat[16 * S: 32 * S].reshape(S, 4, 4)
        kf_np = flat[32 * S: 33 * S] > 0.5
        cands = flat[34 * S: 35 * S].astype(np.int32)
        founds = flat[35 * S: 36 * S] > 0.5
        new_kf = int(kf_np.sum())
        first_kf_idx = self.kf.n
        self.kf.n += new_kf
        self._n_bt_host += new_kf - (1 if first_kf_idx == 0 and new_kf else 0)

        kf_counter = first_kf_idx
        for s in range(S):
            stamp = float(handle.stamps[s])
            self._advance(raw_np[s, :3, 3], stamp, raw_np[s], corr_np[s])
            if kf_np[s]:
                if self.cfg.use_gps:
                    self._try_add_gps_factor(kf_counter, stamp, corr_np[s])
                kf_counter += 1
        self.scan_count += S

        if self.cfg.solve_per_keyframe and new_kf > 0:
            self._needs_solve = True
        # loop cadence: the per-scan candidates came back with the chunk, so
        # every cadence scan inside the chunk is attempted (processed-flag
        # dedup); only an ICP verification costs device work
        self._resolve_pending_loop()
        gidx0 = self.scan_count - S
        kf_cum = np.cumsum(kf_np)
        every = self.cfg.loop_check_every
        for s in range(S):
            if (gidx0 + s + 1) % every:
                continue
            k_s = first_kf_idx + int(kf_cum[s])
            if k_s > 1 and k_s - 1 > self._loop_processed_kf:
                self._loop_processed_kf = k_s - 1
                if founds[s]:
                    self._launch_verify(k_s - 1, int(cands[s]))
        if self._needs_solve:
            self._solve()
        return corr_np

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

    def _grow_gps(self):
        old = self.pgo_cfg.max_gps
        new = old * 2
        self._capacity_event("GPS-factor", old, new)
        self.pgo_cfg = self.pgo_cfg._replace(max_gps=new)
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
        self._kf_n_dev = None  # the host count is authoritative again
        self.last_kf_raw = np.asarray(raw_T)
        self.last_kf_corrected = np.asarray(corrected_T)
        if self.cfg.use_gps:
            self._try_add_gps_factor(k, stamp, corrected_T)
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

    def _verify_device(self) -> torch.device:
        """Where loop verification runs: ``cuda:{loop_device}`` when no mesh
        is set and that card exists, else the engine's device."""
        k = self.cfg.loop_device
        if self.mesh is None and k is not None and k < torch.cuda.device_count():
            return torch.device("cuda", k)
        return self.device

    def _icp_fn(self):
        """The mesh's point-sharded loop ICP (None without a mesh)."""
        if self.mesh is None:
            return None
        from ..parallel.mesh import shard_leading
        from ..parallel.sharded_loop import icp_align_sharded

        lc, mesh = self.loop_cfg, self.mesh
        return lambda s, sm, d, dm: icp_align_sharded(
            shard_leading(mesh, s), shard_leading(mesh, sm), d, dm, mesh, self.shard_axis,
            max_iterations=lc.max_iterations, max_corr_dist=lc.radius * lc.max_corr_factor,
            nn_chunk=lc.nn_chunk)

    def _launch_verify(self, query: int, cand: int):
        out = verify_loop(
            self.kf.clouds, self.kf.masks, self.graph.poses, self.graph.kf_valid,
            query, cand, self.loop_cfg, icp_fn=self._icp_fn(), device=self._verify_device(),
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
                # back from the verification's device (loop_device)
                self.graph = add_between(self.graph, qi, ci, rel.to(self.device),
                                         sqrt_info.to(self.device))
                self.loop_pairs.append((qi, ci))
                self.loop_rels.append(host_read(rel))
                self.loop_fitness.append(fit)
                self._needs_solve = True

    # ------------------------------------------------------------------
    def _solve(self):
        if self.mesh is not None:
            from ..parallel.sharded_pgo import solve_sharded

            self.graph, _ = solve_sharded(self.graph, self.pgo_cfg, self.mesh, self.shard_axis)
        else:
            self.graph, _ = solve(self.graph, self.pgo_cfg, device=self.device)
        self.solve_count += 1
        self._needs_solve = False
        k = self.kf.n
        # re-anchor the realtime correction at the latest keyframe; kept on
        # the device (a chunk takes them as they are, a per-scan step reads
        # them once: _last_kf_host)
        self.last_kf_corrected = self.graph.poses[k - 1]
        self.last_kf_raw = self.kf.raw_poses[k - 1]
        if self.cfg.use_gps:
            # the reference's pose_covariance_ read: the world-frame 6x6
            # marginal and the solved position in one read
            with geometry_precision():
                pose = self.graph.poses[k - 1]
                cov = rotate_cov_to_world(
                    marginal_covariance(self.graph, self.pgo_cfg, k - 1), se3.rot(pose))
                cov_np, p_np = host_read(cov, se3.trans(pose))
            self._cov6 = cov_np
            self._cov_solved_kf = k - 1
            self._cov_solved_p = p_np[:2].astype(np.float64)
            self._cov_solved_trajlen = self.traj_len

    def _pose_cov_estimate(self, kf_idx, p_now):
        """x/y translation marginal variance of keyframe ``kf_idx`` at
        ``p_now``: the marginal at the last solve extrapolated by
        first-order dead reckoning (``pgo.extrapolate_pose_cov``)."""
        if self._cov6 is None:
            return np.full((2,), np.inf)
        return extrapolate_pose_cov(
            self._cov6,
            max(kf_idx - self._cov_solved_kf, 0),
            max(self.traj_len - self._cov_solved_trajlen, 0.0),
            np.asarray(p_now, np.float64)[:2] - self._cov_solved_p,
            1.0 / self.cfg.odom_trans_sqrt_info**2,
            1.0 / self.cfg.odom_rot_sqrt_info**2,
        )

    # ------------------------------------------------------------------
    # GPS path (the reference's gpsCallback + add_gps_factor)
    # ------------------------------------------------------------------
    def _on_gps(self, fix: GpsFix):
        if fix.status != 0:  # reject non-fix solutions
            return
        if self.gps_anchor is None:
            self.gps_anchor = LocalCartesian.from_origin(fix.lat, fix.lon, fix.alt)
            if self.cfg.gps_anchor_warmup <= 1:
                # reference-exact: anchor at the first fix, offset = the
                # current SLAM position
                self._gps_warmup = None
                if self.realtime_traj:
                    self.gps_slam_offset = self.realtime_traj[-1][:3, 3].copy()
        # float32 geodesy on the host, as the JAX package computes it
        enu_raw = self.gps_anchor.forward(fix.lat, fix.lon, fix.alt).numpy()
        noise = np.sqrt(np.asarray(fix.cov_xyz))
        if self._gps_warmup is not None:
            self._gps_warmup.append((fix.stamp, enu_raw, noise))
            # stamp matching clearly failing: finalize with whatever matched
            # rather than buffer forever
            force = len(self._gps_warmup) >= max(
                3 * self.cfg.gps_anchor_warmup, self.cfg.gps_anchor_warmup + 5
            )
            self._try_finalize_gps_anchor(force=force)
            return
        self.gps_queue.append((fix.stamp, enu_raw + self.gps_slam_offset, noise))

    def _try_finalize_gps_anchor(self, force: bool = False):
        """Average the SLAM−ENU offset over the warmup fixes that have a
        realtime pose within ``gps_time_tol`` of their stamp, then flush
        them into the fusion queue. ``force`` finalizes with however many
        matched; with none it falls back to the reference's first-fix
        anchoring."""
        if self._gps_warmup is None or (not force and not self.scan_stamps):
            return
        tol = self.cfg.gps_time_tol
        stamps = np.asarray(self.scan_stamps) if self.scan_stamps else None
        matched = []
        if stamps is not None:
            for (ts, enu, noise) in self._gps_warmup:
                j = int(np.argmin(np.abs(stamps - ts)))
                if abs(float(stamps[j]) - ts) <= tol:
                    matched.append((ts, enu, noise, self.realtime_traj[j][:3, 3]))
        need = 1 if force else self.cfg.gps_anchor_warmup
        if len(matched) < need:
            if not force:
                return
            # nothing matched: the offset is the SLAM position nearest the
            # first fix (zero with no trajectory)
            if stamps is not None and self._gps_warmup:
                j = int(np.argmin(np.abs(stamps - self._gps_warmup[0][0])))
                self.gps_slam_offset = self.realtime_traj[j][:3, 3].copy()
        else:
            self.gps_slam_offset = np.mean([p - enu for (_, enu, _, p) in matched], axis=0)
        buffered, self._gps_warmup = self._gps_warmup, None
        for (ts, enu, noise) in buffered:
            self.gps_queue.append((ts, enu + self.gps_slam_offset, noise))

    def _velocity_at(self, t: float) -> np.ndarray:
        """World-frame velocity at ``t``, finite-differenced from the
        corrected realtime trajectory (GPS motion compensation). Unclamped,
        as in the reference."""
        st = self.scan_stamps
        if len(st) < 2:
            return np.zeros(3)
        i = int(np.clip(np.searchsorted(st, t), 1, len(st) - 1))
        dt = st[i] - st[i - 1]
        if dt <= 1e-6:
            return np.zeros(3)
        return (self.realtime_traj[i][:3, 3] - self.realtime_traj[i - 1][:3, 3]) / dt

    def _try_add_gps_factor(self, kf_idx, kf_stamp, corrected_T):
        cfg = self.cfg
        if self.traj_len < cfg.min_traj_len:
            return
        # skip while the pose is already well constrained: both x and y
        # translation marginals below pose_cov_thres
        pose_cov = self._pose_cov_estimate(kf_idx, corrected_T[:3, 3])
        if pose_cov[0] < cfg.pose_cov_thres and pose_cov[1] < cfg.pose_cov_thres:
            return
        # queue scrub around the keyframe stamp
        while self.gps_queue and self.gps_queue[0][0] < kf_stamp - cfg.gps_time_tol:
            self.gps_queue.pop(0)
        if not self.gps_queue:
            return
        stamp, enu, noise = self.gps_queue[0]
        if stamp > kf_stamp + cfg.gps_time_tol:
            return
        self.gps_queue.pop(0)
        if noise[0] > cfg.gps_cov_thres or noise[1] > cfg.gps_cov_thres:
            return
        if np.allclose(enu, 0.0):  # skip (0, 0, 0)
            return
        if cfg.gps_motion_comp and abs(stamp - kf_stamp) > 1e-6:
            # propagate the fix to the keyframe stamp
            enu = enu + self._velocity_at(kf_stamp) * (kf_stamp - stamp)
        if (
            self.last_gps_factor_pos is not None
            and np.linalg.norm(enu[:2] - self.last_gps_factor_pos[:2]) < cfg.gps_dist_thres
        ):
            return
        z = enu.copy()
        if not cfg.use_gps_elevation:  # z from SLAM
            z[2] = float(corrected_T[2, 3])
            noise = noise.copy()
            noise[2] = 0.01
        noise = np.maximum(noise, cfg.gps_noise_floor)
        if self._n_gps_host >= self.pgo_cfg.max_gps:
            self._grow_gps()
        self._n_gps_host += 1
        dev = self.device
        self.graph = add_gps(self.graph, kf_idx, upload(np.asarray(z, np.float32), dev),
                             upload(np.asarray(1.0 / noise, np.float32), dev))
        self.last_gps_factor_pos = enu
        self._needs_solve = True

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    def finish(self):
        """Resolve every chunk and loop verification in flight, attach GPS
        fixes still in the anchor warmup, and run a final solve."""
        while self._pending_chunks:
            self._resolve_chunk(self._pending_chunks.pop(0))
        if self.cfg.use_gps and self._gps_warmup:
            self._try_finalize_gps_anchor(force=True)
            if self.gps_queue and self.kf.n > 0:
                n = self.kf.n
                kf_stamps, kf_poses = host_read(self.kf.stamps[:n], self.graph.poses[:n])
                for k in range(n):
                    self._try_add_gps_factor(k, float(kf_stamps[k]), kf_poses[k])
        self._resolve_pending_loop()
        if self._needs_solve:
            self._solve()

    def keyframe_poses(self):
        """Corrected keyframe poses (n, 4, 4) numpy."""
        return host_read(self.graph.poses[: self.kf.n])

    def keyframe_stamps(self):
        return host_read(self.kf.stamps[: self.kf.n])

    @geometry_precision()
    def assemble_map(self, voxel: float = 0.3, max_points: int = 1 << 20):
        """Global corrected map: every keyframe cloud through its corrected
        pose, voxel-downsampled. Returns (M, 3) numpy."""
        n = self.kf.n
        world = se3.apply(self.graph.poses[:n], self.kf.clouds[:n])
        ds = voxel_downsample(Cloud(xyz=world.reshape(-1, 3),
                                    mask=self.kf.masks[:n].reshape(-1)), voxel)
        xyz, mask = host_read(ds.xyz, ds.mask)
        return xyz[mask][:max_points]
