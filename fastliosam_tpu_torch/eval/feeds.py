"""The feed and engine functions of ``bench.py`` (port): the synthetic
sequences, their packing and cache, the staged odometry rollout and the
bench's loop-closing engine, under the bench's names.

    data = fig8_sequence()                    # build_fig8_sequence, cached
    engine = make_engine_for(data, chunk=5)   # on cuda; device="cpu" on the CPU
    feed, dt = _stage_chunks(data, 5, engine.device)
    _init_engine_at(engine, data)
    seconds = _run_pipeline(engine, feed, deferred=True)

The sequence functions draw through the port's ``sim/`` and give the JAX
package's arrays bit for bit (``tests/test_torch_feeds_scripts.py``).
Cached sequences live under ``build/feeds/`` (the bench caches under
``out/``), one file per sequence and length. ``_fixes_from_data`` turns a
sequence's GPS positions into the engine's fixes. Only these functions moved
here: the bench's timing, metrics and ``main`` are not ported.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CACHE_DIR = ROOT / "build" / "feeds"

N_SCANS = 40
N_WARM = 3
RAW_PTS = 32768  # ~HDL-64 after point_filter_num=4
IMU_CAP = 32
PIPE_SCANS = 150  # the loop-closing figure-8 feed
CORR_SCANS = 400  # the GPS corridor
GPS_ANCHOR = (22.3193, 114.1694, 10.0)  # lat, lon, alt of the sim world's origin


def build_sequence(n_scans: int = N_SCANS + N_WARM) -> dict:
    """The odometry feed (``bench.py: build_sequence``): a circle through a
    60 m room, 2048 x 16 rays at 10 Hz, IMU padded to ``IMU_CAP``."""
    from ..sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=7)
    traj = Trajectory.circle(radius=8.0, period=40.0, z_amp=0.3)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0,
                    gyro_noise=0.001, acc_noise=0.01, seed=7, time_groups=32)
    data = simulate_sequence(world, traj, cfg, n_scans=n_scans)
    R0, p0 = traj.pose(0.0)
    return {
        "R0": R0.astype(np.float32),
        "p0": p0.astype(np.float32),
        "v0": traj.velocity(0.0).astype(np.float32),
        "xyz": np.stack([s[0] for s in data["scans"]]).astype(np.float32),
        "toff": np.stack([s[1] for s in data["scans"]]).astype(np.float32),
        "mask": np.stack([s[2] for s in data["scans"]]),
        **_pad_imu(data["imu"], IMU_CAP),
        "gt_p": np.stack([g[1] for g in data["gt"]]).astype(np.float32),
        "scan_dt": np.float32(data["scan_dt"]),
    }


def _pad_imu(imu, cap: int) -> dict:
    """The per-scan IMU batches padded to ``cap`` samples (stamps with 1e9,
    readings with 0) and their mask."""
    def pad(i, fill=0.0):
        return np.stack([np.pad(b[i], ((0, cap - len(b[i])),) + ((0, 0),) * (b[i].ndim - 1),
                                constant_values=fill) for b in imu]).astype(np.float32)

    return {"imu_t": pad(0, 1e9), "imu_g": pad(1), "imu_a": pad(2),
            "imu_m": np.stack([np.arange(cap) < len(b[0]) for b in imu])}


def build_fig8_sequence(n_scans: int = PIPE_SCANS) -> dict:
    """The loop-rich feed (``bench.py: build_fig8_sequence``): a lemniscate
    through the room, self-intersecting, GPS at 10 Hz with 0.5 m noise."""
    from ..sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=11)
    traj = Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0,
                    gyro_noise=0.001, acc_noise=0.01, seed=11, time_groups=32,
                    gps_rate=10.0, gps_noise=0.5)
    return pack_sequence(simulate_sequence(world, traj, cfg, n_scans=n_scans), traj)


def build_corridor_sequence(n_scans: int = CORR_SCANS) -> dict:
    """The degenerate-geometry feed (``bench.py: build_corridor_sequence``):
    a 400 m corridor whose planes are all ⊥ x beyond its clutter, 6 m/s,
    a strong accelerometer bias, GPS at 10 Hz with 0.3 m noise."""
    from ..sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.corridor(length=400.0, width=8.0, height=5.0, n_clutter=8,
                                clutter_span=15.0, seed=3)
    traj = Trajectory.straight(speed=6.0)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=60.0,
                    gyro_noise=0.001, acc_noise=0.01, acc_bias=(0.08, -0.03, 0.04),
                    seed=3, time_groups=32, gps_rate=10.0, gps_noise=0.3)
    return pack_sequence(simulate_sequence(world, traj, cfg, n_scans=n_scans), traj)


def pack_sequence(data, traj) -> dict:
    """A simulated sequence as stacked arrays (``bench.py: pack_sequence``):
    scans, IMU padded to at least ``IMU_CAP`` samples (stamps padded with
    1e9), ground truth, scan stamps and the GPS fixes, if any."""
    cap = max(IMU_CAP, max(len(b[0]) for b in data["imu"]))
    R0, p0 = traj.pose(0.0)
    gps = data.get("gps", [])
    out = {
        "R0": R0.astype(np.float32),
        "p0": p0.astype(np.float32),
        "v0": traj.velocity(0.0).astype(np.float32),
        "xyz": np.stack([s[0] for s in data["scans"]]).astype(np.float32),
        "toff": np.stack([s[1] for s in data["scans"]]).astype(np.float32),
        "mask": np.stack([s[2] for s in data["scans"]]),
        **_pad_imu(data["imu"], cap),
        "gt_p": np.stack([g[1] for g in data["gt"]]).astype(np.float32),
        "gt_R": np.stack([g[0] for g in data["gt"]]).astype(np.float32),
        "stamps": np.asarray(data["stamps"], np.float64),
        "scan_dt": np.float32(data["scan_dt"]),
    }
    if len(gps):
        out["gps_t"] = np.asarray([g[0] for g in gps], np.float64)
        out["gps_xyz"] = np.stack([g[1] for g in gps]).astype(np.float64)
        out["gps_noise"] = np.asarray([g[2] for g in gps], np.float64)
    return out


def _cached(path, make) -> dict:
    """Load ``path``, or build it and write it there (through a temporary
    file, so that processes building the same feed never read half of
    one)."""
    path = Path(path)
    if path.exists():
        with np.load(path) as f:
            return dict(f)
    data = make()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **data)
    tmp.replace(path)
    return data


def cache_path(name: str, n_scans: int) -> Path:
    """Where the feed ``name`` (``seq``, ``fig8``) of ``n_scans`` scans is
    cached."""
    return CACHE_DIR / f"{name}_{n_scans}.npz"


def get_sequence(n_scans: int = N_SCANS + N_WARM) -> dict:
    """:func:`build_sequence`, cached (``bench.py: get_sequence``)."""
    return _cached(cache_path("seq", n_scans), lambda: build_sequence(n_scans))


def fig8_sequence(n_scans: int = PIPE_SCANS) -> dict:
    """:func:`build_fig8_sequence`, cached (the bench's ``_cached(PIPE_CACHE,
    build_fig8_sequence)``)."""
    return _cached(cache_path("fig8", n_scans), lambda: build_fig8_sequence(n_scans))


def pad_scans(data, raw_pts: int = RAW_PTS):
    """Pad (or cut) the ray count to the static point budget: padded points
    at 1e6 m, masked out."""
    s, n, _ = data["xyz"].shape
    if n >= raw_pts:
        sl = slice(0, raw_pts)
        return data["xyz"][:, sl], data["toff"][:, sl], data["mask"][:, sl]
    pad = raw_pts - n
    xyz = np.pad(data["xyz"], ((0, 0), (0, pad), (0, 0)), constant_values=1e6)
    toff = np.pad(data["toff"], ((0, 0), (0, pad)))
    mask = np.pad(data["mask"], ((0, 0), (0, pad)))
    return xyz, toff, mask


def _stage(array, dev):
    return torch.from_numpy(np.ascontiguousarray(array)).to(dev)


def _set_nav(state, data, dev, jitter: float = 0.0):
    """``state`` at the feed's true initial pose and velocity, ``p`` moved
    by ``jitter`` metres on every axis (float32, as the bench adds it)."""
    p = np.asarray(data["p0"], np.float32) + np.float32(jitter)
    return state._replace(nav=state.nav._replace(
        R=_stage(np.asarray(data["R0"], np.float32), dev), p=_stage(p, dev),
        v=_stage(np.asarray(data["v0"], np.float32), dev)))


def make_rollout(data, raw_pts: int = RAW_PTS, query_mode: str = "merged3",
                 num_ds: int = 8192, requery_iters: int = 1, device=None) -> dict:
    """The odometry rollout of ``bench.py: make_rollout`` and its feed
    staged on ``device`` (``cuda`` by default): ``roll(state, scans,
    imus)`` is :func:`odom.pipeline.odom_rollout` at the bench's map and
    odometry configuration (run eagerly: nothing is compiled),
    ``gt_state(jitter)`` the state at the true initial pose (``p`` moved by
    ``jitter``), ``identity_state()`` the fresh one."""
    from ..map import VoxelMapConfig
    from ..odom import ImuBatch, OdomConfig, Scan, init_odom
    from ..odom.pipeline import odom_rollout
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    # probe windows 2: at this capacity and load the 2-round window misses
    # almost nothing (the bench's measurement)
    map_cfg = VoxelMapConfig(capacity=1 << 19, voxel_size=0.5, min_points=5,
                             query_probes=2, insert_probes=2, claim_probes=2)
    odom_cfg = OdomConfig(point_filter_num=1, blind=1.0, filter_size_surf=0.5,
                          num_ds_points=num_ds, det_range=150.0, evict_every=10_000,
                          query_mode=query_mode, requery_iters=requery_iters)
    xyz, toff, mask = pad_scans(data, raw_pts)
    scans = Scan(xyz=_stage(xyz, dev), t_offset=_stage(toff, dev), mask=_stage(mask, dev))
    imus = ImuBatch(stamps=_stage(data["imu_t"], dev), gyro=_stage(data["imu_g"], dev),
                    acc=_stage(data["imu_a"], dev), mask=_stage(data["imu_m"], dev))
    dt = float(np.float32(data["scan_dt"]))

    def roll(st, scans, imus):
        return odom_rollout(st, scans, imus, dt, odom_cfg, map_cfg, device=dev)

    def gt_state(jitter: float = 0.0):
        return _set_nav(init_odom(map_cfg, device=dev), data, dev, jitter)

    def identity_state():
        return init_odom(map_cfg, device=dev)

    return {"roll": roll, "scans": scans, "imus": imus, "S": xyz.shape[0],
            "gt_state": gt_state, "identity_state": identity_state,
            "map_cfg": map_cfg, "odom_cfg": odom_cfg}


def make_engine_for(data=None, raw_pts: int = RAW_PTS, chunk: int = 5, max_kf: int = 128,
                    max_between: int = 256, max_gps: int = 64, device=None, mesh=None):
    """The bench's loop-closing engine (``bench.py: make_engine_for``): 8192
    iEKF points, merged3, a 2^19-slot map with 2 probes, loops at 10 m / 4 s
    over 16,384-point submaps, keyframes every metre, the graph's
    capacities sized by the caller. ``data`` and ``raw_pts`` are unused, as
    in the bench; ``mesh`` builds it in mesh mode (``parallel``) on the
    rank's device."""
    from ..loop import LoopConfig
    from ..map import VoxelMapConfig
    from ..odom import OdomConfig
    from ..pgo import PoseGraphConfig
    from ..runtime import EngineConfig, SlamEngine

    return SlamEngine(
        odom_cfg=OdomConfig(point_filter_num=1, blind=1.0, filter_size_surf=0.5,
                            num_ds_points=8192, det_range=150.0, evict_every=10_000,
                            query_mode="merged3"),
        map_cfg=VoxelMapConfig(capacity=1 << 19, voxel_size=0.5, min_points=5,
                               query_probes=2, insert_probes=2, claim_probes=2),
        loop_cfg=LoopConfig(radius=10.0, time_gap=4.0, num_submap_keyframes=5,
                            voxel_res=0.3, submap_points=16384),
        pgo_cfg=PoseGraphConfig(max_keyframes=max_kf, max_between=max_between,
                                max_gps=max_gps),
        cfg=EngineConfig(keyframe_threshold=1.0, loop_check_every=chunk,
                         kf_cloud_points=4096, kf_cloud_voxel=0.3),
        mesh=mesh,
        device=device,
    )


def _stage_chunks(data, chunk: int, device=None, raw_pts: int = RAW_PTS):
    """The packed sequence staged on ``device`` as whole chunks of ``chunk``
    scans (the tail that fills no chunk is dropped, as the bench drops
    it): ``([(scans, imus, stamps, dt, lo, hi)], dt)``, where ``[lo, hi)``
    is the chunk's GPS window."""
    from ..odom import ImuBatch, Scan
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    xyz, toff, mask = pad_scans(data, raw_pts)
    S = xyz.shape[0]
    stamps_all = np.asarray(data["stamps"], np.float64)
    dt = float(data["scan_dt"])
    feed = []
    for c in range(0, S - (S % chunk), chunk):
        sl = slice(c, c + chunk)
        scans = Scan(xyz=_stage(xyz[sl], dev), t_offset=_stage(toff[sl], dev),
                     mask=_stage(mask[sl], dev))
        imus = ImuBatch(stamps=_stage(data["imu_t"][sl], dev),
                        gyro=_stage(data["imu_g"][sl], dev),
                        acc=_stage(data["imu_a"][sl], dev), mask=_stage(data["imu_m"][sl], dev))
        feed.append((scans, imus, stamps_all[sl], dt,
                     float(stamps_all[sl][0]) - dt, float(stamps_all[sl][-1])))
    return feed, dt


def sync(engine) -> None:
    """Drain the engine's device queue (a no-op on the CPU)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _run_pipeline(engine, feed, gps_fixes=None, deferred: bool = False) -> float:
    """One engine run over the staged chunks, ``finish()`` included; wall
    seconds on the host clock, from and to a drained device queue.
    ``deferred`` drives ``process_chunk_deferred`` (the production mode);
    each chunk gets the fixes of its window."""
    step = engine.process_chunk_deferred if deferred else engine.process_chunk
    sync(engine)
    t0 = time.perf_counter()
    for (scans, imus, stamps, dt, lo, hi) in feed:
        fixes = None
        if gps_fixes is not None:
            fixes = [f for f in gps_fixes if lo <= f.stamp < hi]
        step(scans, imus, stamps, dt, gps=fixes)
    engine.finish()
    sync(engine)
    return time.perf_counter() - t0


def _fixes_from_data(data, degrade_middle: bool = False, good_cov=(0.25, 0.25, 1.0)) -> list:
    """The sequence's world-frame GPS positions as ``runtime.GpsFix``
    records (``bench.py: _fixes_from_data``): each goes through WGS84
    geodesy from the bench's anchor (float32, as in the engine), so the
    engine's ``LocalCartesian`` path is exercised. With ``degrade_middle``
    the middle third of the fixes gets the covariance (9, 9, 16) m^2, the
    rest ``good_cov``."""
    from ..core.geodesy import LocalCartesian
    from ..runtime import GpsFix

    lc = LocalCartesian.from_origin(*GPS_ANCHOR)
    ts = data["gps_t"]
    lat, lon, alt = (t.numpy() for t in lc.reverse(
        torch.from_numpy(np.asarray(data["gps_xyz"], np.float32))))
    n = len(ts)
    fixes = []
    for i in range(n):
        bad = degrade_middle and (n // 3 <= i < 2 * n // 3)
        fixes.append(GpsFix(stamp=float(ts[i]), lat=float(lat[i]), lon=float(lon[i]),
                            alt=float(alt[i]), cov_xyz=(9.0, 9.0, 16.0) if bad else good_cov))
    return fixes


def _init_engine_at(engine, data, jitter: float = 0.0) -> None:
    """``engine.reset()`` at the feed's true initial pose and velocity
    (``bench.py: _init_engine_at``; ``jitter`` moves ``p`` as the bench's
    ``bench_pipeline`` does for its jittered runs)."""
    engine.reset()
    engine.odom = _set_nav(engine.odom, data, engine.device, jitter)
