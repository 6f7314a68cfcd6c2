"""Write a simulated sequence as a sensor recording: a ROS1 bag as the
preset's LiDAR driver publishes it, a MulRan directory, and a Newer
College ground-truth csv. The bag path, the MulRan reader and the Newer
College reader of ``scripts/run_slam.py`` then run on data whose truth is
known, without a downloaded dataset.

Conventions (the drivers' and datasets' own):
  * a spinning scan (``lidar_type`` 2 or 3) is published whole, columns in
    capture order (the sweep starts at azimuth pi and turns clockwise,
    ``sim/world.py: _ray_dirs``), each column's rings in order, a point
    with no return at (0, 0, 0); fields ``x y z intensity`` float32, ``t``
    uint32 (ns from the sweep start, as an Ouster driver writes it: the
    preset's ``timestamp_unit`` must be 3) and ``ring`` uint16;
  * a Livox scan (``lidar_type`` 1) is a ``livox_ros_driver/CustomMsg`` of
    its returns, ``offset_time`` in ns from the sweep start;
  * a scan's record time is the end of its sweep and its header stamp the
    start (a driver stamps the sweep's start and the recorder receives it
    at its end); stamps are whole nanoseconds from ``T0_NS``;
  * GPS fixes are the simulator's world positions through the WGS84 ENU
    frame at ``ANCHOR`` (``core/geodesy.py``, float32 as the engine reads
    them), with the simulator's noise as their covariance.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..io.rosbag import (
    BagWriter,
    _pack_rosheader,
    encode_imu,
    encode_navsatfix,
    encode_pointcloud2,
)

# the recordings' clock starts at 1000 s, not at a Unix epoch: both
# engines keep keyframe stamps in float32, whose spacing at 1.6e9 s is
# 128 s, so with epoch stamps no two keyframes are ever the loop search's
# time gap apart and no loop is ever tried (ROADMAP Queue 3 fault 3);
# 1000 s keeps MulRan's nanosecond file names one length, as its reader
# sorts them as text
T0_NS = 1000 * 10**9
ANCHOR = (22.3193, 114.1694, 10.0)  # the bench's GPS origin

OUSTER_POINT = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
                         ("t", "<u4"), ("ring", "<u2")])
LIVOX_POINT = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")])


def encode_livox_custommsg(points: np.ndarray, stamp: float, timebase_ns: int,
                           frame_id="livox_frame", seq=0) -> bytes:
    """``LIVOX_POINT`` records -> livox_ros_driver/CustomMsg (the layout
    ``io/rosbag.py: decode_livox_custommsg`` reads)."""
    pts = np.ascontiguousarray(points, LIVOX_POINT)
    return b"".join([
        _pack_rosheader(seq, stamp, frame_id), struct.pack("<QI", timebase_ns, len(pts)),
        bytes(4),  # lidar_id, 3 reserved bytes
        struct.pack("<I", len(pts)), pts.tobytes(),
    ])


def capture_order(n_azimuth: int, n_rings: int) -> np.ndarray:
    """Indices of the simulator's (azimuth-major) rays in capture order:
    column c is azimuth (n_azimuth / 2 - c) mod n_azimuth."""
    a = (n_azimuth // 2 - np.arange(n_azimuth)) % n_azimuth
    return (a[:, None] * n_rings + np.arange(n_rings)[None, :]).reshape(-1)


def _stamps_ns(data):
    """Integer-ns stamps of the scans' ends, their IMU samples (per scan)
    and the GPS fixes."""
    scan_ns = int(round(data["scan_dt"] * 1e9))
    ends = [T0_NS + (k + 1) * scan_ns for k in range(len(data["scans"]))]
    imu = []
    for k, (ts, _, _) in enumerate(data["imu"]):
        step_ns = scan_ns // len(ts)
        imu.append(T0_NS + k * scan_ns + np.arange(len(ts)) * step_ns)
    gps = [T0_NS + int(round(g[0] * 1e9)) for g in data["gps"]]
    return ends, imu, gps


def _geodetic(data):
    import torch

    from ..core.geodesy import LocalCartesian

    if not data["gps"]:
        return np.zeros((0, 3))
    xyz = np.stack([g[1] for g in data["gps"]]).astype(np.float32)
    lat, lon, alt = LocalCartesian.from_origin(*ANCHOR).reverse(torch.from_numpy(xyz))
    return np.stack([lat.numpy(), lon.numpy(), alt.numpy()], axis=1).astype(np.float64)


def spinning_cloud(pts, t_off, hits, n_azimuth: int, n_rings: int):
    """One scan as ``OUSTER_POINT`` records in capture order."""
    order = capture_order(n_azimuth, n_rings)
    cloud = np.zeros(len(order), OUSTER_POINT)
    hit = hits[order]
    for i, name in enumerate("xyz"):
        cloud[name] = np.where(hit, pts[order, i], 0.0)
    cloud["intensity"] = np.where(hit, 100.0, 0.0)
    cloud["t"] = np.round(t_off[order].astype(np.float64) * 1e9).astype(np.uint32)
    cloud["ring"] = np.tile(np.arange(n_rings, dtype=np.uint16), n_azimuth)
    return cloud


def write_bag(path: str, data, preset, n_azimuth: int, n_rings: int, gps_period: float = 1.0,
              n_scans: int | None = None) -> str:
    """The first ``n_scans`` scans of ``data`` (``sim/world.py:
    simulate_sequence``, rendered in the preset's LiDAR frame) with their
    IMU samples on the preset's topics, and the fixes at multiples of
    ``gps_period`` seconds on its GPS topic."""
    if preset.lidar_type != 1 and preset.timestamp_unit != 3:
        raise ValueError("spinning scans are written with ns point times (timestamp_unit 3)")
    n = len(data["scans"]) if n_scans is None else n_scans
    ends, imu_ns, gps_ns = _stamps_ns(data)
    scan_ns = int(round(data["scan_dt"] * 1e9))
    with BagWriter(path) as w:
        # the fixes first: the writer orders records by time, written order
        # among equal times, so a fix stamped with a scan's end reaches the
        # engine with that scan, in time for its keyframe's GPS factor
        geo = _geodetic(data)
        period_ns = int(round(gps_period * 1e9))
        for (tg, _, noise), s_ns, (lat, lon, alt) in zip(data["gps"], gps_ns, geo):
            if (s_ns - T0_NS) % period_ns == 0 and s_ns <= ends[n - 1]:
                w.write(preset.gps_topic, "sensor_msgs/NavSatFix", s_ns * 1e-9,
                        encode_navsatfix(s_ns * 1e-9, lat, lon, alt,
                                         cov_diag=tuple(np.square(noise))))
        for k in range(n):
            pts, t_off, hits = data["scans"][k]
            end, start_ns = ends[k] * 1e-9, ends[k] - scan_ns
            if preset.lidar_type == 1:
                keep = np.nonzero(hits)[0]
                rec = np.zeros(len(keep), LIVOX_POINT)
                rec["offset_time"] = np.round(t_off[keep].astype(np.float64) * 1e9)
                for i, name in enumerate("xyz"):
                    rec[name] = pts[keep, i]
                rec["reflectivity"] = 100
                w.write(preset.lid_topic, "livox_ros_driver/CustomMsg", end,
                        encode_livox_custommsg(rec, start_ns * 1e-9, start_ns, seq=k))
            else:
                cloud = spinning_cloud(pts, t_off, hits, n_azimuth, n_rings)
                w.write(preset.lid_topic, "sensor_msgs/PointCloud2", end,
                        encode_pointcloud2(cloud, start_ns * 1e-9, frame_id="os_lidar", seq=k))
            ts, gyro, acc = data["imu"][k]
            for j, s_ns in enumerate(imu_ns[k]):
                w.write(preset.imu_topic, "sensor_msgs/Imu", s_ns * 1e-9,
                        encode_imu(s_ns * 1e-9, gyro[j], acc[j], seq=len(ts) * k + j))
    return path


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) of a rotation matrix, from its largest
    diagonal term (stable at every angle)."""
    tr = np.trace(R)
    k = int(np.argmax([R[0, 0], R[1, 1], R[2, 2], tr]))
    if k == 3:
        w = np.sqrt(1.0 + tr) / 2.0
        q = [(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w), w]
    else:
        i, j, m = k, (k + 1) % 3, (k + 2) % 3
        v = np.sqrt(1.0 + R[i, i] - R[j, j] - R[m, m]) / 2.0
        q = [0.0, 0.0, 0.0, (R[m, j] - R[j, m]) / (4 * v)]
        q[i], q[j], q[m] = v, (R[j, i] + R[i, j]) / (4 * v), (R[m, i] + R[i, m]) / (4 * v)
    return np.asarray(q)


def write_gt_csv(path: str, data, n_scans: int | None = None) -> str:
    """Newer College ``registered_poses.csv`` (sec, nsec, x, y, z, qx, qy,
    qz, qw) of the body's true pose at each scan's end."""
    n = len(data["scans"]) if n_scans is None else n_scans
    ends, _, _ = _stamps_ns(data)
    rows = ["sec,nsec,x,y,z,qx,qy,qz,qw"]
    for k in range(n):
        R, p = data["gt"][k]
        q = _quat_xyzw(R)
        rows.append(f"{ends[k] // 10**9},{ends[k] % 10**9},"
                    + ",".join(f"{v:.9f}" for v in (*p, *q)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def write_mulran(root: str, data, n_azimuth: int, n_rings: int, lidar_R, lidar_t,
                 n_scans: int | None = None) -> str:
    """A MulRan sequence directory: ``sensor_data/Ouster/<ns>.bin`` (x, y,
    z, intensity float32 in the body frame, columns in capture order, no
    return at (0, 0, 0)), ``sensor_data/xsens_imu.csv`` (stamp ns,
    quaternion, rpy, gyro, accel, magnetometer), ``sensor_data/gps.csv``
    (stamp ns, lat, lon, alt, 3x3 covariance) and ``global_pose.csv``
    (stamp ns, 3x4 pose)."""
    n = len(data["scans"]) if n_scans is None else n_scans
    ends, imu_ns, gps_ns = _stamps_ns(data)
    ouster = os.path.join(root, "sensor_data", "Ouster")
    os.makedirs(ouster, exist_ok=True)
    R = np.asarray(lidar_R, np.float64).reshape(3, 3)
    t = np.asarray(lidar_t, np.float64)
    order = capture_order(n_azimuth, n_rings)
    for k in range(n):
        pts, _, hits = data["scans"][k]
        body = (pts[order].astype(np.float64) @ R.T + t).astype(np.float32)
        hit = hits[order]
        rec = np.zeros((len(order), 4), np.float32)
        rec[:, :3] = np.where(hit[:, None], body, 0.0)
        rec[:, 3] = np.where(hit, 100.0, 0.0)
        rec.tofile(os.path.join(ouster, f"{ends[k]}.bin"))
    imu_rows = []
    for k in range(n):
        _, gyro, acc = data["imu"][k]
        for j, s_ns in enumerate(imu_ns[k]):
            imu_rows.append(f"{s_ns},0,0,0,1,0,0,0," + ",".join(
                f"{v:.9f}" for v in (*gyro[j], *acc[j], 0.0, 0.0, 0.0)))
    with open(os.path.join(root, "sensor_data", "xsens_imu.csv"), "w") as f:
        f.write("\n".join(imu_rows) + "\n")
    geo = _geodetic(data)
    gps_rows = []
    for (tg, _, noise), s_ns, (lat, lon, alt) in zip(data["gps"], gps_ns, geo):
        if s_ns <= ends[n - 1]:
            cov = np.diag(np.square(noise)).reshape(-1)
            gps_rows.append(f"{s_ns},{lat:.9f},{lon:.9f},{alt:.4f}," + ",".join(
                f"{v:.6f}" for v in cov))
    with open(os.path.join(root, "sensor_data", "gps.csv"), "w") as f:
        f.write("\n".join(gps_rows) + "\n")
    pose_rows = []
    for k in range(n):
        Rb, p = data["gt"][k]
        pose_rows.append(f"{ends[k]}," + ",".join(
            f"{v:.9f}" for v in np.hstack([Rb, p[:, None]]).reshape(-1)))
    with open(os.path.join(root, "global_pose.csv"), "w") as f:
        f.write("\n".join(pose_rows) + "\n")
    return root


OS1_64_ELEV_FOV = (-0.2897, 0.2897)  # radians: an Ouster OS1-64's +-16.6 degrees


def from_rest(traj, start: float = 0.0, rest: float = 0.5, ramp: float = 3.0):
    """``traj`` retimed to start at rest at its pose of time ``start``, as a
    recording does: still for ``rest`` seconds (the IMU's gravity
    initialization reads its first samples there), then up to full speed
    along the same path over ``ramp`` seconds (a smoothstep of the path's
    clock, so velocity and acceleration stay continuous)."""
    from .world import Trajectory

    def clock(t):
        u = min(max((t - rest) / ramp, 0.0), 1.0)
        if u < 1.0:
            return start + ramp * (u ** 3 - 0.5 * u ** 4)
        return start + t - rest - 0.5 * ramp

    return Trajectory(pose_fn=lambda t: traj.pose(clock(t)))


def render_figure8(n_scans: int, preset, n_azimuth: int = 1024, n_rings: int = 64,
                   seed: int = 11):
    """The bench's figure-8 loop feed (``bench.py: build_fig8_sequence``: a
    lemniscate 12 m / 12 s through a 60 m room with 25 boxes, 120 m
    range), started from rest (:func:`from_rest`: the engine's odometry
    starts at zero velocity, as FAST-LIO's does) at the path's point that
    heads along +x (east: the engine anchors the GPS frame by translation
    only, so GPS fusion takes the start's axes for ENU's), at Ouster OS1-64
    geometry (``n_azimuth`` x ``n_rings`` rays over +-16.6 degrees,
    per-column capture times), IMU at 100 Hz, GPS at 10 Hz, in the LiDAR
    frame of ``preset`` (its extrinsic maps the points back to the body)."""
    from .world import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=seed)
    # yaw 0 at an eighth of the period (dy/dx = cos 2a / cos a = 0)
    traj = from_rest(Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2), start=1.5)
    cfg = SimConfig(scan_rate=10.0, imu_rate=100.0, n_azimuth=n_azimuth, n_elev=n_rings,
                    elev_fov=OS1_64_ELEV_FOV, max_range=120.0, gyro_noise=0.001,
                    acc_noise=0.01, seed=seed, time_groups=None, gps_rate=10.0,
                    lidar_R=np.asarray(preset.extrinsic_R, np.float64).reshape(3, 3),
                    lidar_t=np.asarray(preset.extrinsic_T, np.float64))
    return simulate_sequence(world, traj, cfg, n_scans=n_scans)
