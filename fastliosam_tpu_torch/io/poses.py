"""Trajectory file formats: KITTI 3x4 rows and TUM (t x y z qx qy qz qw).

Mirrors the reference's `saveFlagCallback` export formats
(`fast_lio_sam.cpp:823-867`), including its readable-timestamp TUM variant
(`unixToReadableTimestamp`, `fast_lio_sam.cpp:14-43`: yyyymmddhhmmssSSS).

The port's own numpy copy of ``fastliosam_tpu/io/poses.py``.
"""
from __future__ import annotations

from datetime import datetime, timezone

import numpy as np


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    """poses (N, 4, 4) -> one 3x4 row-major line each (KITTI odometry)."""
    rows = np.asarray(poses)[:, :3, :4].reshape(len(poses), 12)
    np.savetxt(path, rows, fmt="%.9f")


def read_kitti_poses(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = len(rows)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :4] = rows
    return out


def _quat_from_matrix(R):
    """(w, x, y, z) from a rotation matrix (numpy, Shepperd)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
        )
    if i == 1:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        return np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
        )
    s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
    return np.array(
        [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
         (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    )


def unix_to_readable(stamp: float) -> str:
    """Unix seconds -> yyyymmddhhmmssSSS (reference fast_lio_sam.cpp:14-43)."""
    dt = datetime.fromtimestamp(stamp, tz=timezone.utc)
    return dt.strftime("%Y%m%d%H%M%S") + f"{int(round(dt.microsecond / 1000)):03d}"


def write_tum_trajectory(
    path: str, stamps, poses: np.ndarray, readable_stamps: bool = False
) -> None:
    """TUM format: ``stamp x y z qx qy qz qw`` per line."""
    with open(path, "w") as f:
        for stamp, T in zip(stamps, np.asarray(poses)):
            w, x, y, z = _quat_from_matrix(T[:3, :3])
            ts = unix_to_readable(float(stamp)) if readable_stamps else f"{float(stamp):.6f}"
            t = T[:3, 3]
            f.write(
                f"{ts} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n"
            )


def read_tum_trajectory(path: str):
    """Returns (stamps (N,), poses (N, 4, 4))."""
    rows = np.loadtxt(path, ndmin=2)
    stamps = rows[:, 0]
    n = len(rows)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i, r in enumerate(rows):
        x, y, z, qx, qy, qz, qw = r[1:8]
        n2 = qw * qw + qx * qx + qy * qy + qz * qz
        qw, qx, qy, qz = (q / np.sqrt(n2) for q in (qw, qx, qy, qz))
        poses[i, :3, :3] = np.array(
            [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
            ]
        )
        poses[i, :3, 3] = (x, y, z)
    return stamps, poses
