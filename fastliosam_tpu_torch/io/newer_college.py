"""Newer College 2020 dataset reader (Ouster OS1-64 rosbags + GT csv).

BASELINE.md eval config #2 (full pipeline + loop closures). The dataset is
distributed as ROS1 bags with `/os1_cloud_node/points` +
`/os1_cloud_node/imu` and a `registered_poses.csv` ground truth; everything
decodes through the self-contained `io.rosbag` layer.

The port's own numpy copy of ``fastliosam_tpu/io/newer_college.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .rosbag import BagReader, decode_imu, decode_pointcloud2


@dataclass
class NewerCollegeSequence:
    """Streams (scan, imu_batch) pairs from one or more bags."""

    bags: list
    points_topic: str = "/os1_cloud_node/points"
    imu_topic: str = "/os1_cloud_node/imu"
    gt_csv: str | None = None

    def __post_init__(self):
        if isinstance(self.bags, str):
            self.bags = (
                sorted(
                    os.path.join(self.bags, f)
                    for f in os.listdir(self.bags)
                    if f.endswith(".bag")
                )
                if os.path.isdir(self.bags)
                else [self.bags]
            )
        self.gt = None
        if self.gt_csv and os.path.exists(self.gt_csv):
            rows = np.loadtxt(self.gt_csv, delimiter=",", skiprows=1, ndmin=2)
            # columns: sec, nsec, x, y, z, qx, qy, qz, qw
            stamps = rows[:, 0] + rows[:, 1] * 1e-9
            n = len(rows)
            poses = np.tile(np.eye(4), (n, 1, 1))
            for i, r in enumerate(rows):
                x, y, z, qx, qy, qz, qw = r[2:9]
                poses[i, :3, 3] = (x, y, z)
                poses[i, :3, :3] = _quat_to_mat(qw, qx, qy, qz)
            self.gt = {"stamps": stamps, "poses": poses}

    def stream(self):
        """Yields ('scan', stamp, (xyz, intensity, t_offset)) and
        ('imu', stamp, (gyro, accel)) events in bag order."""
        for bag in self.bags:
            for msg in BagReader(bag):
                if msg.topic == self.points_topic:
                    cloud, hdr = decode_pointcloud2(msg.raw)
                    xyz = np.column_stack(
                        [cloud["x"], cloud["y"], cloud["z"]]
                    ).astype(np.float32)
                    names = cloud.dtype.names
                    inten = (
                        cloud["intensity"].astype(np.float32)
                        if "intensity" in names
                        else np.zeros(len(cloud), np.float32)
                    )
                    if "t" in names:  # ouster per-point time (ns from start)
                        t_off = cloud["t"].astype(np.float32) * 1e-9
                    else:
                        t_off = np.zeros(len(cloud), np.float32)
                    yield ("scan", msg.stamp, (xyz, inten, t_off))
                elif msg.topic == self.imu_topic:
                    imu = decode_imu(msg.raw)
                    yield (
                        "imu",
                        msg.stamp,
                        (imu["angular_velocity"], imu["linear_acceleration"]),
                    )


def _quat_to_mat(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
