"""KITTI odometry dataset reader: velodyne .bin scans + times + calib +
ground-truth poses + (raw-suite) OXTS GPS/IMU.

Dataset contract per the reference's KITTI configuration
(`third_party/fastlio_config_launch/kitti.yaml`, `kitti.launch`). KITTI
odometry has no IMU stream — the engine runs it LiDAR-only (constant
velocity propagation); the raw-suite OXTS parser supplies IMU/GPS when a
raw sync+rect sequence directory is given.

The port's own numpy copy of ``fastliosam_tpu/io/kitti.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _azimuth_time_offsets(xyz: np.ndarray, scan_period: float = 0.1) -> np.ndarray:
    """Synthesize per-point capture times from azimuth (KITTI bins carry no
    timestamps; the spinning sensor sweeps clockwise from +x)."""
    az = np.arctan2(xyz[:, 1], xyz[:, 0])  # (-pi, pi]
    frac = (-az + np.pi) / (2 * np.pi)  # 0..1 over the sweep
    return (frac * scan_period).astype(np.float32)


@dataclass
class KittiSequence:
    """KITTI odometry sequence directory:
    ``<root>/sequences/<seq>/velodyne/*.bin``, ``times.txt``, ``calib.txt``
    and optionally ``<root>/poses/<seq>.txt`` ground truth."""

    root: str
    seq: str

    def __post_init__(self):
        self.seq_dir = os.path.join(self.root, "sequences", self.seq)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.files = sorted(
            f for f in os.listdir(self.velo_dir) if f.endswith(".bin")
        )
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = (
            np.loadtxt(times_path)
            if os.path.exists(times_path)
            else np.arange(len(self.files)) * 0.1
        )
        self.calib = self._load_calib()

    def __len__(self):
        return len(self.files)

    def _load_calib(self):
        path = os.path.join(self.seq_dir, "calib.txt")
        calib = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    vals = np.fromstring(rest, sep=" ")
                    if vals.size == 12:
                        calib[key.strip()] = vals.reshape(3, 4)
        return calib

    def scan(self, i: int):
        """Returns (xyz (N,3) f32, intensity (N,), t_offset (N,))."""
        raw = np.fromfile(
            os.path.join(self.velo_dir, self.files[i]), dtype=np.float32
        ).reshape(-1, 4)
        xyz = raw[:, :3]
        return xyz, raw[:, 3], _azimuth_time_offsets(xyz)

    def gt_poses(self):
        """Ground-truth poses (camera frame) if available: (N, 4, 4)."""
        path = os.path.join(self.root, "poses", f"{self.seq}.txt")
        if not os.path.exists(path):
            return None
        rows = np.loadtxt(path).reshape(-1, 3, 4)
        out = np.tile(np.eye(4), (len(rows), 1, 1))
        out[:, :3, :4] = rows
        return out


def read_oxts(oxts_dir: str):
    """KITTI raw-suite OXTS packets -> dict with lat/lon/alt, rpy, accel,
    gyro per frame (the GPS+IMU source for the raw sequences)."""
    files = sorted(
        os.path.join(oxts_dir, f)
        for f in os.listdir(oxts_dir)
        if f.endswith(".txt")
    )
    rows = np.stack([np.loadtxt(f) for f in files])
    return {
        "lat": rows[:, 0],
        "lon": rows[:, 1],
        "alt": rows[:, 2],
        "roll": rows[:, 3],
        "pitch": rows[:, 4],
        "yaw": rows[:, 5],
        "vel_north": rows[:, 6],
        "vel_east": rows[:, 7],
        "accel_xyz": rows[:, 11:14],
        "gyro_xyz": rows[:, 17:20],
        "pos_accuracy": rows[:, 23],
    }
