"""Generic directory-format sequence reader.

Matches the reference recorder's on-disk layout (`sensor_recorder.cpp`
outputs, SURVEY.md §2.1): a directory with per-scan PCD (or .bin) files
named by timestamp, plus ``imu.txt`` (stamp wx wy wz ax ay az) and
``gnss.txt`` (stamp lat lon alt [cov...]) — the format family the
post_process extractors produce (`post_process/extraction.py`).

The port's own numpy copy of ``fastliosam_tpu/io/generic.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .pcd import read_pcd, xyz_of


@dataclass
class GenericSequence:
    root: str
    cloud_dir: str = "clouds"
    imu_file: str = "imu.txt"
    gnss_file: str = "gnss.txt"

    def __post_init__(self):
        cdir = os.path.join(self.root, self.cloud_dir)
        self.files = sorted(
            os.path.join(cdir, f)
            for f in os.listdir(cdir)
            if f.endswith((".pcd", ".bin"))
        )
        self.stamps = np.array(
            [float(os.path.splitext(os.path.basename(f))[0]) for f in self.files]
        )
        imu_path = os.path.join(self.root, self.imu_file)
        self.imu = np.loadtxt(imu_path, ndmin=2) if os.path.exists(imu_path) else None
        gnss_path = os.path.join(self.root, self.gnss_file)
        self.gnss = (
            np.loadtxt(gnss_path, ndmin=2) if os.path.exists(gnss_path) else None
        )

    def __len__(self):
        return len(self.files)

    def scan(self, i: int):
        path = self.files[i]
        if path.endswith(".bin"):
            raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
            return raw[:, :3], raw[:, 3]
        cloud = read_pcd(path)
        inten = (
            cloud["intensity"].astype(np.float32)
            if "intensity" in (cloud.dtype.names or ())
            else np.zeros(len(cloud), np.float32)
        )
        return xyz_of(cloud).astype(np.float32), inten

    def imu_between(self, t0: float, t1: float):
        """IMU rows with t0 < stamp <= t1: (stamps, gyro (M,3), acc (M,3))."""
        if self.imu is None:
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3))
        m = (self.imu[:, 0] > t0) & (self.imu[:, 0] <= t1)
        rows = self.imu[m]
        return rows[:, 0], rows[:, 1:4], rows[:, 4:7]

    def gnss_between(self, t0: float, t1: float):
        if self.gnss is None:
            return []
        m = (self.gnss[:, 0] > t0) & (self.gnss[:, 0] <= t1)
        return [tuple(r) for r in self.gnss[m]]
