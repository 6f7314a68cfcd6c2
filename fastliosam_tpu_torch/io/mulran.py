"""MulRan dataset reader (KAIST / Riverside / DCC sequences).

Directory layout (as distributed):
  <root>/sensor_data/Ouster/<stamp_ns>.bin   OS1-64 scans, f32 x,y,z,i
  <root>/sensor_data/xsens_imu.csv           IMU stream
  <root>/sensor_data/gps.csv                 GPS fixes (lat/lon/alt + cov)
  <root>/global_pose.csv                     ground-truth 3x4 poses

The reference runs MulRan through its `mulran.launch` FAST-LIO config
(SURVEY.md §1 L7); BASELINE.md uses KAIST-02 for the GPS-factor config and
Riverside for the multi-host config.

The port's own numpy copy of ``fastliosam_tpu/io/mulran.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _find(root, *cands):
    for c in cands:
        p = os.path.join(root, c)
        if os.path.exists(p):
            return p
    return None


@dataclass
class MulranSequence:
    root: str

    def __post_init__(self):
        ouster = _find(self.root, "sensor_data/Ouster", "Ouster")
        if ouster is None:
            raise FileNotFoundError(f"no Ouster dir under {self.root}")
        self.ouster_dir = ouster
        self.files = sorted(
            f for f in os.listdir(ouster) if f.endswith(".bin")
        )
        self.stamps = np.array(
            [int(os.path.splitext(f)[0]) * 1e-9 for f in self.files]
        )
        imu_csv = _find(self.root, "sensor_data/xsens_imu.csv", "xsens_imu.csv")
        self.imu = None
        if imu_csv:
            rows = np.loadtxt(imu_csv, delimiter=",", ndmin=2)
            # columns: stamp_ns, quat(4), rpy(3), gyro(3), accel(3), mag(3)
            self.imu = {
                "stamps": rows[:, 0] * 1e-9,
                "gyro": rows[:, 8:11],
                "accel": rows[:, 11:14],
            }
        gps_csv = _find(self.root, "sensor_data/gps.csv", "gps.csv")
        self.gps = None
        if gps_csv:
            rows = np.loadtxt(gps_csv, delimiter=",", ndmin=2)
            self.gps = {
                "stamps": rows[:, 0] * 1e-9,
                "lat": rows[:, 1],
                "lon": rows[:, 2],
                "alt": rows[:, 3],
                # 3x3 covariance flattened in cols 4:13 when present
                "cov": rows[:, 4:13] if rows.shape[1] >= 13 else None,
            }
        gt_csv = _find(self.root, "global_pose.csv")
        self.gt = None
        if gt_csv:
            rows = np.loadtxt(gt_csv, delimiter=",", ndmin=2)
            n = len(rows)
            poses = np.tile(np.eye(4), (n, 1, 1))
            poses[:, :3, :4] = rows[:, 1:13].reshape(n, 3, 4)
            self.gt = {"stamps": rows[:, 0] * 1e-9, "poses": poses}

    def __len__(self):
        return len(self.files)

    def scan(self, i: int):
        """Returns (xyz (N,3) f32, intensity (N,), t_offset (N,)).

        OS1-64 bins are column-major sweeps (1024 azimuth x 64 rings);
        per-point times are synthesized over the 0.1 s sweep.
        """
        raw = np.fromfile(
            os.path.join(self.ouster_dir, self.files[i]), dtype=np.float32
        ).reshape(-1, 4)
        xyz = raw[:, :3]
        n = len(raw)
        # azimuth-major ordering: column c covers [c/1024, (c+1)/1024) * 0.1s
        col = np.arange(n) // 64 if n % 64 == 0 else np.arange(n)
        t_off = (col / max(col.max(), 1) * 0.1).astype(np.float32)
        return xyz, raw[:, 3], t_off

    def imu_between(self, t0: float, t1: float):
        if self.imu is None:
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3))
        m = (self.imu["stamps"] > t0) & (self.imu["stamps"] <= t1)
        return self.imu["stamps"][m], self.imu["gyro"][m], self.imu["accel"][m]

    def gps_between(self, t0: float, t1: float):
        """Rows of (stamp, lat, lon, alt, cov_diag(3))."""
        if self.gps is None:
            return []
        m = (self.gps["stamps"] > t0) & (self.gps["stamps"] <= t1)
        out = []
        for i in np.nonzero(m)[0]:
            cov = (
                self.gps["cov"][i].reshape(3, 3).diagonal()
                if self.gps["cov"] is not None
                else np.array([4.0, 4.0, 16.0])
            )
            out.append(
                (
                    self.gps["stamps"][i], self.gps["lat"][i],
                    self.gps["lon"][i], self.gps["alt"][i], cov,
                )
            )
        return out
