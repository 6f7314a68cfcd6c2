"""Sensor recording + telemetry: the `sensor_recorder.cpp` capability.

Consumes a message stream (a rosbag via `io.rosbag.BagReader`, or any
iterator of decoded messages) and writes the reference recorder's on-disk
layout (`sensor_recorder.cpp:117-137,269-319`):

  <out>/images/<ts>.jpg        undistorted camera frames (HKT naming)
  <out>/clouds/<ts>.pcd|.bin   LiDAR scans
  <out>/imu.txt                stamp wx wy wz ax ay az
  <out>/gnss.txt               stamp lat lon alt cov...
  <out>/telemetry.jsonl        1 Hz GNSS+IMU JSON status records

Telemetry upload (`sensor_recorder.cpp:353-472` HTTP POST / WebSocket to
the Kodifly backend) is represented by a pluggable ``sink`` callable; the
default appends JSON lines locally (this environment is zero-egress — a
network sink would wrap `urllib`/`websockets` with the same payloads).

The port's own copy of ``fastliosam_tpu/runtime/recorder.py`` (numpy and
the stdlib; OpenCV only for camera frames, where it is installed).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import datetime, timezone, timedelta
from typing import Callable, Optional

import numpy as np

HKT = timezone(timedelta(hours=8))


def hkt_stamp_name(stamp: float) -> str:
    """Timestamp filename in HKT, yyyymmdd_HHMMSS_mmm (reference
    `ts_to_str`, `post_process/extraction.py:25`)."""
    dt = datetime.fromtimestamp(stamp, tz=HKT)
    return dt.strftime("%Y%m%d_%H%M%S_") + f"{int(dt.microsecond / 1000):03d}"


@dataclass
class RecorderConfig:
    out_dir: str = "recording"
    save_images: bool = True
    save_clouds: bool = True
    cloud_format: str = "pcd"  # or "bin"
    undistort: bool = True
    telemetry_period: float = 1.0
    image_topic: str = "/camera/compressed"
    lidar_topic: str = "/points"
    imu_topic: str = "/imu"
    gps_topic: str = "/gps/fix"


class SensorRecorder:
    """Stream consumer that persists sensor data + emits telemetry."""

    def __init__(
        self,
        cfg: RecorderConfig,
        camera=None,  # postprocess.images.CameraModel for undistortion
        telemetry_sink: Optional[Callable[[dict], None]] = None,
    ):
        self.cfg = cfg
        self.camera = camera
        os.makedirs(os.path.join(cfg.out_dir, "images"), exist_ok=True)
        os.makedirs(os.path.join(cfg.out_dir, "clouds"), exist_ok=True)
        self._imu_f = open(os.path.join(cfg.out_dir, "imu.txt"), "w")
        self._gnss_f = open(os.path.join(cfg.out_dir, "gnss.txt"), "w")
        self._telemetry_path = os.path.join(cfg.out_dir, "telemetry.jsonl")
        self._sink = telemetry_sink or self._default_sink
        self._last_telemetry = -np.inf
        self._last_gps: Optional[dict] = None
        self._last_imu: Optional[dict] = None
        self.counts = {"images": 0, "clouds": 0, "imu": 0, "gnss": 0,
                       "telemetry": 0}

    def _default_sink(self, payload: dict):
        with open(self._telemetry_path, "a") as f:
            f.write(json.dumps(payload) + "\n")

    # ------------------------------------------------------------------
    def consume_bag(self, bag_path: str):
        from ..io.rosbag import BagReader, DECODERS

        for msg in BagReader(bag_path):
            decoder = DECODERS.get(msg.msg_type)
            if decoder is None:
                continue
            if msg.topic == self.cfg.imu_topic:
                self.on_imu(msg.stamp, decoder(msg.raw))
            elif msg.topic == self.cfg.gps_topic:
                self.on_gps(msg.stamp, decoder(msg.raw))
            elif msg.topic == self.cfg.lidar_topic:
                cloud, _ = decoder(msg.raw)
                self.on_cloud(msg.stamp, cloud)
            elif msg.topic == self.cfg.image_topic:
                self.on_image(msg.stamp, decoder(msg.raw))
        self.flush()

    # ------------------------------------------------------------------
    def on_imu(self, stamp: float, imu: dict):
        g = imu["angular_velocity"]
        a = imu["linear_acceleration"]
        self._imu_f.write(
            f"{stamp:.6f} {g[0]:.6f} {g[1]:.6f} {g[2]:.6f} "
            f"{a[0]:.6f} {a[1]:.6f} {a[2]:.6f}\n"
        )
        self.counts["imu"] += 1
        self._last_imu = {
            "gyro": [float(x) for x in g],
            "accel": [float(x) for x in a],
        }
        self._maybe_telemetry(stamp)

    def on_gps(self, stamp: float, fix: dict):
        cov = np.diag(fix["position_covariance"])
        self._gnss_f.write(
            f"{stamp:.6f} {fix['latitude']:.8f} {fix['longitude']:.8f} "
            f"{fix['altitude']:.3f} {cov[0]:.3f} {cov[1]:.3f} {cov[2]:.3f}\n"
        )
        self.counts["gnss"] += 1
        self._last_gps = {
            "lat": fix["latitude"], "lon": fix["longitude"],
            "alt": fix["altitude"], "status": int(fix.get("status", 0)),
        }
        self._maybe_telemetry(stamp)

    def on_cloud(self, stamp: float, cloud: np.ndarray):
        if not self.cfg.save_clouds:
            return
        name = hkt_stamp_name(stamp)
        path = os.path.join(self.cfg.out_dir, "clouds", name)
        if self.cfg.cloud_format == "bin":
            names = cloud.dtype.names or ()
            inten = (
                cloud["intensity"].astype(np.float32)
                if "intensity" in names
                else np.zeros(len(cloud), np.float32)
            )
            arr = np.column_stack(
                [
                    cloud["x"].astype(np.float32),
                    cloud["y"].astype(np.float32),
                    cloud["z"].astype(np.float32),
                    inten,
                ]
            )
            arr.tofile(path + ".bin")
        else:
            from ..io.pcd import write_pcd

            write_pcd(path + ".pcd", cloud)
        self.counts["clouds"] += 1

    def on_image(self, stamp: float, msg: dict):
        if not self.cfg.save_images:
            return
        from ..postprocess.images import HAS_CV2, decode_compressed

        if not HAS_CV2:
            return
        import cv2

        img = decode_compressed(msg["data"])
        if img is None:
            return
        if self.cfg.undistort and self.camera is not None:
            img = self.camera.undistort(img)
        name = hkt_stamp_name(stamp) + ".jpg"
        cv2.imwrite(os.path.join(self.cfg.out_dir, "images", name), img)
        self.counts["images"] += 1

    # ------------------------------------------------------------------
    def _maybe_telemetry(self, stamp: float):
        if stamp - self._last_telemetry < self.cfg.telemetry_period:
            return
        self._last_telemetry = stamp
        payload = {
            "timestamp": stamp,
            "gnss": self._last_gps,
            "imu": self._last_imu,
            "counts": dict(self.counts),
        }
        self._sink(payload)
        self.counts["telemetry"] += 1

    def flush(self):
        self._imu_f.flush()
        self._gnss_f.flush()

    def close(self):
        self._imu_f.close()
        self._gnss_f.close()
