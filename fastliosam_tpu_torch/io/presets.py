"""Per-dataset sensor presets — the `run.launch` lidar-selection surface.

The reference selects a FAST-LIO config per dataset via
`fast_lio_sam/launch/run.launch:20-46` (`lidar:=ouster|velodyne|livox|kitti|
mulran|newer-college2020|kimera-multi-*|vbr-colosseo`), each preset being a
yaml + launch pair under `third_party/fastlio_config_launch/`. This module
carries the same parameter surface as typed presets, plus a ROS1-bag
streamer that decodes each preset's topics (PointCloud2 per `lidar_type`,
Imu, NavSatFix) into engine inputs.

Preset values are the reference's vendored configs (cited per preset);
`ouster`/`velodyne`/`livox` use FAST-LIO mainline defaults since the
submodule is empty in the snapshot (`third_party/FAST_LIO/`, SURVEY.md §2.1).

The port's own numpy copy of ``fastliosam_tpu/io/presets.py``.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from .rosbag import (
    BagReader,
    decode_imu,
    decode_livox_custommsg,
    decode_navsatfix,
    decode_pointcloud2,
)

_IDENT = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
_FLIP_XY = (-1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 1.0)

# timestamp_unit contract (kitti.yaml:13): scale of the per-point time field
_TS_SCALE = {0: 1.0, 1: 1e-3, 2: 1e-6, 3: 1e-9}


class SensorPreset(NamedTuple):
    """One `fastlio_config_launch/<name>.{yaml,launch}` parameter set."""

    lid_topic: str
    imu_topic: str
    lidar_type: int  # 1=Livox CustomMsg, 2=Velodyne, 3=Ouster (kitti.yaml:9)
    timestamp_unit: int  # 0 s, 1 ms, 2 us, 3 ns (kitti.yaml:13)
    blind: float
    det_range: float
    extrinsic_T: tuple = (0.0, 0.0, 0.0)
    extrinsic_R: tuple = _IDENT
    acc_cov: float = 0.1
    gyr_cov: float = 0.1
    b_acc_cov: float = 0.0001
    b_gyr_cov: float = 0.0001
    point_filter_num: int = 4
    max_iteration: int = 3
    filter_size_surf: float = 0.5
    filter_size_map: float = 0.5
    extrinsic_est_en: bool = False
    gps_topic: str = "/gps/fix"  # PGO node subscription (fast_lio_sam.cpp:135)


PRESETS: dict[str, SensorPreset] = {
    # fastlio_config_launch/kitti.{yaml:1-27,launch:6-11}
    "kitti": SensorPreset(
        lid_topic="/kitti/velo/pointcloud", imu_topic="/kitti/oxts/imu",
        lidar_type=2, timestamp_unit=2, blind=2.0, det_range=100.0,
        extrinsic_T=(0.81, -0.32, 0.8),
    ),
    # fastlio_config_launch/mulran.{yaml,launch} (blind 4, ext T [1.77,0,-0.05],
    # R diag(-1,-1,1), point_filter_num 3)
    "mulran": SensorPreset(
        lid_topic="/os1_points", imu_topic="/imu/data_raw",
        lidar_type=3, timestamp_unit=3, blind=4.0, det_range=150.0,
        extrinsic_T=(1.77, 0.0, -0.05), extrinsic_R=_FLIP_XY,
        point_filter_num=3,
    ),
    # fastlio_config_launch/newer-college2020.{yaml,launch}
    "newer-college2020": SensorPreset(
        lid_topic="/os1_cloud_node/points", imu_topic="/os1_cloud_node/imu",
        lidar_type=3, timestamp_unit=3, blind=1.0, det_range=150.0,
        extrinsic_T=(0.0, 0.0, 0.036), extrinsic_R=_FLIP_XY,
    ),
    # fastlio_config_launch/kimera-multi.{yaml,launch} (filter sizes 0.2,
    # acl_jackal2 forward-imu extrinsics)
    "kimera-multi": SensorPreset(
        lid_topic="/acl_jackal2/lidar_points",
        imu_topic="/acl_jackal2/forward/imu",
        lidar_type=2, timestamp_unit=2, blind=0.3, det_range=100.0,
        acc_cov=0.1, gyr_cov=0.1, b_acc_cov=0.01, b_gyr_cov=0.005,
        extrinsic_T=(0.07025405, -0.10158666, -0.04942693),
        extrinsic_R=(
            -2.9046527369e-02, -9.9957706196e-01, -1.7154151723e-03,
            -6.9278006858e-02, 3.7251435690e-03, -9.9759064383e-01,
            9.9717458733e-01, -2.8857692625e-02, -6.9356874944e-02,
        ),
        filter_size_surf=0.2, filter_size_map=0.2,
    ),
    # run.launch:38-43 selects per-robot kimera-multi variants
    # (kimera-multi-acl_jackal2 / kimera-multi-apis); only the acl_jackal2
    # yaml is vendored (fastlio_config_launch/kimera-multi.yaml), so the
    # apis variant reuses those calibration params with the robot's topics.
    "kimera-multi-acl_jackal2": SensorPreset(
        lid_topic="/acl_jackal2/lidar_points",
        imu_topic="/acl_jackal2/forward/imu",
        lidar_type=2, timestamp_unit=2, blind=0.3, det_range=100.0,
        acc_cov=0.1, gyr_cov=0.1, b_acc_cov=0.01, b_gyr_cov=0.005,
        extrinsic_T=(0.07025405, -0.10158666, -0.04942693),
        extrinsic_R=(
            -2.9046527369e-02, -9.9957706196e-01, -1.7154151723e-03,
            -6.9278006858e-02, 3.7251435690e-03, -9.9759064383e-01,
            9.9717458733e-01, -2.8857692625e-02, -6.9356874944e-02,
        ),
        filter_size_surf=0.2, filter_size_map=0.2,
    ),
    "kimera-multi-apis": SensorPreset(
        lid_topic="/apis/lidar_points",
        imu_topic="/apis/forward/imu",
        lidar_type=2, timestamp_unit=2, blind=0.3, det_range=100.0,
        acc_cov=0.1, gyr_cov=0.1, b_acc_cov=0.01, b_gyr_cov=0.005,
        extrinsic_T=(0.07025405, -0.10158666, -0.04942693),
        extrinsic_R=(
            -2.9046527369e-02, -9.9957706196e-01, -1.7154151723e-03,
            -6.9278006858e-02, 3.7251435690e-03, -9.9759064383e-01,
            9.9717458733e-01, -2.8857692625e-02, -6.9356874944e-02,
        ),
        filter_size_surf=0.2, filter_size_map=0.2,
    ),
    # fastlio_config_launch/vbr-colosseo.{yaml,launch}
    "vbr-colosseo": SensorPreset(
        lid_topic="/ouster/points", imu_topic="/imu/data",
        lidar_type=3, timestamp_unit=3, blind=0.3, det_range=100.0,
        acc_cov=0.01, gyr_cov=0.001, b_acc_cov=0.001, b_gyr_cov=0.0005,
        extrinsic_T=(0.04943289, 0.01478779, 0.60798871),
        extrinsic_R=(
            0.99946541, -0.03200262, 0.00670301,
            0.03194165, 0.99944911, 0.009017,
            -0.0069879, -0.00879813, 0.99993691,
        ),
    ),
    # run.launch:21-29 generic sensor modes — FAST-LIO mainline defaults
    # (mapping_ouster128 / mapping_velodyne / mapping_avia; submodule empty)
    "ouster": SensorPreset(
        lid_topic="/ouster/points", imu_topic="/ouster/imu",
        lidar_type=3, timestamp_unit=3, blind=1.0, det_range=150.0,
    ),
    "velodyne": SensorPreset(
        lid_topic="/velodyne_points", imu_topic="/imu/data",
        lidar_type=2, timestamp_unit=0, blind=2.0, det_range=100.0,
        point_filter_num=2,
    ),
    "livox": SensorPreset(
        lid_topic="/livox/lidar", imu_topic="/livox/imu",
        lidar_type=1, timestamp_unit=3, blind=0.5, det_range=450.0,
        acc_cov=0.1, gyr_cov=0.1, b_acc_cov=0.0001, b_gyr_cov=0.0001,
        point_filter_num=3, filter_size_surf=0.5, filter_size_map=0.5,
    ),
}


def time_offsets_from_fields(arr: np.ndarray, timestamp_unit: int):
    """Per-point time offsets (seconds, relative to sweep start) from a
    PointCloud2 structured array — the FAST-LIO preprocess contract of
    reading `time`/`t`/`timestamp` scaled by `timestamp_unit`
    (kitti.yaml:13). Returns zeros when no time field exists."""
    names = arr.dtype.names or ()
    for cand in ("t", "time", "timestamp", "time_offset", "ts"):
        if cand in names:
            raw = arr[cand].astype(np.float64)
            raw = raw - raw.min() if len(raw) else raw
            scale = _TS_SCALE.get(timestamp_unit, 1.0)
            off = raw * scale
            # absolute-epoch fields (already seconds) still normalize to
            # sweep-relative via the min subtraction above
            return off.astype(np.float32)
    return np.zeros(len(arr), np.float32)


class BagSequence:
    """Stream a ROS1 bag through a :class:`SensorPreset`.

    Yields ``("imu", stamp, (gyro, accel))``, ``("gps", stamp, (lat, lon,
    alt, cov_diag))`` and ``("scan", stamp, (xyz, intensity, t_offset))``
    events in bag order — the dataset-iteration replacement for the
    reference's topic subscriptions (`fast_lio_sam.cpp:130-135`).
    """

    def __init__(self, path: str, preset: SensorPreset):
        self.path = path
        self.preset = preset

    def stream(self) -> Iterator[tuple]:
        pre = self.preset
        for msg in BagReader(self.path):
            if msg.topic == pre.imu_topic and msg.msg_type.endswith("Imu"):
                d = decode_imu(msg.raw)
                yield "imu", msg.stamp, (
                    np.asarray(d["angular_velocity"], np.float32),
                    np.asarray(d["linear_acceleration"], np.float32),
                )
            elif msg.topic == pre.gps_topic and msg.msg_type.endswith(
                "NavSatFix"
            ):
                d = decode_navsatfix(msg.raw)
                yield "gps", msg.stamp, (
                    d["latitude"], d["longitude"], d["altitude"],
                    tuple(np.asarray(d["position_covariance"]).diagonal()),
                    d["status"],
                )
            elif msg.topic == pre.lid_topic:
                if pre.lidar_type == 1 and "CustomMsg" in msg.msg_type:
                    d = decode_livox_custommsg(msg.raw)
                    pts = d["points"]
                    xyz = np.stack(
                        [pts["x"], pts["y"], pts["z"]], axis=-1
                    ).astype(np.float32)
                    inten = pts["reflectivity"].astype(np.float32)
                    toff = pts["offset_time"].astype(np.float64) * 1e-9
                    yield "scan", msg.stamp, (xyz, inten,
                                              toff.astype(np.float32))
                elif msg.msg_type.endswith("PointCloud2"):
                    arr, hdr = decode_pointcloud2(msg.raw)
                    names = arr.dtype.names or ()
                    if not {"x", "y", "z"}.issubset(names):
                        continue
                    xyz = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=-1
                    ).astype(np.float32)
                    inten = (
                        arr["intensity"].astype(np.float32)
                        if "intensity" in names
                        else np.zeros(len(arr), np.float32)
                    )
                    toff = time_offsets_from_fields(arr, pre.timestamp_unit)
                    yield "scan", msg.stamp, (xyz, inten, toff)


def odom_config_kwargs(pre: SensorPreset) -> dict:
    """Preset → :class:`~fastliosam_tpu_torch.odom.OdomConfig` kwargs (the launch
    parameter pass-through, `kitti.launch:6-11`)."""
    return dict(
        acc_cov=pre.acc_cov,
        gyr_cov=pre.gyr_cov,
        b_acc_cov=pre.b_acc_cov,
        b_gyr_cov=pre.b_gyr_cov,
        blind=pre.blind,
        det_range=pre.det_range,
        point_filter_num=pre.point_filter_num,
        max_iteration=pre.max_iteration,
        filter_size_surf=pre.filter_size_surf,
        extrinsic_T=pre.extrinsic_T,
        extrinsic_R=pre.extrinsic_R,
        extrinsic_est_en=pre.extrinsic_est_en,
    )
