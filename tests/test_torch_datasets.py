"""The port's dataset readers against the JAX package's on the same files:
``MulranSequence``, ``NewerCollegeSequence`` (ground truth included),
``BagSequence`` for every sensor preset and for PointCloud2 time fields in
each ``timestamp_unit``, and ``odom_config_kwargs``. The recordings are
written by ``sim/writers.py`` from a small simulated run. Everything is
compared exactly: both sides are numpy and the stdlib.
"""
import numpy as np
import pytest

from fastliosam_tpu.io import mulran as jmulran
from fastliosam_tpu.io import newer_college as jnc
from fastliosam_tpu.io import presets as jpresets
from fastliosam_tpu.odom import OdomConfig as JOdomConfig
from fastliosam_tpu_torch.io import mulran as tmulran
from fastliosam_tpu_torch.io import newer_college as tnc
from fastliosam_tpu_torch.io import presets as tpresets
from fastliosam_tpu_torch.io.rosbag import BagWriter, encode_imu, encode_pointcloud2
from fastliosam_tpu_torch.odom import OdomConfig as TOdomConfig
from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence
from fastliosam_tpu_torch.sim import writers
from tests.test_torch_rosbag import _same

N_AZIMUTH, N_RINGS, N_SCANS = 64, 16, 6


def _data(preset, **sim_kw):
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=6, seed=2)
    traj = writers.from_rest(Trajectory.circle(radius=5.0, period=20.0), rest=0.2, ramp=0.3)
    cfg = SimConfig(n_azimuth=N_AZIMUTH, n_elev=N_RINGS, elev_fov=writers.OS1_64_ELEV_FOV,
                    imu_rate=100.0, seed=2, time_groups=16, gps_rate=10.0,
                    lidar_R=np.asarray(preset.extrinsic_R).reshape(3, 3),
                    lidar_t=np.asarray(preset.extrinsic_T), **sim_kw)
    return simulate_sequence(world, traj, cfg, n_scans=N_SCANS)


def _attrs(seq):
    return {k: v for k, v in vars(seq).items()}


def test_mulran_sequence_equal(tmp_path):
    pre = tpresets.PRESETS["mulran"]
    root = writers.write_mulran(str(tmp_path / "kaist"), _data(pre), N_AZIMUTH, N_RINGS,
                                pre.extrinsic_R, pre.extrinsic_T)
    j, t = jmulran.MulranSequence(root), tmulran.MulranSequence(root)
    _same(_attrs(t), _attrs(j))
    assert len(t) == len(j) == N_SCANS and t.gps["cov"] is not None
    for i in range(N_SCANS):
        _same(t.scan(i), j.scan(i))
    for t0 in t.stamps[:-1]:
        _same(t.imu_between(t0 - 0.05, t0 + 0.1), j.imu_between(t0 - 0.05, t0 + 0.1))
        _same(t.gps_between(t0 - 0.05, t0 + 0.25), j.gps_between(t0 - 0.05, t0 + 0.25))
    assert t.gps_between(t.stamps[0] - 1, t.stamps[-1])


def test_mulran_sequence_equal_without_covariance_or_imu(tmp_path):
    """A gps.csv of stamp, lat, lon, alt only (the reader's default
    covariance), no IMU file, no ground truth; the files in the root."""
    pre = tpresets.PRESETS["mulran"]
    src = writers.write_mulran(str(tmp_path / "src"), _data(pre), N_AZIMUTH, N_RINGS,
                               pre.extrinsic_R, pre.extrinsic_T)
    root = tmp_path / "flat"
    (root / "Ouster").mkdir(parents=True)
    for f in (tmp_path / "src" / "sensor_data" / "Ouster").iterdir():
        (root / "Ouster" / f.name).write_bytes(f.read_bytes())
    rows = np.loadtxt(f"{src}/sensor_data/gps.csv", delimiter=",", ndmin=2)[:, :4]
    np.savetxt(root / "gps.csv", rows, delimiter=",", fmt=["%d", "%.9f", "%.9f", "%.4f"])
    j, t = jmulran.MulranSequence(str(root)), tmulran.MulranSequence(str(root))
    _same(_attrs(t), _attrs(j))
    assert t.imu is None and t.gt is None and t.gps["cov"] is None
    _same(t.imu_between(0.0, 1e12), j.imu_between(0.0, 1e12))
    _same(t.gps_between(0.0, 1e12), j.gps_between(0.0, 1e12))
    with pytest.raises(FileNotFoundError):
        tmulran.MulranSequence(str(tmp_path))


def test_newer_college_sequence_equal(tmp_path):
    pre = tpresets.PRESETS["newer-college2020"]
    data = _data(pre)
    bags = tmp_path / "bags"
    bags.mkdir()
    writers.write_bag(str(bags / "a.bag"), data, pre, N_AZIMUTH, N_RINGS, n_scans=3)
    writers.write_bag(str(bags / "b.bag"), data, pre, N_AZIMUTH, N_RINGS)
    gt = writers.write_gt_csv(str(tmp_path / "registered_poses.csv"), data)
    for src in (str(bags), str(bags / "b.bag")):
        j = jnc.NewerCollegeSequence(bags=src, gt_csv=gt)
        t = tnc.NewerCollegeSequence(bags=src, gt_csv=gt)
        _same(_attrs(t), _attrs(j))
        events = list(t.stream())
        _same(events, list(j.stream()))
        assert sum(e[0] == "scan" for e in events) == (3 + N_SCANS if src == str(bags)
                                                       else N_SCANS)
    np.testing.assert_allclose(t.gt["poses"][:, :3, 3], np.stack([g[1] for g in data["gt"]]),
                               atol=1e-8)
    np.testing.assert_allclose(t.gt["poses"][:, :3, :3], np.stack([g[0] for g in data["gt"]]),
                               atol=1e-8)


def test_presets_equal():
    assert list(tpresets.PRESETS) == list(jpresets.PRESETS)
    for name, pre in tpresets.PRESETS.items():
        assert tuple(pre) == tuple(jpresets.PRESETS[name]), name
        assert pre._fields == jpresets.PRESETS[name]._fields


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_bag_sequence_equal(name, tmp_path):
    """A recording on the preset's topics as its driver publishes it
    (Livox ``CustomMsg`` for ``lidar_type`` 1, PointCloud2 with ns point
    times otherwise), IMU and GPS fixes, streamed through both packages'
    ``BagSequence``; plus a scan on another topic and a PointCloud2
    without xyz, which both skip."""
    pre = tpresets.PRESETS[name]
    sim_kw = dict(pattern="livox", livox_n_points=512) if pre.lidar_type == 1 else {}
    data = _data(pre, **sim_kw)
    path = str(tmp_path / "run.bag")
    if pre.timestamp_unit == 3 or pre.lidar_type == 1:
        writers.write_bag(path, data, pre, N_AZIMUTH, N_RINGS, gps_period=0.2)
    else:  # the sensor's unit: a float "time" field in seconds or a u32 in us
        with BagWriter(path) as w:
            for k, (pts, toff, hits) in enumerate(data["scans"]):
                cloud = writers.spinning_cloud(pts, toff, hits, N_AZIMUTH, N_RINGS)
                t_s = cloud["t"] * 1e-9
                if pre.timestamp_unit == 0:
                    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("time", "<f4")]
                    value = t_s
                else:
                    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
                          ("timestamp", "<u4")]
                    value = np.round(t_s / {1: 1e-3, 2: 1e-6}[pre.timestamp_unit])
                rec = np.zeros(len(cloud), dt)
                for f in rec.dtype.names[:-1]:
                    rec[f] = cloud[f]
                rec[rec.dtype.names[-1]] = value
                stamp = 1000.0 + 0.1 * (k + 1)
                w.write(pre.lid_topic, "sensor_msgs/PointCloud2", stamp,
                        encode_pointcloud2(rec, stamp - 0.1))
                for j, (g, a) in enumerate(zip(data["imu"][k][1], data["imu"][k][2])):
                    ts = stamp - 0.1 + 0.01 * j
                    w.write(pre.imu_topic, "sensor_msgs/Imu", ts, encode_imu(ts, g, a))
            w.write("/other/points", "sensor_msgs/PointCloud2", 1000.05,
                    encode_pointcloud2(rec, 1000.05))
            w.write(pre.lid_topic, "sensor_msgs/PointCloud2", 1000.06,
                    encode_pointcloud2(np.zeros(4, [("a", "<f4")]), 1000.06))
    j_events = list(jpresets.BagSequence(path, jpresets.PRESETS[name]).stream())
    t_events = list(tpresets.BagSequence(path, pre).stream())
    _same(t_events, j_events)
    kinds = [e[0] for e in t_events]
    assert kinds.count("scan") == N_SCANS and kinds.count("imu") == 10 * N_SCANS
    assert float(t_events[kinds.index("scan")][2][2].max()) > 0.05  # sweep times read


TIME_FIELDS = {  # timestamp_unit -> fields of the time of a point 0..0.1 s
    0: [("time", "<f4", 1.0), ("t", "<f8", 1.0), ("timestamp", "<f8", 1.0)],
    1: [("ts", "<f4", 1e3), ("time_offset", "<u4", 1e3)],
    2: [("time", "<f4", 1e6), ("t", "<u4", 1e6)],
    3: [("t", "<u4", 1e9), ("timestamp", "<f8", 1e9)],
}


@pytest.mark.parametrize("unit", sorted(TIME_FIELDS))
def test_time_fields_equal(unit, tmp_path, rng):
    """``time_offsets_from_fields`` and ``BagSequence`` on PointCloud2 time
    fields in each ``timestamp_unit``, with an absolute-epoch field too
    (the minimum is subtracted) and a cloud without one (zeros)."""
    pre = tpresets.PRESETS["velodyne"]._replace(timestamp_unit=unit)
    path = str(tmp_path / "t.bag")
    with BagWriter(path) as w:
        for k, (name, fmt, scale) in enumerate(TIME_FIELDS[unit] + [("ring", "<u2", 1.0)]):
            rec = np.zeros(200, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), (name, fmt)])
            for f in ("x", "y", "z"):
                rec[f] = rng.normal(size=200) * 10
            t = np.sort(rng.uniform(0, 0.1, 200)) + (1.7e9 if fmt == "<f8" else 0.0)
            rec[name] = np.round(t * scale) if fmt[1] == "u" else t * scale
            _same(tpresets.time_offsets_from_fields(rec, unit),
                  jpresets.time_offsets_from_fields(rec, unit))
            w.write(pre.lid_topic, "sensor_msgs/PointCloud2", 500.0 + k,
                    encode_pointcloud2(rec, 500.0 + k))
    t_events = list(tpresets.BagSequence(path, pre).stream())
    _same(t_events, list(jpresets.BagSequence(path, jpresets.PRESETS["velodyne"]._replace(
        timestamp_unit=unit)).stream()))
    offsets = [e[2][2] for e in t_events]
    assert len(offsets) == len(TIME_FIELDS[unit]) + 1
    assert all(0.09 < float(o.max()) <= 0.1001 for o in offsets[:-1])
    assert not offsets[-1].any()  # "ring" is no time field


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_odom_config_kwargs_equal(name):
    kw = tpresets.odom_config_kwargs(tpresets.PRESETS[name])
    assert kw == jpresets.odom_config_kwargs(jpresets.PRESETS[name])
    t, j = TOdomConfig(**kw), JOdomConfig(**kw)
    assert set(t._fields) <= set(j._fields)
    assert all(getattr(t, f) == getattr(j, f) for f in t._fields)
    R = t.ext_R().numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
    np.testing.assert_array_equal(R, np.asarray(j.ext_R()))
