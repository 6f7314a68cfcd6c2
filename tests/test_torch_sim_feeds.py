"""The port's simulator (``fastliosam_tpu_torch/sim/world.py``) against the
JAX package's (``fastliosam_tpu/sim/world.py: raycast``,
``simulate_sequence``), bit for bit, at the feeds ``chip_smoke.py`` makes:
the figure-8 loop feed, the GPS corridor, the KITTI circuit of
``make_kitti_synth`` and the OS1-64 recording of ``sim/writers.py``, a few
scans each at their full ray counts and at two points of each path.

The port casts each time group only against the rectangles its rays can
reach (``PlaneWorld._reachable``); the other rectangles give every ray
``t = inf``, so the nearest hits, and every output array, must equal the
dense cast's exactly. The accuracy references of chip_smoke's engine
phases rest on these feeds.
"""
import numpy as np
import pytest

from fastliosam_tpu.sim import world as jworld
from fastliosam_tpu_torch.io.presets import PRESETS
from fastliosam_tpu_torch.scripts.make_kitti_synth import _scenario
from fastliosam_tpu_torch.sim import world as tworld
from fastliosam_tpu_torch.sim import writers

FIG8_WORLD = ("room", dict(size=60.0, height=10.0, n_boxes=25, seed=11))
CORRIDOR_WORLD = ("corridor", dict(length=400.0, width=8.0, height=5.0, n_clutter=8,
                                   clutter_span=15.0, seed=3))
FIG8_SIM = dict(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0, gyro_noise=0.001,
                acc_noise=0.01, seed=11, time_groups=32)
CORRIDOR_SIM = dict(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=60.0,
                    gyro_noise=0.001, acc_noise=0.01, acc_bias=(0.08, -0.03, 0.04), seed=3,
                    time_groups=32, gps_rate=10.0, gps_noise=0.3)


def _feed(name):
    """(port world, JAX world, trajectory, sim kwargs) of a chip_smoke feed;
    the trajectory (numpy only) serves both simulators."""
    if name == "kitti":
        world, traj, cfg = _scenario(2048, 16, 50.0, 0, False)
        kw = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
        return world, jworld.PlaneWorld(world.centers, world.us, world.vs), traj, kw
    if name == "os1_64":
        pre = PRESETS["newer-college2020"]
        traj = writers.from_rest(tworld.Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2),
                                 start=1.5)
        kw = dict(scan_rate=10.0, imu_rate=100.0, n_azimuth=1024, n_elev=64,
                  elev_fov=writers.OS1_64_ELEV_FOV, max_range=120.0, gyro_noise=0.001,
                  acc_noise=0.01, seed=11, time_groups=None, gps_rate=10.0,
                  lidar_R=np.asarray(pre.extrinsic_R, np.float64).reshape(3, 3),
                  lidar_t=np.asarray(pre.extrinsic_T, np.float64))
        ctor, wkw = FIG8_WORLD
    elif name == "figure8":
        (ctor, wkw), kw = FIG8_WORLD, FIG8_SIM
        traj = tworld.Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
    else:
        (ctor, wkw), kw = CORRIDOR_WORLD, CORRIDOR_SIM
        traj = tworld.Trajectory.straight(speed=6.0)
    return (getattr(tworld.PlaneWorld, ctor)(**wkw), getattr(jworld.PlaneWorld, ctor)(**wkw),
            traj, kw)


def _assert_same(a, b):
    for (pa, ta, ma), (pb, tb, mb) in zip(a["scans"], b["scans"]):
        for x, y in ((pa, pb), (ta, tb), (ma, mb)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a["imu"], b["imu"]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    for (ra, pa), (rb, pb) in zip(a["gt"], b["gt"]):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a["stamps"], b["stamps"])
    assert len(a["gps"]) == len(b["gps"])
    for x, y in zip(a["gps"], b["gps"]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name,t0,n_scans", [
    ("figure8", 0.0, 2), ("figure8", 4.3, 2), ("corridor", 0.0, 2), ("corridor", 19.0, 2),
    ("kitti", 0.0, 1), ("kitti", 61.7, 1), ("os1_64", 0.0, 1)])
def test_simulate_sequence_bit_for_bit_with_jax(name, t0, n_scans):
    tw, jw, traj, kw = _feed(name)
    port = tworld.simulate_sequence(tw, traj, tworld.SimConfig(**kw), n_scans=n_scans, t0=t0)
    ref = jworld.simulate_sequence(jw, traj, jworld.SimConfig(**kw), n_scans=n_scans, t0=t0)
    _assert_same(port, ref)
    assert np.mean(port["scans"][0][2]) > 0.5  # the scan hits the world


@pytest.mark.parametrize("spread", [0.05, 0.6, np.pi])
def test_raycast_bit_for_bit_with_jax(spread):
    """Random groups of rays from one origin (cones of half-angle up to
    ``spread`` about a random axis, a full sphere at pi) and rays from
    different origins, inside each world: the culled cast equals the dense
    one in every bit."""
    rng = np.random.default_rng(7)
    for name in ("figure8", "corridor", "kitti"):
        tw, jw, _, _ = _feed(name)
        lo, hi = tw.centers.min(axis=0), tw.centers.max(axis=0)
        for _ in range(12):
            o = rng.uniform(lo, hi)
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            d = axis + rng.normal(size=(512, 3)) * spread
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            for origins in (np.broadcast_to(o, d.shape), o + rng.normal(size=d.shape)):
                a = tw.raycast(origins, d, 80.0)
                b = jw.raycast(origins, d, 80.0)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])


def test_reachable_culls_most_rectangles():
    """The culling does its work: a figure-8 time group reaches a minority
    of the room's 116 rectangles."""
    tw, _, traj, kw = _feed("figure8")
    cfg = tworld.SimConfig(**kw)
    dirs, t_frac = tworld._ray_dirs(cfg)
    sel = np.floor(t_frac * 32) == 5
    R, p = traj.pose(1.0)
    d = dirs[sel] @ R.T
    keep = tw._reachable(np.broadcast_to(p, d.shape), d)
    assert 0 < len(keep) < len(tw.centers) // 2
