"""The port's relocalization (``fastliosam_tpu_torch/runtime/localizer.py``)
against the JAX package's on the same keyframe bundle: a map built from
12 keyframes of the room feed of ``tests/test_localizer.py`` (256 x 10
rays, 2^14 slots), queried by a later stretch of the same circle.

Tolerances and why:
  * ``build_map_from_keyframes``: the same world points (the bundle is
    transformed by the same numpy code) inserted in 4096-point batches:
    fingerprints and voxel coordinates exact, moments rtol 1e-5 with atol
    1e-6 (sums of up to a few hundred points, each rounded in its own
    order; near-zero sums of offsets need the absolute floor).
  * ``occupied_centroids``: exact where the moments are, within 1e-5.
  * ``global_init``: the ICP's pose within 1e-3 (40 iterations of
    trimmed nearest neighbours over identical targets), fitness within 1%.
  * 10 ``process`` steps from the same initial state: positions within
    1 cm and the same matched counts within 2%, the odometry tolerance of
    ``tests/test_torch_odom.py`` (float32 rounding decides a handful of
    boundary points per scan).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import map as jmap  # noqa: E402
from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from fastliosam_tpu_torch import map as tmap  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch import runtime as trt  # noqa: E402

from _torch_parity import N, T  # noqa: E402

MAP = dict(capacity=1 << 14, voxel_size=0.4, min_points=4)
ODOM = dict(point_filter_num=1, blind=0.5, filter_size_surf=0.3, num_ds_points=1024)
P = 2048  # points per keyframe cloud


@pytest.fixture(scope="module")
def world():
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=10, seed=1)
    traj = Trajectory.circle(radius=8.0, period=16.0)
    cfg = SimConfig(scan_rate=5.0, n_azimuth=256, n_elev=10, gyro_noise=0.001,
                    acc_noise=0.01, gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=3)
    return world, traj, cfg


@pytest.fixture(scope="module")
def bundle(world, tmp_path_factory):
    """A keyframe bundle as save_results writes it: ground-truth poses and
    body-frame clouds of 12 scans over 0.6 of a lap."""
    w, traj, cfg = world
    data = simulate_sequence(w, traj, cfg, n_scans=48)
    rng = np.random.default_rng(0)
    poses, clouds, masks, stamps = [], [], [], []
    for k in range(0, 48, 4):
        pts, _, hit = data["scans"][k]
        keep = rng.permutation(np.nonzero(hit)[0])[:P]
        cl = np.zeros((P, 3), np.float32)
        cl[: len(keep)] = pts[keep]
        R, p = data["gt"][k]
        Tk = np.eye(4, dtype=np.float32)
        Tk[:3, :3], Tk[:3, 3] = R, p
        poses.append(Tk)
        clouds.append(cl)
        masks.append(np.arange(P) < len(keep))
        stamps.append(data["stamps"][k])
    path = str(tmp_path_factory.mktemp("bundle") / "seq_keyframes.npz")
    np.savez_compressed(path, poses=np.stack(poses), stamps=np.asarray(stamps, np.float32),
                        clouds=np.stack(clouds), masks=np.stack(masks))
    return path


def test_build_map_from_keyframes_matches_jax(bundle):
    jm = jrt.build_map_from_keyframes(bundle, jmap.VoxelMapConfig(**MAP), batch=4096)
    tm = trt.build_map_from_keyframes(bundle, tmap.VoxelMapConfig(**MAP), batch=4096,
                                      device="cpu")
    np.testing.assert_array_equal(N(tm.fp), N(jm.fp))
    np.testing.assert_array_equal(N(tm.coords), N(jm.coords))
    np.testing.assert_allclose(N(tm.moments), N(jm.moments), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(N(tm.plane_valid), N(jm.plane_valid))
    assert int((N(tm.fp) != 0).sum()) > 2000
    jc, jo = jmap.occupied_centroids(jm, jmap.VoxelMapConfig(**MAP))
    tc, to = tmap.occupied_centroids(tm, tmap.VoxelMapConfig(**MAP))
    np.testing.assert_array_equal(N(to), N(jo))
    np.testing.assert_allclose(N(tc), N(jc), rtol=0, atol=1e-5)


def _query(world, n=11):
    """A later stretch of the circle (the mapped lap's third quarter)."""
    w, traj, cfg = world
    return simulate_sequence(w, traj, cfg, n_scans=n, t0=7.0), traj


def _imu(data, k, cap=64):
    ts, gy, ac = data["imu"][k]
    n = len(ts)
    return (np.pad(ts, (0, cap - n), constant_values=1e9).astype(np.float32),
            np.pad(gy, ((0, cap - n), (0, 0))).astype(np.float32),
            np.pad(ac, ((0, cap - n), (0, 0))).astype(np.float32), np.arange(cap) < n)


@pytest.fixture(scope="module")
def localized(world, bundle):
    """Both localizers: global init from a perturbed guess, then 10 steps."""
    data, traj = _query(world)
    R0, p0 = traj.pose(7.0 + 0.2)  # the end of the query's first scan
    yaw = np.deg2rad(3.0)
    dR = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    guess = np.eye(4, dtype=np.float32)
    guess[:3, :3] = dR @ R0
    guess[:3, 3] = p0 + np.array([0.4, -0.3, 0.1])
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            loc = jrt.MapLocalizer(bundle, map_cfg=jmap.VoxelMapConfig(**MAP),
                                   odom_cfg=jodom.OdomConfig(**ODOM))
            mk_scan, mk_imu, arr = jodom.Scan, jodom.ImuBatch, jnp.asarray
        else:
            loc = trt.MapLocalizer(bundle, map_cfg=tmap.VoxelMapConfig(**MAP),
                                   odom_cfg=todom.OdomConfig(**ODOM), device="cpu")
            mk_scan, mk_imu, arr = todom.Scan, todom.ImuBatch, T
        fit = loc.global_init(mk_scan(*map(arr, data["scans"][0])), arr(guess))
        init = (N(loc.nav.R), N(loc.nav.p))
        steps = [loc.process(mk_scan(*map(arr, data["scans"][k])),
                             mk_imu(*map(arr, _imu(data, k))), data["scan_dt"])
                 for k in range(1, 11)]
        out[pkg] = (fit, init, steps)
    return out, data


def test_global_init_matches_jax(localized):
    out, data = localized
    (jfit, (jR, jp), _), (tfit, (tR, tp), _) = out["jax"], out["port"]
    np.testing.assert_allclose(tR, jR, atol=1e-3)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert tfit == pytest.approx(jfit, rel=1e-2)
    assert tfit < 1.0
    _, p_gt = data["gt"][0]
    assert np.linalg.norm(tp - p_gt) < 0.2  # the 0.5 m perturbation is undone


def test_process_steps_match_jax(localized):
    out, data = localized
    jsteps, tsteps = out["jax"][2], out["port"][2]
    for k, ((jT, jn), (tT, tn)) in enumerate(zip(jsteps, tsteps), start=1):
        assert isinstance(tT, np.ndarray) and tT.shape == (4, 4) and isinstance(tn, int)
        np.testing.assert_allclose(tT[:3, 3], np.asarray(jT)[:3, 3], atol=1e-2)
        np.testing.assert_allclose(tT[:3, :3], np.asarray(jT)[:3, :3], atol=1e-2)
        assert abs(tn - jn) <= 0.02 * jn and tn > 300, (k, tn, jn)
    # against ground truth: as close as the JAX localizer (both start at
    # rest from global_init and lag until the IMU gives them a velocity)
    def rms(steps):
        err = [np.linalg.norm(np.asarray(T_)[:3, 3] - data["gt"][k][1])
               for k, (T_, _) in enumerate(steps, 1)]
        return float(np.sqrt(np.mean(np.square(err))))

    assert rms(tsteps) < min(rms(jsteps) + 0.01, 0.5)


def test_process_before_init_raises(bundle):
    loc = trt.MapLocalizer(bundle, map_cfg=tmap.VoxelMapConfig(**MAP),
                           odom_cfg=todom.OdomConfig(**ODOM), device="cpu")
    scan = todom.Scan(torch.zeros((8, 3)), torch.zeros(8), torch.zeros(8, dtype=torch.bool))
    imu = todom.ImuBatch(torch.full((4,), 1e9), torch.zeros((4, 3)), torch.zeros((4, 3)),
                         torch.zeros(4, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="global_init"):
        loc.process(scan, imu, 0.1)
