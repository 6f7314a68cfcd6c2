"""Parity of the port's odometry (IMU propagate, deskew, iEKF, per-scan
step) with the JAX package, on the room feed of ``tests/test_odometry.py``
cut to 256 x 10 rays, a 2^14-slot map and 2048 iEKF points.

Tolerances and why:
  * propagate: 1e-5 on R/p/v — the port takes the attitude prefix product
    sequentially where JAX uses ``associative_scan`` (same model, other
    rounding order); covariance rtol 1e-4 (24x24 products of 1e-8..1e-2
    entries).
  * deskew: 1e-4 m on points up to ~20 m (float32 ulp there is 2e-6 m,
    times a 3x3 exp and two transforms).
  * one odom_step from the same carried-across state: pose within 1e-4 m.
  * 6 scans from the same start: 1 cm. The room's floor (z = 0) lies
    exactly on a voxel boundary of the 0.4 m map, so which voxel a floor
    point lands in is decided by float32 rounding (~2e-6 m here) — the two
    implementations disagree on a handful of points per scan, both
    rightly. The trajectories then differ by a few millimetres after six
    scans, well inside the odometry's own error against ground truth.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu.map import VoxelMapConfig as JMapCfg  # noqa: E402
from fastliosam_tpu.odom import iekf as jiekf  # noqa: E402
from fastliosam_tpu.odom import imu as jimu  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch.convert import (  # noqa: E402
    nav_state_from_numpy,
    odom_state_from_numpy,
    voxel_map_from_numpy,
)
from fastliosam_tpu_torch.map import VoxelMapConfig as TMapCfg  # noqa: E402
from fastliosam_tpu_torch.odom import imu as timu  # noqa: E402
from fastliosam_tpu_torch.odom import iekf as tiekf  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402

J_MAP = JMapCfg(capacity=1 << 14, voxel_size=0.4, min_points=4)
T_MAP = TMapCfg(**J_MAP._asdict())
J_ODOM = jodom.OdomConfig(point_filter_num=1, blind=0.5, filter_size_surf=0.3,
                          num_ds_points=2048, max_imu_per_scan=32, evict_every=1000)
T_ODOM = todom.OdomConfig(**J_ODOM._asdict())
N_SCANS = 6


@pytest.fixture(scope="module")
def room():
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=10, seed=1)
    traj = Trajectory.circle(radius=8.0, period=60.0)
    cfg = SimConfig(n_azimuth=256, n_elev=10, gyro_noise=0.0005, acc_noise=0.005,
                    gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=3)
    return simulate_sequence(world, traj, cfg, n_scans=N_SCANS), traj


def _imu_np(data, k, cap=32):
    ts, gyro, acc = data["imu"][k]
    n = len(ts)
    return (np.pad(ts, (0, cap - n), constant_values=1e9).astype(np.float32),
            np.pad(gyro, ((0, cap - n), (0, 0))).astype(np.float32),
            np.pad(acc, ((0, cap - n), (0, 0))).astype(np.float32),
            np.arange(cap) < n)


def _inputs(data, k):
    imu = _imu_np(data, k)
    pts, toff, mask = data["scans"][k]
    return ((jodom.Scan(*map(jnp.asarray, (pts, toff, mask))),
             jodom.ImuBatch(*map(jnp.asarray, imu))),
            (todom.Scan(T(pts), T(toff), T(mask)), todom.ImuBatch(*map(T, imu))))


def _start_nav(traj, R0=None):
    R0, p0 = traj.pose(0.0)
    nav = jodom.init_state(cfg=J_ODOM)
    return nav._replace(R=jnp.asarray(R0, jnp.float32), p=jnp.asarray(p0, jnp.float32),
                        v=jnp.asarray(traj.velocity(0.0), jnp.float32))


def test_propagate_matches_jax_and_sequential(room):
    data, traj = room
    jnav = _start_nav(traj)
    tnav = nav_state_from_numpy(tree_np(jnav), device="cpu")
    (_, jimu_b), (_, timu_b) = _inputs(data, 1)
    jx, jtraj = jimu.propagate(jnav, jimu_b, J_ODOM, jnp.float32(data["scan_dt"]))
    tx, ttraj = timu.propagate(tnav, timu_b, T_ODOM, data["scan_dt"])
    sx, straj = timu.propagate_sequential(tnav, timu_b, T_ODOM, data["scan_dt"])
    for name in ("R", "p", "v"):
        np.testing.assert_allclose(N(getattr(tx, name)), N(getattr(jx, name)), atol=1e-5)
        np.testing.assert_allclose(N(getattr(sx, name)), N(getattr(tx, name)), atol=1e-5)
    np.testing.assert_allclose(N(tx.P), N(jx.P), rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(N(sx.P), N(tx.P), rtol=1e-4, atol=1e-10)
    for a, b, c in zip(ttraj, jtraj, straj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-5)
        np.testing.assert_allclose(N(c), N(a), atol=1e-5)


def test_deskew_matches_jax(room):
    data, traj = room
    jnav = _start_nav(traj)
    (jscan, jimu_b), (tscan, timu_b) = _inputs(data, 1)
    dt = data["scan_dt"]
    jx, jtraj = jimu.propagate(jnav, jimu_b, J_ODOM, jnp.float32(dt))
    # same propagated state and trajectory on both sides: deskew alone
    tx = nav_state_from_numpy(tree_np(jx), device="cpu")
    ttraj = tuple(T(N(a)) for a in jtraj)
    ref = jimu.deskew(jscan.xyz, jscan.t_offset, jscan.mask, jtraj, jx, J_ODOM,
                      jimu_b.mask, jnp.float32(dt))
    out = timu.deskew(tscan.xyz, tscan.t_offset, tscan.mask, ttraj, tx, T_ODOM,
                      timu_b.mask, dt)
    np.testing.assert_allclose(N(out), N(ref), atol=1e-4)


@pytest.fixture(scope="module")
def jax_run(room):
    """The JAX odometry over the feed: per-scan states and positions."""
    data, traj = room
    step = jax.jit(lambda s, scan, imu, dt: jodom.odom_step(s, scan, imu, dt, J_ODOM, J_MAP))
    st = jodom.init_odom(J_MAP, J_ODOM)._replace(nav=_start_nav(traj))
    states, ps, matched = [st], [], []
    for k in range(N_SCANS):
        (jscan, jimu_b), _ = _inputs(data, k)
        st, aux = step(st, jscan, jimu_b, jnp.float32(data["scan_dt"]))
        states.append(st)
        ps.append(np.asarray(aux["p"]))
        matched.append(int(aux["n_matched"]))
    return states, np.stack(ps), matched


def test_iekf_update_matches_jax(room, jax_run):
    """One iterated update against the same map and a perturbed state."""
    data, _ = room
    states, _, _ = jax_run
    st = states[3]
    pts, _, mask = data["scans"][3]
    R_gt, p_gt = data["gt"][3]
    pw = (pts[mask][:1500] @ R_gt.T + p_gt).astype(np.float32)
    # body-frame points at the stored pose, then a few-cm pose error
    pb = jnp.asarray((pw - np.asarray(st.nav.p)) @ np.asarray(st.nav.R))
    nav_w = st.nav._replace(p=st.nav.p + jnp.asarray([0.03, -0.02, 0.01], jnp.float32))
    ones = jnp.ones((pb.shape[0],), bool)
    upd = jax.jit(lambda n, p, m, vm: jiekf.iekf_update(n, p, m, vm, J_MAP, J_ODOM))
    jx, jn = upd(nav_w, pb, ones, st.vmap)
    tx, tn = tiekf.iekf_update(
        nav_state_from_numpy(tree_np(nav_w), device="cpu"), T(N(pb)), T(N(ones)),
        voxel_map_from_numpy(tree_np(st.vmap), device="cpu"), T_MAP, T_ODOM,
    )
    assert int(jn) > 500 and abs(int(tn) - int(jn)) <= 2
    np.testing.assert_allclose(N(tx.p), N(jx.p), atol=1e-4)
    # the rotation part of a 3-iteration solve from a 4 cm error: 1e-4 rad
    # (float32 Gram sums over 1500 rows in another order)
    np.testing.assert_allclose(N(tx.R), N(jx.R), atol=1e-4)
    # posterior covariance = float32 inverse of S, whose frozen-extrinsic
    # block holds 1e12: compare against the largest entry's scale
    P_ref = N(jx.P)
    np.testing.assert_allclose(N(tx.P), P_ref, atol=1e-4 * np.abs(P_ref).max())


def test_one_odom_step_from_carried_state(room, jax_run):
    data, _ = room
    states, ps, matched = jax_run
    k = 3
    tstate = odom_state_from_numpy(tree_np(states[k]), device="cpu")
    _, (tscan, timu_b) = _inputs(data, k)
    tnew, aux = todom.odom_step(tstate, tscan, timu_b, data["scan_dt"], T_ODOM, T_MAP,
                                device="cpu")
    np.testing.assert_allclose(N(aux["p"]), ps[k], atol=1e-4)
    np.testing.assert_allclose(N(aux["R"]), np.asarray(states[k + 1].nav.R), atol=1e-5)
    assert abs(int(aux["n_matched"]) - matched[k]) <= 0.01 * matched[k]
    assert tnew.scan_idx == k + 1 and tnew.initialized


def test_odom_scans_track_jax(room, jax_run):
    data, traj = room
    _, ps_ref, matched_ref = jax_run
    st = odom_state_from_numpy(tree_np(jodom.init_odom(J_MAP, J_ODOM)._replace(
        nav=_start_nav(traj))), device="cpu")
    ps = []
    for k in range(N_SCANS):
        _, (tscan, timu_b) = _inputs(data, k)
        st, aux = todom.odom_step(st, tscan, timu_b, data["scan_dt"], T_ODOM, T_MAP,
                                  device="cpu")
        ps.append(N(aux["p"]))
        if k >= 2:
            assert int(aux["n_matched"]) > 500
    np.testing.assert_allclose(np.stack(ps), ps_ref, atol=1e-2)
    gt = np.stack([g[1] for g in data["gt"]])
    assert np.sqrt(np.mean(np.sum((np.stack(ps) - gt) ** 2, axis=1))) < 0.10
