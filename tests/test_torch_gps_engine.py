"""The port's GPS engine path against the JAX engine: the gating rules, the
pose-covariance gate, capacity growth, the ENU anchor warmup, its forced
finalize and fix motion compensation (the counterparts of
``tests/test_engine_behaviors.py:138-174, 312-430``), and a short GPS sim
feed through both engines (the counterpart of ``tests/test_engine.py:
181-205``).

Tolerances and why:
  * Behaviour tests feed both engines the same host state, so the factor
    counts and indices must be equal and the factor positions within
    1e-5 m (host float64 numpy in both, uploaded as float32).
  * Fixes that go through the geodesy (``GpsFix`` -> ENU) differ by up to
    0.61 m between the packages: both compute ECEF in float32, where
    6.4e6 m has a spacing of 0.5 m, and XLA's and torch's ``sin``/``cos``
    differ by an ulp (measured, ``tests/test_torch_geodesy_cov.py``). So the
    feed test compares factor positions within 1.0 m and uses a
    configuration whose gating decisions cannot flip on such a difference
    (factor spacing 0, covariance gate open); the factor count and the
    keyframes the factors attach to must then be equal. Realtime poses:
    within 5 cm — 2 cm of float32 drift on this feed without GPS
    (``tests/test_torch_engine.py``) plus the pull of fixes that differ by
    up to 0.6 m, each weighted by a 1 m noise floor.
"""
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.core.geodesy import LocalCartesian as JLocalCartesian  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch import runtime as trt  # noqa: E402
from fastliosam_tpu_torch.convert import copy_gps_state  # noqa: E402

from _torch_parity import N, T  # noqa: E402
from test_torch_engine import JAX_CLS, PORT_CLS, _imu  # noqa: E402

ANCHOR = (22.3193, 114.1694, 10.0)

# tests/test_engine_behaviors.py: tiny_engine
TINY = dict(
    odom_cfg=dict(point_filter_num=1, blind=0.1, filter_size_surf=0.3, num_ds_points=64,
                  evict_every=10_000),
    map_cfg=dict(capacity=1 << 10, voxel_size=0.4, min_points=4),
    loop_cfg=dict(radius=5.0, time_gap=2.0, num_submap_keyframes=1, submap_points=256,
                  max_iterations=4, nn_chunk=64),
    pgo_cfg=dict(max_keyframes=4, max_between=4, max_gps=2, lm_iters=2, pcg_iters=8),
    cfg=dict(keyframe_threshold=0.15, loop_check_every=2, kf_cloud_points=64,
             kf_cloud_voxel=0.3),
)


def tiny_pair(**cfg_kw):
    """The same tiny engine in both packages."""
    kw = {k: dict(v) for k, v in TINY.items()}
    kw["cfg"].update(cfg_kw)
    j = jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in kw.items()})
    t = trt.SlamEngine(**{k: PORT_CLS[k](**v) for k, v in kw.items()}, device="cpu")
    return j, t


def _gps_factors(eng):
    n = int(eng.graph.n_gps)
    return n, N(eng.graph.gps_idx)[:n], N(eng.graph.gps_xyz)[:n], N(eng.graph.gps_sqrt_info)[:n]


def _same_factors(j, t, xyz_atol=1e-5):
    jn, ji, jx, js = _gps_factors(j)
    tn, ti, tx, ts = _gps_factors(t)
    assert tn == jn and t._n_gps_host == j._n_gps_host
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=xyz_atol)
    np.testing.assert_allclose(ts, js, rtol=1e-6)


def test_gps_pose_cov_gate():
    engines = tiny_pair(use_gps=True, min_traj_len=0.0, gps_dist_thres=0.0,
                        gps_time_tol=10.0, pose_cov_thres=0.02)
    for e in engines:
        e.traj_len = 10.0

        def push(x):
            e.gps_queue.append((0.0, np.array([x, 0.0, 0.0]), np.array([0.5, 0.5, 0.5])))

        push(10.0)  # never solved: the gate is open
        e._try_add_gps_factor(0, 0.0, np.eye(4, dtype=np.float32))
        assert e._n_gps_host == 1
        e._cov6 = np.diag([1e-4] * 3 + [1e-6] * 3)  # well constrained at the solve
        e._cov_solved_kf = 1
        e._cov_solved_p = np.zeros(2)
        e._cov_solved_trajlen = e.traj_len
        push(20.0)
        e._try_add_gps_factor(1, 0.0, np.eye(4, dtype=np.float32))
        assert e._n_gps_host == 1, "GPS factor added despite small pose cov"
        e.traj_len = e._cov_solved_trajlen + 9.0  # the estimate grows again
        grown = e._pose_cov_estimate(10, np.array([9.0, 0.0, 0.0]))
        assert np.all(grown > 1e-4)
        push(30.0)
        e._try_add_gps_factor(10, 0.0, np.eye(4, dtype=np.float32))
        assert e._n_gps_host == 2
    _same_factors(*engines)


def test_gps_factor_capacity_grow():
    engines = tiny_pair(use_gps=True, min_traj_len=0.0, gps_dist_thres=0.0, gps_time_tol=10.0)
    for e in engines:
        e.traj_len = 10.0
        with pytest.warns(UserWarning, match="GPS-factor capacity"):
            for i in range(4):  # the cap is 2
                e.gps_queue.append((0.0, np.array([10.0 * (i + 1), 0.0, 0.0]),
                                    np.array([0.5, 0.5, 0.5])))
                e._try_add_gps_factor(0, 0.0, np.eye(4, dtype=np.float32))
        assert e._n_gps_host == 4 and int(e.graph.n_gps) == 4 and e.pgo_cfg.max_gps >= 4
    _same_factors(*engines)


def test_gps_anchor_warmup_averages_offset():
    """Noisy fixes around a known trajectory: the averaged anchor offset and
    the flushed queue (the JAX test's gates), and the same queue as JAX."""
    rng = np.random.default_rng(0)
    lc = JLocalCartesian.from_origin(*ANCHOR)
    fixes = []
    for k in range(10):
        t = 0.1 * k
        noisy = np.array([5.0 + t, 2.0, 0.0]) + rng.normal(size=3) * 0.3
        lat, lon, alt = lc.reverse(jnp.asarray(noisy, jnp.float32))
        fixes.append(trt.GpsFix(stamp=t, lat=float(lat), lon=float(lon), alt=float(alt),
                                cov_xyz=(0.09, 0.09, 0.09)))
    queues = []
    for e in tiny_pair(use_gps=True, gps_anchor_warmup=8):
        for k in range(12):
            Tk = np.eye(4, dtype=np.float32)
            Tk[:3, 3] = [5.0 + 0.1 * k, 2.0, 0.0]
            e.realtime_traj.append(Tk)
            e.scan_stamps.append(0.1 * k)
        for f in fixes:
            e._on_gps(jrt.GpsFix(*f) if isinstance(e, jrt.SlamEngine) else f)
        assert e._gps_warmup is None and len(e.gps_queue) == 10
        est = np.stack([q[1] for q in e.gps_queue])
        truth = np.stack([[5.0 + 0.1 * k, 2.0, 0.0] for k in range(10)])
        assert np.linalg.norm(np.mean(est - truth, axis=0)[:2]) < 0.2
        queues.append(est)
    # ENU through float32 geodesy in each package (module docstring)
    np.testing.assert_allclose(queues[1], queues[0], rtol=0, atol=1.0)


def _drive(e, n, v=1.0, dt=0.1):
    """CV-only rollout of empty scans (tests/test_engine_behaviors.py: drive)."""
    jax_side = isinstance(e, jrt.SlamEngine)
    if jax_side:
        e.odom = e.odom._replace(nav=e.odom.nav._replace(v=jnp.asarray([v, 0.0, 0.0])))
        scan = jodom.Scan(jnp.zeros((64, 3)), jnp.zeros((64,)), jnp.zeros((64,), bool))
        imu = jodom.ImuBatch(jnp.full((8,), 1e9), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
                             jnp.zeros((8,), bool))
    else:
        e.odom = e.odom._replace(nav=e.odom.nav._replace(v=torch.tensor([v, 0.0, 0.0])))
        scan = todom.Scan(torch.zeros((64, 3)), torch.zeros(64), torch.zeros(64, dtype=torch.bool))
        imu = todom.ImuBatch(torch.full((8,), 1e9), torch.zeros((8, 3)), torch.zeros((8, 3)),
                             torch.zeros(8, dtype=torch.bool))
    return [e.process(scan, imu, k * dt, dt) for k in range(n)]


def test_gps_warmup_force_finalizes_on_finish():
    """Fewer fixes than the warmup quota: finish() finalizes the anchor and
    retro-attaches factors to the keyframes (port only; the fixes reach
    both packages' geodesy the same way as in the warmup test above)."""
    _, e = tiny_pair(use_gps=True, gps_anchor_warmup=8, min_traj_len=0.1, gps_dist_thres=0.1)
    lc = JLocalCartesian.from_origin(*ANCHOR)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # keyframe capacity grows
        _drive(e, 12)
        for k in range(3):
            lat, lon, alt = lc.reverse(jnp.asarray([0.1 * k, 0.0, 0.0], jnp.float32))
            e._on_gps(trt.GpsFix(stamp=0.1 * k, lat=float(lat), lon=float(lon),
                                 alt=float(alt), cov_xyz=(0.09, 0.09, 0.09)))
        assert e._gps_warmup is not None
        e.finish()
    assert e._gps_warmup is None
    assert int(e.graph.n_gps) >= 1 and e.solve_count >= 1
    assert e._cov6 is not None and np.all(np.isfinite(e._cov6))


def test_gps_motion_compensation():
    """At 2 m/s a fix 0.04 s before the keyframe constrains a point 0.08 m
    behind it; reference-exact mode attaches the fix as it is."""
    v, dt, kf_stamp = 2.0, 0.1, 0.5
    fix_stamp = kf_stamp - 0.04
    for comp, want in ((True, v * kf_stamp), (False, v * fix_stamp)):
        engines = tiny_pair(use_gps=True, min_traj_len=0.0, gps_dist_thres=0.0,
                            gps_time_tol=0.05, gps_motion_comp=comp)
        for e in engines:
            e.traj_len = 10.0
            for k in range(8):
                Tk = np.eye(4, dtype=np.float32)
                Tk[0, 3] = v * k * dt
                e.realtime_traj.append(Tk)
                e.scan_stamps.append(k * dt)
            e.gps_queue.append((fix_stamp, np.array([v * fix_stamp, 0.0, 0.0]),
                                np.array([0.5, 0.5, 0.5])))
            e._try_add_gps_factor(0, kf_stamp, np.eye(4, dtype=np.float32))
            assert e._n_gps_host == 1
            np.testing.assert_allclose(N(e.graph.gps_xyz[0])[0], want, atol=1e-5)
        _same_factors(*engines)


def test_copy_gps_state_carries_the_jax_engine_over():
    j, t = tiny_pair(use_gps=True, min_traj_len=0.0, gps_dist_thres=0.0, gps_time_tol=10.0)
    j.gps_anchor = JLocalCartesian.from_origin(*ANCHOR)
    j._gps_warmup = None
    j.gps_queue = [(0.0, np.array([3.0, 1.0, 0.0]), np.array([0.5, 0.5, 0.5]))]
    j.traj_len = 4.0
    copy_gps_state(j, t)
    assert t.gps_anchor is not None and t._gps_warmup is None and t.traj_len == 4.0
    np.testing.assert_array_equal(N(t.gps_anchor.rot), N(j.gps_anchor.rot))
    for e in (j, t):
        e._try_add_gps_factor(0, 0.0, np.eye(4, dtype=np.float32))
    _same_factors(j, t)


# ---------------------------------------------------------------------------
# a short GPS sim feed through both engines
# ---------------------------------------------------------------------------
GPS_CFGS = dict(
    odom_cfg=dict(point_filter_num=1, blind=0.5, filter_size_surf=0.3,
                  num_ds_points=2048, evict_every=10_000),
    map_cfg=dict(capacity=1 << 14, voxel_size=0.4, min_points=4),
    loop_cfg=dict(radius=8.0, time_gap=6.0, num_submap_keyframes=2, voxel_res=0.25,
                  submap_points=8192, max_iterations=25, nn_chunk=1024),
    pgo_cfg=dict(max_keyframes=32, max_between=64, max_gps=16, lm_iters=8, pcg_iters=96,
                 marginal_pcg_iters=64),
    cfg=dict(keyframe_threshold=0.5, loop_check_every=4, kf_cloud_points=2048,
             kf_cloud_voxel=0.25, use_gps=True, gps_anchor_warmup=3, min_traj_len=1.0,
             gps_dist_thres=0.0, pose_cov_thres=0.0),
)


def test_gps_feed_matches_jax():
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=10, seed=1)
    traj = Trajectory.circle(radius=8.0, period=16.0)
    sim = SimConfig(scan_rate=5.0, n_azimuth=256, n_elev=10, gyro_noise=0.001,
                    acc_noise=0.01, gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=3,
                    gps_rate=5.0, gps_noise=0.3)
    n = 10
    data = simulate_sequence(world, traj, sim, n_scans=n)
    lc = JLocalCartesian.from_origin(*ANCHOR)
    fixes = []
    for tg, xyz, _ in data["gps"]:
        lat, lon, alt = lc.reverse(jnp.asarray(xyz, jnp.float32))
        fixes.append((float(tg), float(lat), float(lon), float(alt)))
    R0, p0 = traj.pose(0.0)
    runs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            e = jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in GPS_CFGS.items()})
            e.odom = e.odom._replace(nav=e.odom.nav._replace(
                R=jnp.asarray(R0, jnp.float32), p=jnp.asarray(p0, jnp.float32),
                v=jnp.asarray(traj.velocity(0.0), jnp.float32)))
            mk_scan, mk_imu, mk_fix, arr = jodom.Scan, jodom.ImuBatch, jrt.GpsFix, jnp.asarray
        else:
            e = trt.SlamEngine(**{k: PORT_CLS[k](**v) for k, v in GPS_CFGS.items()},
                               device="cpu")
            e.odom = e.odom._replace(nav=e.odom.nav._replace(
                R=T(R0, np.float32), p=T(p0, np.float32), v=T(traj.velocity(0.0), np.float32)))
            mk_scan, mk_imu, mk_fix, arr = todom.Scan, todom.ImuBatch, trt.GpsFix, T
        poses = []
        for k in range(n):
            lo = data["stamps"][k] - data["scan_dt"]
            gps = [mk_fix(stamp=f[0], lat=f[1], lon=f[2], alt=f[3], cov_xyz=(0.09, 0.09, 1.0))
                   for f in fixes if lo < f[0] <= data["stamps"][k]]
            poses.append(e.process(mk_scan(*map(arr, data["scans"][k])),
                                   mk_imu(*map(arr, _imu(data, k))),
                                   data["stamps"][k], data["scan_dt"], gps=gps))
        e.finish()
        runs.append((e, np.stack(poses)))
    (je, jp), (te, tp) = runs
    assert te.kf.n == je.kf.n
    jn, ji, jx, _ = _gps_factors(je)
    tn, ti, tx, _ = _gps_factors(te)
    assert tn == jn >= 2, "no gps factors added"
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1.0)
    assert te.solve_count == je.solve_count >= 1
    np.testing.assert_allclose(tp, jp, atol=5e-2)
    np.testing.assert_allclose(te.keyframe_poses(), N(je.keyframe_poses()), atol=5e-2)
    gt = np.stack([g[1] for g in data["gt"]])
    assert np.sqrt(np.mean(np.sum((tp[:, :3, 3] - gt) ** 2, axis=1))) < 0.6
