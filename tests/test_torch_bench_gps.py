"""The bench's GPS configurations in the port against the JAX package, on
the CPU: the reference-exact engine's GPS policy on a small corridor
(``bench.py: bench_reference_exact``) and the degraded-GPS engine
(``bench.py: bench_gps_degraded``) on a small figure-8. The engines are
driven as the bench drives them (``test_torch_bench_configs.py:
drive_both``).

Both engines convert fixes with the port's float32 geodesy
(``PortGeodesy``): the packages' own differ by up to 0.5 m a fix
(``tests/test_torch_gps_engine.py``), which would move a solved
trajectory by centimetres and could flip a spacing decision; the
conversion itself is held in ``tests/test_torch_scaling_scripts.py`` and
``test_torch_geodesy_cov.py``.

Tolerances, each with its reason:
  * the same keyframes, solves, factor count, factor keyframes and sqrt
    information; the anchor equal;
  * factor positions and the realtime trajectory within 3 cm, the chunked
    engines' tolerance (``tests/test_torch_chunked.py``; a factor's z is
    the SLAM height).
"""
import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.runtime import engine as jengine  # noqa: E402
from fastliosam_tpu_torch.core.geodesy import LocalCartesian  # noqa: E402
from fastliosam_tpu_torch.eval import feeds  # noqa: E402
from fastliosam_tpu_torch.sim import (  # noqa: E402
    PlaneWorld, SimConfig, Trajectory, simulate_sequence)

from _torch_parity import N  # noqa: E402
from test_torch_bench_configs import (  # noqa: E402
    CHUNK, REFEXACT, _cfgs, drive_both, small_fig8)
from test_torch_engine import JAX_CLS, PORT_CLS  # noqa: E402
from test_torch_feeds_scripts import REPO, _jax_functions, bench  # noqa: E402, F401


def _small_corridor(n_scans):
    """The bench's GPS corridor (``bench.py: build_corridor_sequence``) at
    256 x 10 rays."""
    world = PlaneWorld.corridor(length=400.0, width=8.0, height=5.0, n_clutter=8,
                                clutter_span=15.0, seed=3)
    traj = Trajectory.straight(speed=6.0)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=256, n_elev=10, max_range=60.0,
                    gyro_noise=0.001, acc_noise=0.01, acc_bias=(0.08, -0.03, 0.04), seed=3,
                    time_groups=32, gps_rate=10.0, gps_noise=0.3)
    return simulate_sequence(world, traj, cfg, n_scans=n_scans), traj


def _fixes(data, traj, degrade_middle=False):
    """The port's ``_fixes_from_data`` of the packed sequence, for both
    engines (each package's own reverse geodesy moves a fix by up to 0.61
    m: the conversion is held in ``tests/test_torch_scaling_scripts.py``,
    the policy here)."""
    port = feeds._fixes_from_data(feeds.pack_sequence(data, traj), degrade_middle=degrade_middle)
    return {"jax": [jrt.GpsFix(*f) for f in port], "port": port}


class PortGeodesy:
    """The JAX engine's ``LocalCartesian`` replaced by the port's float32
    geodesy (patched into ``fastliosam_tpu.runtime.engine`` by the test),
    so that both engines place each fix at the same ENU position: the
    packages' float32 ECEF differs by up to 0.5 m (one float32 step at
    6.4e6 m), 0.23 m on this corridor's fixes, which a 1 m noise floor
    turns into several centimetres of trajectory after each solve. Keeps
    the origin it was made from."""

    def __init__(self, origin):
        self.origin = origin
        self.lc = LocalCartesian.from_origin(*origin)

    @classmethod
    def from_origin(cls, lat, lon, alt):
        return cls((float(lat), float(lon), float(alt)))

    def forward(self, lat, lon, alt):
        return self.lc.forward(float(lat), float(lon), float(alt)).numpy()


def _gps_factors(e):
    n = int(e.graph.n_gps)
    return n, N(e.graph.gps_idx)[:n], N(e.graph.gps_xyz)[:n], N(e.graph.gps_sqrt_info)[:n]


def test_refexact_gps_corridor_matches_jax(monkeypatch):
    """The reference GPS policy (``bench_reference_exact``'s corridor):
    first-fix anchoring, fixes attached as they are (no motion
    compensation), the 1 m noise floor and 5 m spacing, a solve every
    keyframe; 40 scans of the small corridor, both engines on the port's
    geodesy. The receiver starts late and lags: its first fix comes in the
    third chunk (the anchor's SLAM offset is then the pose before it, not
    0) and each fix 30 ms after its scan (inside the 50 ms stamp
    tolerance, so motion compensation would move it)."""
    from fastliosam_tpu.runtime import engine as jengine

    monkeypatch.setattr(jengine, "LocalCartesian", PortGeodesy)
    n = 40
    data, traj = _small_corridor(n)
    lag, first = 0.03, 2 * CHUNK + 1
    port = [f._replace(stamp=f.stamp + lag) for f in _fixes(data, traj)["port"][first:]]
    fixes = {"jax": [jrt.GpsFix(*f) for f in port], "port": port}
    spec = copy.deepcopy(REFEXACT)
    spec["cfg"]["use_gps"] = True
    (je, jp), (te, tp) = drive_both(data, traj, lambda pkg: _cfgs(spec, pkg), n, fixes=fixes)
    assert te.kf.n == je.kf.n
    # the anchor: the first fix's own position (no warmup average), offset
    # by the SLAM position when it came: the last pose of the chunk before
    f0 = port[0]
    assert je.gps_anchor.origin == (f0.lat, f0.lon, f0.alt)
    for a, b in zip(te.gps_anchor, je.gps_anchor.lc):
        np.testing.assert_array_equal(N(a), N(b))
    assert te._gps_warmup is None and je._gps_warmup is None
    before = 2 * CHUNK - 1
    np.testing.assert_array_equal(te.gps_slam_offset, tp[before, :3, 3])
    np.testing.assert_array_equal(je.gps_slam_offset, jp[before, :3, 3])
    np.testing.assert_allclose(te.gps_slam_offset, je.gps_slam_offset, atol=3e-2)
    jn, ji, jx, jsi = _gps_factors(je)
    tn, ti, tx, tsi = _gps_factors(te)
    assert tn == jn >= 2
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tx, jx, atol=3e-2)  # the offset and z from SLAM
    np.testing.assert_array_equal(tsi, jsi)
    # the 1 m floor: the fixes' 0.5 m horizontal noise is floored, z from SLAM
    np.testing.assert_array_equal(tsi, 1.0)
    # no motion compensation: each factor at its fix's own ENU position
    kf_st = N(te.kf.stamps)[ti].astype(np.float64)
    stamps = np.asarray([f.stamp for f in port])
    used = np.argmin(np.abs(stamps[None, :] - kf_st[:, None]), axis=1)
    assert np.allclose(stamps[used] - kf_st, lag, atol=1e-4)
    enu = np.stack([te.gps_anchor.forward(port[i].lat, port[i].lon, port[i].alt).numpy()
                    for i in used])
    np.testing.assert_allclose(tx[:, :2], (enu + te.gps_slam_offset)[:, :2], atol=1e-5)
    assert te.solve_count == je.solve_count == n // CHUNK
    np.testing.assert_allclose(tp, jp, atol=3e-2)


# bench.py: make_engine_for at small width (tests/test_engine.py's odometry
# and map), with bench_gps_degraded's settings
DEGRADED = dict(
    odom_cfg=dict(point_filter_num=1, blind=0.5, filter_size_surf=0.3, num_ds_points=2048,
                  evict_every=10_000),
    map_cfg=dict(capacity=1 << 14, voxel_size=0.4, min_points=4),
    loop_cfg=dict(radius=10.0, time_gap=4.0, num_submap_keyframes=2, voxel_res=0.25,
                  submap_points=4096, nn_chunk=1024),
    pgo_cfg=dict(max_keyframes=64, max_between=128, max_gps=32, gps_huber_delta=2.0),
    cfg=dict(keyframe_threshold=1.0, loop_check_every=CHUNK, kf_cloud_points=1024,
             kf_cloud_voxel=0.25, use_gps=True, gps_dist_thres=2.0,
             odom_trans_sqrt_info=200.0, odom_rot_sqrt_info=1000.0),
)


def _plain(spec):
    return lambda pkg: {k: (JAX_CLS if pkg == "jax" else PORT_CLS)[k](**v)
                        for k, v in spec.items()}


def _factor_fixes(e, fixes):
    """The index of the fix behind each GPS factor: the fix nearest its
    keyframe's stamp (the queue scrub takes the fix within
    ``gps_time_tol`` of it)."""
    n, idx, _, _ = _gps_factors(e)
    kf_st = N(e.kf.stamps)[idx].astype(np.float64)
    stamps = np.asarray([f.stamp for f in fixes])
    near = np.argmin(np.abs(stamps[None, :] - kf_st[:, None]), axis=1)
    assert np.all(np.abs(stamps[near] - kf_st) <= e.cfg.gps_time_tol + 1e-4)
    return near


def test_degraded_gps_matches_jax(monkeypatch):
    """``bench_gps_degraded``: the middle third of the fixes reports a 3 m
    sigma, above ``gps_cov_thres``, and is gated out; Huber GPS residuals,
    2 m spacing, odometry sqrt information 200 / 1000. 40 scans of the
    small figure-8 with 10 Hz fixes: the same factors in both packages,
    none from the middle third, which the same engine without the
    degradation does use."""
    monkeypatch.setattr(jengine, "LocalCartesian", PortGeodesy)
    n = 40
    data, traj = small_fig8(n, gps=True)
    fixes = _fixes(data, traj, degrade_middle=True)
    (je, jp), (te, tp) = drive_both(data, traj, _plain(DEGRADED), n, fixes=fixes)
    assert te.kf.n == je.kf.n > 5
    jn, ji, jx, jsi = _gps_factors(je)
    tn, ti, tx, tsi = _gps_factors(te)
    assert tn == jn >= 1
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tx, jx, atol=3e-2)
    np.testing.assert_array_equal(tsi, jsi)
    assert te.solve_count == je.solve_count >= 1
    np.testing.assert_allclose(tp, jp, atol=3e-2)
    n_fix = len(fixes["port"])
    middle = range(n_fix // 3, 2 * n_fix // 3)
    assert not set(_factor_fixes(te, fixes["port"]).tolist()) & set(middle)
    # without the degradation the middle third is used
    good = _fixes(data, traj)
    ((tg, _),) = drive_both(data, traj, _plain(DEGRADED), n, fixes=good, pkgs=("port",))
    assert set(_factor_fixes(tg, good["port"]).tolist()) & set(middle)


@pytest.mark.slow
def test_refexact_corridor_jax_reading(bench):
    """The JAX package's reference-exact corridor reading on the CPU at
    full width and ``chip_smoke.py``'s cut depth (the first
    ``REFEXACT_CORRIDOR_SCANS`` of the corridor feed's ``CORRIDOR_SCANS``, the
    bench's ``make_refexact(512, 1024, 64, use_gps=True)`` read from
    ``bench.py``, its own fixes and pipeline), kept there as
    ``REFEXACT_CORRIDOR_JAX_ATE_M`` and printed beside the card's (not
    gated: the corridor is chaotic, ROADMAP Queue 3 fault 3)."""
    import sys

    from fastliosam_tpu.loop import LoopConfig as JLoopConfig
    from fastliosam_tpu.map import VoxelMapConfig as JVoxelMapConfig
    from fastliosam_tpu.odom import OdomConfig as JOdomConfig
    from fastliosam_tpu.pgo import PoseGraphConfig as JPoseGraphConfig
    from fastliosam_tpu.runtime import EngineConfig as JEngineConfig, SlamEngine

    sys.path.insert(0, str(REPO))
    import chip_smoke

    n = chip_smoke.REFEXACT_CORRIDOR_SCANS
    data = chip_smoke._feed_head(feeds.build_corridor_sequence(chip_smoke.CORRIDOR_SCANS), n)
    env = dict(SlamEngine=SlamEngine, OdomConfig=JOdomConfig, VoxelMapConfig=JVoxelMapConfig,
               LoopConfig=JLoopConfig, PoseGraphConfig=JPoseGraphConfig,
               EngineConfig=JEngineConfig, chunk=CHUNK)
    (make,) = _jax_functions(REPO / "bench.py", ["make_refexact"], env,
                             outer="bench_reference_exact")
    engine = make(512, 1024, 64, use_gps=True)
    feed, _ = bench._stage_chunks(data, CHUNK)
    bench._init_engine_at(engine, data)
    bench._run_pipeline(engine, feed, gps_fixes=bench._fixes_from_data(data))
    rt = np.stack(engine.realtime_traj)[:, :3, 3]
    ate = float(np.sqrt(np.mean(np.sum((rt - data["gt_p"][: len(rt)]) ** 2, axis=1))))
    print(f"JAX reference-exact corridor on the CPU, {len(rt)} scans: ATE {ate:.6f} m, "
          f"{int(engine.graph.n_gps)} GPS factors, {engine.solve_count} solves, "
          f"{engine.kf.n} keyframes")
    assert abs(ate - chip_smoke.REFEXACT_CORRIDOR_JAX_ATE_M) < 5e-5
