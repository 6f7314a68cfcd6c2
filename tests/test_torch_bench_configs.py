"""The bench's reference-exact and adversarial configurations in the port
against the JAX package, on the CPU: ``reference_exact()`` (the
counterpart of ``tests/test_engine_behaviors.py:431``), the reference-exact
engine chunked over a small figure-8 (``bench.py: bench_reference_exact``),
``verify_loop``'s branch without a surfel map, the Livox rollout
(``bench.py: bench_livox``) and the oracle's loops and solve (``bench.py:
bench_longrun_oracle``). The GPS configurations (the reference-exact
corridor, the degraded fixes) are ``test_torch_bench_gps.py``.

Tolerances, each with its reason:
  * configurations: equal, field for field;
  * the reference-exact engine: the same keyframes, solves and loops; the
    realtime trajectory within 3 cm (``tests/test_torch_chunked.py:
    test_process_chunk_matches_jax``'s tolerance for the two chunked
    engines: float32 odometry in another order; measured here 1.1 cm);
  * ``verify_loop`` without surfels: ``accepted`` equal, fitness within
    1e-3, the sqrt information within 1e-3 relative (it is 1/sqrt(fitness)
    on all six axes in both), the relative transform within 1e-3 (m / rad):
    both ICPs stop on the same float32 step test and sum their moments in
    other orders (``tests/test_torch_loop_pgo.py``);
  * the Livox rollout: positions within 1 cm a scan over 6 scans, the
    odometry tolerance of the JAX tests; the staged feed equal;
  * the oracle: its loop list equal to the bench's own loop over keyframes
    (transcribed below), its solve within 1e-3 m of JAX's ``solve`` at the
    same 32 LM / 768 PCG configuration (``tests/test_torch_loop_pgo.py``'s
    converged-budget tolerance).
"""
import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.loop import LoopConfig as JLoopConfig  # noqa: E402
from fastliosam_tpu.loop import closure as jcl  # noqa: E402
from fastliosam_tpu.map import VoxelMapConfig as JVoxelMapConfig  # noqa: E402
from fastliosam_tpu.odom import OdomConfig as JOdomConfig  # noqa: E402
from fastliosam_tpu.pgo import PoseGraphConfig as JPoseGraphConfig  # noqa: E402
from fastliosam_tpu.pgo import graph as jgraph  # noqa: E402
from fastliosam_tpu.pgo import solver as jsolver  # noqa: E402
from fastliosam_tpu.runtime import EngineConfig as JEngineConfig  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch import runtime as trt  # noqa: E402
from fastliosam_tpu_torch.eval import feeds  # noqa: E402
from fastliosam_tpu_torch.loop import LoopConfig, closure as tcl  # noqa: E402
from fastliosam_tpu_torch.pgo import PoseGraphConfig  # noqa: E402
from fastliosam_tpu_torch.runtime import EngineConfig  # noqa: E402
from fastliosam_tpu_torch.scripts import exp_loop_trust  # noqa: E402
from fastliosam_tpu_torch.sim import (  # noqa: E402
    PlaneWorld, SimConfig, Trajectory, simulate_sequence)

from _torch_parity import N, T  # noqa: E402
from test_torch_engine import JAX_CLS, PORT_CLS, _imu  # noqa: E402
from test_torch_feeds_scripts import REPO, _jax_functions, bench  # noqa: E402, F401
from test_torch_loop_pgo import _loop_store  # noqa: E402

# the reference-exact engine at small width: tests/test_engine.py's odometry
# and map, the reference's loop and engine configurations with small clouds
REFEXACT = dict(
    odom_cfg=dict(point_filter_num=1, blind=0.5, filter_size_surf=0.3, num_ds_points=2048,
                  evict_every=10_000),
    map_cfg=dict(capacity=1 << 14, voxel_size=0.4, min_points=4),
    loop_cfg=dict(submap_points=4096, nn_chunk=1024),
    pgo_cfg=dict(max_keyframes=64, max_between=128, max_gps=32),
    cfg=dict(loop_check_every=5, kf_cloud_points=1024, kf_cloud_voxel=0.25, gps_time_tol=0.05),
)
CHUNK = 5


def _cfgs(spec, pkg):
    """The configurations of ``spec`` in one package; ``loop_cfg`` and
    ``cfg`` through ``reference_exact``."""
    cls = JAX_CLS if pkg == "jax" else PORT_CLS
    out = {}
    for k, v in spec.items():
        if k in ("loop_cfg", "cfg"):
            out[k] = cls[k].reference_exact(**v)
        else:
            out[k] = cls[k](**v)
    return out


def drive_both(data, traj, cfgs, n, chunk=CHUNK, fixes=None, pkgs=("jax", "port")):
    """Both packages' engines (those in ``pkgs``) over the first ``n`` scans
    of a simulated sequence in chunks, as ``bench.py: _run_pipeline`` drives
    them (``process_chunk``, each chunk's fixes of its window,
    ``finish()``), or per scan (``process``) with ``chunk`` 1.
    ``cfgs(pkg)`` gives a package's configurations; ``fixes[pkg]`` its
    ``GpsFix`` list. Returns ``[(engine, realtime poses)]`` in the order of
    ``pkgs``."""
    R0, p0 = traj.pose(0.0)
    v0 = traj.velocity(0.0)
    imus = [_imu(data, k) for k in range(n)]
    runs = []
    for pkg in pkgs:
        if pkg == "jax":
            e = jrt.SlamEngine(**cfgs("jax"))
            arr, mk_scan, mk_imu = jnp.asarray, jodom.Scan, jodom.ImuBatch
        else:
            e = trt.SlamEngine(**cfgs("port"), device="cpu")
            arr, mk_scan, mk_imu = T, todom.Scan, todom.ImuBatch
        e.odom = e.odom._replace(nav=e.odom.nav._replace(
            R=arr(np.asarray(R0, np.float32)), p=arr(np.asarray(p0, np.float32)),
            v=arr(np.asarray(v0, np.float32))))
        dt = float(data["scan_dt"])
        out = []
        for c in range(0, n, chunk):
            ks = range(c, c + chunk)
            stamps = [data["stamps"][k] for k in ks]
            lo, hi = float(stamps[0]) - dt, float(stamps[-1])
            gps = None if fixes is None else [f for f in fixes[pkg] if lo <= f.stamp < hi]
            if chunk == 1:
                out.append(e.process(mk_scan(*map(arr, data["scans"][c])),
                                     mk_imu(*map(arr, imus[c])), stamps[0], dt, gps=gps)[None])
                continue
            scans = mk_scan(*(arr(np.stack([data["scans"][k][i] for k in ks])) for i in range(3)))
            imu = mk_imu(*(arr(np.stack([imus[k][i] for k in ks])) for i in range(4)))
            out.append(e.process_chunk(scans, imu, stamps, dt, gps=gps))
        e.finish()
        runs.append((e, np.concatenate(out)))
    return runs


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------
def test_reference_exact_constructors():
    """``reference_exact()`` restores every documented divergence to the
    reference's values (``tests/test_engine_behaviors.py:431``), equal to
    the JAX package's field for field, overrides passed through."""
    lc = LoopConfig.reference_exact()
    assert lc.radius == 35.0 and lc.time_gap == 30.0
    assert lc.icp_score_threshold == 1.5
    assert lc.max_corr_factor == 1.5
    assert lc.trim_fraction == 1.0 and lc.min_correspondences == 0
    assert not lc.aniso_noise and lc.degen_move_limit == 0.0
    assert lc.icp_method == "point" and lc.icp_multistart == 1 and lc.max_iterations == 50
    ec = EngineConfig.reference_exact()
    assert ec.keyframe_threshold == 0.0
    assert ec.gps_anchor_warmup == 1
    assert ec.gps_noise_floor == 1.0
    assert ec.gps_dist_thres == 5.0
    assert not ec.gps_motion_comp
    assert ec.solve_per_keyframe
    assert ec.odom_trans_sqrt_info == 10.0 and ec.odom_rot_sqrt_info == 100.0
    assert EngineConfig.reference_exact(loop_check_every=7).loop_check_every == 7
    assert PoseGraphConfig().gps_huber_delta == 0.0
    assert PoseGraphConfig().loop_huber_delta == 0.0
    for kw in ({}, {"submap_points": 16384}, {"radius": 10.0, "nn_chunk": 512}):
        assert LoopConfig.reference_exact(**kw)._asdict() == \
            JLoopConfig.reference_exact(**kw)._asdict()
    for kw in ({}, {"loop_check_every": 5, "kf_cloud_points": 4096, "use_gps": True,
                    "gps_time_tol": 0.05}):
        assert EngineConfig.reference_exact(**kw)._asdict() == \
            JEngineConfig.reference_exact(**kw)._asdict()


@pytest.mark.parametrize("kw", [dict(max_kf=256, max_between=512, max_gps=64),
                                dict(max_kf=512, max_between=1024, max_gps=64, use_gps=True)])
def test_make_refexact_matches_bench(kw):
    """``feeds.make_refexact`` against the bench's nested builder
    (``bench.py: bench_reference_exact``), read from ``bench.py``: the
    same five configurations."""
    from fastliosam_tpu.runtime import SlamEngine

    env = dict(SlamEngine=SlamEngine, OdomConfig=JOdomConfig, VoxelMapConfig=JVoxelMapConfig,
               LoopConfig=JLoopConfig, PoseGraphConfig=JPoseGraphConfig,
               EngineConfig=JEngineConfig, chunk=CHUNK)
    (make,) = _jax_functions(REPO / "bench.py", ["make_refexact"], env,
                             outer="bench_reference_exact")
    je = make(**kw)
    te = feeds.make_refexact(chunk=CHUNK, device="cpu", **kw)
    for name in ("odom_cfg", "map_cfg", "loop_cfg", "pgo_cfg", "cfg"):
        j, t = getattr(je, name), getattr(te, name)
        assert type(t).__name__ == type(j).__name__
        assert t._asdict() == j._asdict(), name
    assert te.device.type == "cpu" and te.kf.n == 0


# ---------------------------------------------------------------------------
# the reference-exact engine
# ---------------------------------------------------------------------------
def small_fig8(n_scans, gps=False):
    """The bench's figure-8 at small width: a 30 m room, 256 x 10 rays at
    the bench's 10 Hz, the lemniscate at 8 m scale."""
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=10, seed=1)
    traj = Trajectory.figure8(scale=8.0, period=12.0, z_amp=0.2)
    kw = dict(gps_rate=10.0, gps_noise=0.5) if gps else {}
    cfg = SimConfig(scan_rate=10.0, n_azimuth=256, n_elev=10, gyro_noise=0.001,
                    acc_noise=0.01, gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=3,
                    time_groups=32, **kw)
    return simulate_sequence(world, traj, cfg, n_scans=n_scans), traj


@pytest.mark.parametrize("chunk", [CHUNK, 1])
def test_refexact_engine_matches_jax(chunk):
    """The reference-exact engine over 20 scans of a small figure-8, in
    chunks of 5 (``process_chunk``, as the bench drives it) and per scan
    (``process``): a keyframe every moving scan, a solve in every chunk (or
    scan) that adds one (per-keyframe solves), no loop (the 30 s gap is
    longer than the feed), the same trajectory."""
    n = 20
    data, traj = small_fig8(n)
    (je, jp), (te, tp) = drive_both(data, traj, lambda pkg: _cfgs(REFEXACT, pkg), n,
                                    chunk=chunk)
    assert te.kf.n == je.kf.n == n
    assert te.solve_count == je.solve_count == n // chunk
    assert te.loop_pairs == je.loop_pairs == [] and not te.loop_attempts
    assert int(te.graph.n_bt) == int(je.graph.n_bt) == n - 1
    np.testing.assert_allclose(tp, jp, atol=3e-2)
    np.testing.assert_allclose(te.keyframe_poses(), N(je.keyframe_poses()), atol=3e-2)


def test_refexact_verify_loop_without_surfels_matches_jax(rng, monkeypatch):
    """``verify_loop`` with ``LoopConfig.reference_exact()`` on one pair of
    the patch store: no surfel map (the port's is made to raise), untrimmed
    point-to-point ICP of up to 50 iterations at 1.5 x the 35 m radius,
    accepted on fitness alone, the isotropic sqrt information
    1/sqrt(fitness) on all six axes, no slide rejection."""
    clouds, masks, poses, valid = _loop_store(rng)
    query, cand = 11, 0
    kw = dict(num_submap_keyframes=1, voxel_res=0.2, submap_points=4096, nn_chunk=512)
    jcfg = JLoopConfig.reference_exact(**kw)
    jout = jax.jit(lambda c, m, p, v: jcl.verify_loop(c, m, p, v, query, cand, jcfg))(
        *map(jnp.asarray, (clouds, masks, poses, valid)))

    def no_surfels(*_a, **_k):
        raise AssertionError("the reference-exact branch built a surfel map")

    monkeypatch.setattr(tcl, "_dst_surfel_map", no_surfels)
    tout = tcl.verify_loop(T(clouds), T(masks), T(poses), T(valid), query, cand,
                           LoopConfig.reference_exact(**kw), device="cpu")
    j_rel, j_si, j_acc, j_fit = map(N, jout)
    t_rel, t_si, t_acc, t_fit = map(N, tout)
    assert bool(t_acc) == bool(j_acc) is True
    assert abs(float(t_fit) - float(j_fit)) < 1e-3
    np.testing.assert_allclose(t_si, j_si, rtol=1e-3)
    np.testing.assert_allclose(t_si, np.full(6, 1.0 / math.sqrt(max(float(t_fit), 1e-4))),
                               rtol=1e-6)
    np.testing.assert_allclose(t_rel, j_rel, atol=1e-3)


# ---------------------------------------------------------------------------
# the Livox rollout
# ---------------------------------------------------------------------------
def test_livox_rollout_matches_jax(bench):
    """``make_rollout(data, raw_pts, query_mode="merged", num_ds)``, the
    Livox rollout's call (``bench.py: bench_livox``), on the Livox feed's
    world, path and rosette at 2048 rays a scan (1024 iEKF points): the
    arguments reach the same configurations, the staged feed is equal, and
    6 scans from the true start stay within 1 cm of JAX's."""
    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=7)
    traj = Trajectory.circle(radius=8.0, period=40.0, z_amp=0.3)
    cfg = SimConfig(scan_rate=10.0, pattern="livox", livox_n_points=2048, max_range=120.0,
                    gyro_noise=0.001, acc_noise=0.01, seed=7, time_groups=32)
    data = feeds.pack_sequence(simulate_sequence(world, traj, cfg, n_scans=6), traj)
    kw = dict(raw_pts=2048, query_mode="merged", num_ds=1024)
    jctx = bench.make_rollout(data, **kw)
    tctx = feeds.make_rollout(data, device="cpu", **kw)
    assert tctx["odom_cfg"]._asdict() == jctx["odom_cfg"]._asdict()
    assert tctx["map_cfg"]._asdict() == jctx["map_cfg"]._asdict()
    assert tctx["odom_cfg"].query_mode == "merged" and tctx["odom_cfg"].num_ds_points == 1024
    for a, b in zip(tctx["scans"], jctx["scans"]):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    _, jaux = jctx["roll"](jctx["gt_state"](), jctx["scans"], jctx["imus"])
    _, taux = tctx["roll"](tctx["gt_state"](), tctx["scans"], tctx["imus"])
    jp, tp = np.asarray(jaux["p"]), N(taux["p"])
    assert tp.shape == jp.shape == (6, 3)
    np.testing.assert_allclose(tp, jp, atol=1e-2)
    assert N(taux["n_matched"])[2:].min() > 100


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------
def _bench_oracle_loops(kf_st, times, gt):
    """``bench.py:955-971`` transcribed: each keyframe's scan, then the GT
    loop factors with the shipped gating (radius 10 m, gap 4 s), one per
    (later) keyframe."""
    n = len(kf_st)
    scan_of_kf = np.clip(
        np.round((kf_st - times[0]) / 0.1).astype(int), 0, len(times) - 1
    )
    Tgt = gt[scan_of_kf]
    pos_gt = Tgt[:, :3, 3]
    li, lj, lrel = [], [], []
    for i in range(n):
        d = np.linalg.norm(pos_gt[:i] - pos_gt[i], axis=1)
        ok = np.where((d < 10.0) & (kf_st[i] - kf_st[:i] > 4.0))[0]
        if len(ok):
            j = int(ok[np.argmin(d[ok])])
            li.append(i)
            lj.append(j)
            lrel.append(np.linalg.inv(Tgt[i]) @ Tgt[j])
    return li, lj, lrel, pos_gt


def _circuit(rng, n_scans=240, n_kf=30):
    """Two laps of a 60 m square circuit at 10 Hz (ground truth), and a
    loop-free engine's graph over keyframes every 4 scans: an odometry
    chain that drifts in yaw and along track."""
    t = np.arange(n_scans) * 0.1 + 1000.0
    s = (np.arange(n_scans) / (n_scans / 2)) % 1.0 * 4.0  # side coordinate, 2 laps
    side = np.floor(s).astype(int)
    u = (s - side) * 60.0
    xy = np.stack([np.select([side == 0, side == 1, side == 2, side == 3],
                             [u, np.full_like(u, 60.0), 60.0 - u, np.zeros_like(u)]),
                   np.select([side == 0, side == 1, side == 2, side == 3],
                             [np.zeros_like(u), u, np.full_like(u, 60.0), 60.0 - u])], 1)
    yaw = side * (np.pi / 2)
    gt = np.tile(np.eye(4), (n_scans, 1, 1))
    gt[:, 0, 0], gt[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    gt[:, 1, 0], gt[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    gt[:, :2, 3] = xy
    scans = np.arange(0, n_scans, n_scans // n_kf)
    odom = [gt[scans[0]].astype(np.float32)]
    for a, b in zip(scans[:-1], scans[1:]):
        rel = np.linalg.inv(gt[a]) @ gt[b]
        d = rng.normal(size=6) * np.array([0.05, 0.05, 0.01, 0.002, 0.002, 0.01])
        dT = np.eye(4)
        c, sn = np.cos(d[5]), np.sin(d[5])
        dT[:2, :2] = [[c, -sn], [sn, c]]
        dT[:3, 3] = d[:3] + np.array([0.03, 0.0, 0.0])
        odom.append((odom[-1] @ rel @ dT).astype(np.float32))
    return gt, t, scans, np.stack(odom)


def _oracle_engine(tmp_path, rng):
    """A loop-free port engine whose graph and keyframes are the drifted
    circuit's, and that circuit's ground truth written as a KITTI
    sequence (poses and times)."""
    gt, t, scans, odom = _circuit(rng)
    seq = tmp_path / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    np.savetxt(seq / "times.txt", t)
    (tmp_path / "poses").mkdir()
    np.savetxt(tmp_path / "poses" / "00.txt", gt[:, :3, :].reshape(len(gt), 12))
    K = len(scans)
    e = exp_loop_trust.make_longrun_engine(device="cpu")
    e.pgo_cfg = e.pgo_cfg._replace(max_keyframes=128, max_between=256)
    e.reset()
    rel = np.linalg.inv(odom[:-1]) @ odom[1:]
    si = np.tile(np.float32([10.0] * 3 + [100.0] * 3), (K - 1, 1))
    from fastliosam_tpu_torch.pgo import from_arrays

    e.graph = from_arrays(e.pgo_cfg, odom, bt_i=np.arange(K - 1), bt_j=np.arange(1, K),
                          bt_rel=rel.astype(np.float32), bt_sqrt_info=si, device="cpu")
    e._n_bt_host = K - 1
    e.kf.n = K
    e.kf.stamps[:K] = torch.from_numpy(t[scans].astype(np.float32))
    return e, gt, t


def test_oracle_loops_match_bench(tmp_path, rng):
    e, gt, t = _oracle_engine(tmp_path, rng)
    kf_st = N(e.kf.stamps[: e.kf.n]).astype(np.float64)
    li, lj, lrel, pos_gt = exp_loop_trust.oracle_loops(kf_st, t, gt)
    bli, blj, blrel, bpos = _bench_oracle_loops(kf_st, t, gt)
    assert li == bli and lj == blj and len(li) > 10
    np.testing.assert_array_equal(lrel, np.asarray(blrel, np.float32).reshape(-1, 4, 4))
    np.testing.assert_array_equal(pos_gt, bpos)
    # the gating: within 10 m, more than 4 s before, the nearest
    d = np.linalg.norm(pos_gt[li] - pos_gt[lj], axis=1)
    assert np.all(d < 10.0) and np.all(kf_st[li] - kf_st[lj] > 4.0)


def test_longrun_oracle_solve_matches_jax(tmp_path, rng, monkeypatch):
    """``longrun_oracle`` on the drifted circuit against the bench's graph
    solved by JAX's ``from_arrays`` and ``solve`` at the oracle's
    configuration: the same loops and graph, the solved keyframe positions
    within 1e-3 m, the keyframe ATEs from those positions, the solved ATE
    below the odometry's."""
    from fastliosam_tpu_torch import pgo as tpgo
    from fastliosam_tpu_torch.eval import align_umeyama

    solved = []

    def recorded(g, cfg, **kw):
        out = port_solve(g, cfg, **kw)
        solved.append((g, cfg, out[0]))
        return out

    port_solve = tpgo.solve
    monkeypatch.setattr(tpgo, "solve", recorded)
    e, gt, t = _oracle_engine(tmp_path, rng)
    out = exp_loop_trust.longrun_oracle(e, tmp_path, save_to=tmp_path / "oracle_graph.npz")
    assert set(out) == {"oracle_loops_injected", "oracle_odom_kf_ate_m",
                        "oracle_solved_kf_ate_m", "oracle_solve_s"}
    (tg0, tcfg, tg), = solved
    n = e.kf.n
    kf_st = N(e.kf.stamps[:n]).astype(np.float64)
    li, lj, lrel, pos_gt = _bench_oracle_loops(kf_st, t, gt)
    assert out["oracle_loops_injected"] == len(li) > 10
    g = e.graph
    nb = e._n_bt_host
    bt_i = np.concatenate([N(g.bt_i)[:nb], np.asarray(li)])
    bt_j = np.concatenate([N(g.bt_j)[:nb], np.asarray(lj)])
    bt_rel = np.concatenate([N(g.bt_rel)[:nb], np.asarray(lrel, np.float32).reshape(-1, 4, 4)])
    si_loop = np.tile(np.asarray([[100.0] * 3 + [1000.0] * 3], np.float32), (len(li), 1))
    bt_si = np.concatenate([N(g.bt_sqrt_info)[:nb], si_loop])
    jcfg = JPoseGraphConfig(**e.pgo_cfg._asdict())._replace(lm_iters=32, pcg_iters=768,
                                                             loop_gnc_barc=0.0)
    assert tcfg._asdict() == jcfg._asdict()
    poses0 = N(g.poses)
    g_or = jgraph.from_arrays(jcfg, poses0[:n], bt_i=bt_i, bt_j=bt_j, bt_rel=bt_rel,
                              bt_sqrt_info=bt_si)
    for a, b in zip(tg0, g_or):  # the graph the port solved is the bench's
        np.testing.assert_array_equal(N(a), np.asarray(b))
    g_or, _ = jax.jit(lambda gg: jsolver.solve(gg, jcfg))(g_or)
    jest = np.asarray(g_or.poses[:n, :3, 3])
    test = N(tg.poses)[:n, :3, 3]
    np.testing.assert_allclose(test, jest, atol=1e-3)

    def kf_ate(est):
        _, R, tt = align_umeyama(est, pos_gt)
        est = est @ R.T + tt
        return float(np.sqrt(np.mean(np.sum((est - pos_gt) ** 2, axis=1))))

    assert out["oracle_odom_kf_ate_m"] == kf_ate(poses0[:n, :3, 3])
    assert out["oracle_solved_kf_ate_m"] == kf_ate(test)
    # the saved graph: the one solved, its configuration and the solution
    z = np.load(tmp_path / "oracle_graph.npz")
    for k, want in (("poses0", poses0[:n]), ("bt_i", bt_i), ("bt_j", bt_j), ("bt_rel", bt_rel),
                    ("bt_sqrt_info", bt_si), ("solved_xyz", test), ("pos_gt", pos_gt)):
        np.testing.assert_array_equal(z[k], want, err_msg=k)
    assert int(z["n_odom"]) == nb
    assert json.loads(str(z["cfg"])) == tcfg._asdict()
    assert abs(out["oracle_solved_kf_ate_m"] - kf_ate(jest)) < 1e-3
    assert out["oracle_solved_kf_ate_m"] < 0.5 * out["oracle_odom_kf_ate_m"]
    assert out["oracle_solve_s"] > 0.0


@pytest.mark.slow
def test_livox_jax_reading(bench):
    """The JAX package's Livox reading on the CPU at full width
    (``bench.py: bench_livox``: 43 scans of the 8192-ray rosette, 4096 iEKF
    points, the merged stencil, a 2^19-slot map, from the true start), kept
    in ``chip_smoke.py`` as ``LIVOX_JAX_ATE_M``: phase 16 gates the port's
    card reading below max(0.10 m, this + 1 cm). Prints the reading."""
    import sys

    data = feeds.build_livox_sequence()
    ctx = bench.make_rollout(data, raw_pts=8192, query_mode="merged", num_ds=4096)
    _, aux = ctx["roll"](ctx["gt_state"](), ctx["scans"], ctx["imus"])
    p = np.asarray(aux["p"])
    err = np.linalg.norm(p - data["gt_p"][: ctx["S"]], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    print(f"JAX Livox ATE on the CPU: {ate:.6f} m over {ctx['S']} scans, matched from scan 3 "
          f"{int(np.asarray(aux['n_matched'])[2:].min())}+")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert abs(ate - chip_smoke.LIVOX_JAX_ATE_M) < 5e-5


# the oracle's graph as the port built it on the H100: ``chip_smoke.py``
# phase 16 (``ORACLE_GRAPH``) on phase 8's loop-free engine, 287 true loops
CARD_ORACLE_GRAPH = REPO / "tests" / "data" / "oracle_graph_h100.npz"


def _kf_ate(est, pos_gt) -> float:
    from fastliosam_tpu_torch.eval import align_umeyama

    _, R, t = align_umeyama(est, pos_gt)
    est = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - pos_gt) ** 2, axis=1))))


@pytest.mark.slow
def test_oracle_card_graph_solves():
    """The long-run oracle's graph as the port built it on the H100
    (``CARD_ORACLE_GRAPH``: the keyframe poses, every factor, the solve's
    configuration, the card's solved and the true keyframe positions),
    solved on the CPU by JAX's ``from_arrays`` and ``solve`` and by the port
    at that configuration (32 LM / 768 PCG, no GNC). The three solutions'
    keyframe ATEs within 1e-3 m of each other; their positions within 5e-3
    m (the 30-keyframe square's 1e-3 m is too tight here: 859 factors
    summed in three float32 orders over 32 x 768 iterations, keyframes up
    to ~100 m out; the first reading was 1.44e-3 m CPU to CPU, 3.55e-3 m
    card to CPU). Prints the ATEs (PERF.md §7)."""
    from fastliosam_tpu_torch import pgo as tpgo

    z = np.load(CARD_ORACLE_GRAPH)
    cfg = json.loads(str(z["cfg"]))
    poses0, pos_gt, card = z["poses0"], z["pos_gt"], z["solved_xyz"]
    n = len(poses0)
    factors = {k: z[k] for k in ("bt_i", "bt_j", "bt_rel", "bt_sqrt_info")}
    jcfg = JPoseGraphConfig(**cfg)
    jg = jgraph.from_arrays(jcfg, poses0, **factors)
    jg, _ = jax.jit(lambda gg: jsolver.solve(gg, jcfg))(jg)
    jest = np.asarray(jg.poses[:n, :3, 3])
    tcfg = PoseGraphConfig(**cfg)
    tg = tpgo.from_arrays(tcfg, poses0, **factors, device="cpu")
    tg, _ = tpgo.solve(tg, tcfg, device="cpu")
    test = N(tg.poses)[:n, :3, 3]
    ate = {"odometry": _kf_ate(poses0[:, :3, 3], pos_gt), "jax_cpu": _kf_ate(jest, pos_gt),
           "port_cpu": _kf_ate(test, pos_gt), "port_card": _kf_ate(card, pos_gt)}
    print(f"oracle on the card's graph: {n} keyframes, {len(factors['bt_i'])} factors "
          f"({len(factors['bt_i']) - int(z['n_odom'])} loops); keyframe ATE (m) {ate}; "
          f"port CPU - JAX CPU {np.abs(test - jest).max():.3e} m, card - port CPU "
          f"{np.abs(card - test).max():.3e} m")
    assert max(ate[k] for k in ("jax_cpu", "port_cpu", "port_card")) - min(
        ate[k] for k in ("jax_cpu", "port_cpu", "port_card")) < 1e-3
    np.testing.assert_allclose(test, jest, atol=5e-3)
    np.testing.assert_allclose(card, test, atol=5e-3)
