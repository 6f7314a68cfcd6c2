"""The port's engine in mesh mode: ``tests/test_engine.py::
test_mesh_engine_matches_single_device`` through the port.

``SlamEngine(mesh=make_mesh(4))`` runs in 4 gloo ranks on the CPU
(``tests/_torch_mesh_worker.py``, no JAX): odometry over the slot-sharded
map, the per-scan loop detection of the chunked path, the point-sharded
loop ICP and the factor-sharded solve, over the JAX test's loop-closing
feed (55 scans, chunk 5). References: the port's replicated engine with
the same loop semantics (untrimmed ICP of a fixed length,
``convergence_eps=0``, as the JAX test pins) and JAX's replicated engine,
and JAX's engine on a 4-device mesh (``make_mesh(4)`` of ``conftest.py``'s
8 virtual devices).

Gates (the JAX test's): the same keyframe count, loop pairs and solve
count; the realtime trajectory within 0.05 m of each reference at every
scan. The mesh engine against the port's replicated engine runs the same
odometry bit for bit (the sharded map's owner rows are the replicated
rows); they part only where the loop ICP's and the solve's psums sum in
another order. Every rank's trajectory is rank 0's bit for bit, and a
replay from ``reset()`` is the first run's bit for bit.
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import parallel as jpar  # noqa: E402
from fastliosam_tpu.loop import LoopConfig  # noqa: E402
from fastliosam_tpu.map import VoxelMapConfig  # noqa: E402
from fastliosam_tpu.odom import OdomConfig  # noqa: E402
from fastliosam_tpu.pgo import PoseGraphConfig  # noqa: E402
from fastliosam_tpu.runtime import EngineConfig, SlamEngine  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from tests.test_engine import _chunked_feed  # noqa: E402

from _torch_mesh_worker import build_engine, run_engine, spawn_ranks  # noqa: E402

CHUNK = 5
# tests/test_engine.py: test_mesh_engine_matches_single_device's engine
CFGS = dict(
    odom_cfg=dict(point_filter_num=1, blind=0.5, filter_size_surf=0.3, num_ds_points=1024,
                  evict_every=10_000, query_mode="merged3"),
    map_cfg=dict(capacity=1 << 14, voxel_size=0.4, min_points=4),
    loop_cfg=dict(radius=6.0, time_gap=4.0, num_submap_keyframes=2, voxel_res=0.25,
                  submap_points=4096, max_iterations=15, nn_chunk=512,
                  trim_fraction=1.0, convergence_eps=0.0),
    pgo_cfg=dict(max_keyframes=64, max_between=128, max_gps=16, lm_iters=6, pcg_iters=64),
    cfg=dict(keyframe_threshold=0.5, loop_check_every=5, kf_cloud_points=1024,
             kf_cloud_voxel=0.25),
)
JAX_CLS = dict(odom_cfg=OdomConfig, map_cfg=VoxelMapConfig, loop_cfg=LoopConfig,
               pgo_cfg=PoseGraphConfig, cfg=EngineConfig)


@pytest.fixture(scope="module")
def feed():
    """The JAX test's feed: 1.37 laps of a 5 m circle in a 24 m room."""
    world = PlaneWorld.room(size=24.0, height=6.0, n_boxes=8, seed=5)
    traj = Trajectory.circle(radius=5.0, period=8.0)
    sim_cfg = SimConfig(scan_rate=5.0, n_azimuth=256, n_elev=10, gyro_noise=0.001,
                        acc_noise=0.01, gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=7)
    data = simulate_sequence(world, traj, sim_cfg, n_scans=55)
    chunks = _chunked_feed(data, chunk=CHUNK)
    R0, p0 = traj.pose(0.0)
    inp = {
        "engine.cfgs": json.dumps(CFGS), "engine.chunk": np.int64(CHUNK),
        "engine.dt": np.float32(data["scan_dt"]),
        "engine.R0": np.asarray(R0, np.float32), "engine.p0": np.asarray(p0, np.float32),
        "engine.v0": np.asarray(traj.velocity(0.0), np.float32),
        "engine.stamps": np.concatenate([c[2] for c in chunks]),
    }
    for k, i in (("xyz", 0), ("toff", 1), ("mask", 2)):
        inp[f"engine.{k}"] = np.concatenate([np.asarray(c[0][i]) for c in chunks])
    for k, i in (("t", 0), ("g", 1), ("a", 2), ("m", 3)):
        inp[f"engine.imu_{k}"] = np.concatenate([np.asarray(c[1][i]) for c in chunks])
    return data, chunks, inp


@pytest.fixture(scope="module")
def mesh_job(feed, tmp_path_factory):
    """The engine case on 4 gloo ranks, started at once: the references
    run in this process meanwhile. Returns the function that waits."""
    d = tmp_path_factory.mktemp("mesh_engine")
    path = str(d / "inputs.npz")
    np.savez(path, **feed[2])
    return spawn_ranks(4, path, str(d / "out"), ["engine"], timeout=600, wait=False)


@pytest.fixture(scope="module")
def mesh_run(mesh_job):
    """Rank outputs of the engine case."""
    return mesh_job()


def _run_jax(feed, mesh):
    data, chunks, inp = feed
    eng = SlamEngine(**{k: JAX_CLS[k](**v) for k, v in CFGS.items()}, mesh=mesh)
    eng.odom = eng.odom._replace(nav=eng.odom.nav._replace(
        R=jnp.asarray(inp["engine.R0"]), p=jnp.asarray(inp["engine.p0"]),
        v=jnp.asarray(inp["engine.v0"])))
    for scans, imus, stamps in chunks:
        eng.process_chunk(scans, imus, stamps, data["scan_dt"])
    eng.finish()
    return eng, np.stack(eng.realtime_traj)


def _check(o, n_kf, loops, solves, traj):
    assert int(o["engine.kf_n"]) == n_kf
    assert [tuple(p) for p in o["engine.loops"].tolist()] == [tuple(p) for p in loops]
    assert int(o["engine.solves"]) == solves
    np.testing.assert_allclose(o["engine.traj"][:, :3, 3], traj[:, :3, 3], rtol=0, atol=0.05)


@pytest.fixture(scope="module")
def port_run(feed, mesh_job):
    """The port's replicated engine over the feed (while the ranks run)."""
    eng = build_engine(feed[2], device="cpu")
    return eng, run_engine(eng, feed[2], CHUNK)


def test_loop_device_without_that_card_verifies_on_the_engine_device(feed, port_run):
    """EngineConfig.loop_device = 1 on a machine without a second card: the
    verification runs on the engine's device, and the run is the
    loop_device = None run bit for bit."""
    eng0, traj0 = port_run
    inp = dict(feed[2])
    cfgs = json.loads(inp["engine.cfgs"])
    cfgs["cfg"]["loop_device"] = 1
    inp["engine.cfgs"] = json.dumps(cfgs)
    eng = build_engine(inp, device="cpu")
    assert eng._verify_device() == eng.device
    traj = run_engine(eng, inp, CHUNK)
    assert eng.loop_pairs == eng0.loop_pairs and len(eng.loop_pairs) >= 1
    assert eng.loop_attempts == eng0.loop_attempts
    assert np.array_equal(traj, traj0)
    assert np.array_equal(eng.keyframe_poses(), eng0.keyframe_poses())


def test_loop_device_picks_that_card_without_a_mesh(feed, monkeypatch):
    """With that card present and no mesh, verification goes to
    ``cuda:{loop_device}`` (fastliosam_tpu/runtime/engine.py:332-338)."""
    inp = dict(feed[2])
    cfgs = json.loads(inp["engine.cfgs"])
    cfgs["cfg"]["loop_device"] = 1
    inp["engine.cfgs"] = json.dumps(cfgs)
    eng = build_engine(inp, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert eng._verify_device() == torch.device("cuda", 1)
    eng.mesh = object()  # a mesh verifies on the rank's own device
    assert eng._verify_device() == eng.device


def test_mesh_engine_matches_port_single_device(port_run, jax_runs, mesh_run):
    eng, traj = port_run
    assert len(eng.loop_pairs) >= 1, "feed must exercise loop closure"
    _check(mesh_run[0], eng.kf.n, eng.loop_pairs, eng.solve_count, traj)


@pytest.fixture(scope="module")
def jax_runs(feed, mesh_job):
    """JAX's replicated engine and JAX's engine on a 4-device mesh (while
    the ranks run)."""
    return {ref: _run_jax(feed, jpar.make_mesh(4) if ref == "jax_mesh4" else None)
            for ref in ("jax", "jax_mesh4")}


@pytest.mark.parametrize("ref", ["jax", "jax_mesh4"])
def test_mesh_engine_matches_jax(jax_runs, mesh_run, ref):
    eng, traj = jax_runs[ref]
    assert len(eng.loop_pairs) >= 1
    _check(mesh_run[0], eng.kf.n, eng.loop_pairs, eng.solve_count, traj)


def test_mesh_engine_ranks_agree_and_replay(mesh_run):
    o0 = mesh_run[0]
    assert o0["engine.collectives"] > 0
    for o in mesh_run:
        for k in ("engine.traj", "engine.kf_poses", "engine.loops", "engine.solves"):
            assert np.array_equal(o[k], o0[k]), k
        assert np.array_equal(o["engine.replay"], o["engine.traj"])
        assert np.array_equal(o["engine.replay_loops"], o["engine.loops"])
