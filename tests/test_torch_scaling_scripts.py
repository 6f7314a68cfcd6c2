"""The port's scaling scripts (``bench_scaling``, ``bench_crossover``,
``bench_pp_overlap``), their rank launcher, ``eval/feeds.py:
_fixes_from_data`` and ``utils/timing.py: torch_trace`` against the JAX
package's, on the CPU (gloo ranks, the kernels' plain versions).

Tolerances, each with its reason:
  * the scaling timers' results (the port at 1 and 2 ranks against JAX's
    own ``scripts/bench_scaling.py`` timers on a 1-device mesh, K = 64,
    1024 ICP points): the candidate index equal. The solve's cost and the
    ICP's fitness are float32 rounding noise on these inputs, so the
    relative 1e-4 (cost) and 1e-5 (fitness) first planned cannot hold, and
    the test holds what can:
      - ``build_graph``'s poses satisfy every factor exactly, so the start
        cost is the rounding of the residuals (JAX 8.6e-10, the port
        1.1e-9) and the solved one too (JAX 5.30e-10, the port 7.84e-10 at
        1 and 2 ranks). Both solved costs lie below 1e-8 and within an
        absolute 1e-9 of each other (measured 2.5e-10), and the port's
        solved cost lies within a relative 1e-4 across rank counts;
      - both ICPs converge to the true offset (their transforms agree to
        4.8e-7 m from the 10th of 50 iterations on); the fitness is then
        the rounding of the squared distances at coordinates up to 40 m
        (JAX 3.20e-6, the port 1.62e-5 / 1.57e-5 at 1 / 2 ranks). Both lie
        below 1e-4 and within an absolute 2e-5 of each other (measured
        1.30e-5);
  * one chunk of ``bench_pp_overlap``'s odometry (after its warm chunk)
    and its verification, on the script's own draws at ``--pts 512
    --submap 1024``, against JAX's ``odom_rollout`` and ``verify_loop``:
    poses within 1e-4 m (the odometry parity tolerance of
    ``tests/test_torch_odom.py``; measured 8.6e-6), ``accepted`` equal,
    fitness within 1e-4 (measured 1.7e-6);
  * ``_fixes_from_data`` on the bench's corridor feed (30 scans): stamps
    and covariances equal; each fix converted back to ENU in float64
    within 0.6 m of JAX's. Both packages run the geodesy in float32, where
    one ulp of an ECEF coordinate between 4.2e6 and 8.4e6 m is 0.5 m; over
    the whole 400-scan corridor (396 fixes) the packages differ by at most
    0.5 m, exactly one such ulp (measured; mean 0.038 m).
"""
import importlib.util
import json
import os
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from fastliosam_tpu.loop import LoopConfig as JLoopConfig  # noqa: E402
from fastliosam_tpu.loop import verify_loop as jverify_loop  # noqa: E402
from fastliosam_tpu.map import VoxelMapConfig as JVoxelMapConfig  # noqa: E402
from fastliosam_tpu.odom import ImuBatch as JImuBatch  # noqa: E402
from fastliosam_tpu.odom import OdomConfig as JOdomConfig  # noqa: E402
from fastliosam_tpu.odom import Scan as JScan  # noqa: E402
from fastliosam_tpu.odom import init_odom as jinit_odom  # noqa: E402
from fastliosam_tpu.odom.pipeline import odom_rollout as jodom_rollout  # noqa: E402
from fastliosam_tpu.pgo import PoseGraphConfig as JPoseGraphConfig  # noqa: E402
from fastliosam_tpu_torch.eval import feeds  # noqa: E402
from fastliosam_tpu_torch.scripts import (  # noqa: E402
    _ranks, bench_crossover, bench_pp_overlap, bench_scaling)
from fastliosam_tpu_torch.utils import geometry_precision  # noqa: E402
from fastliosam_tpu_torch.utils import timing as ttiming  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
K, ICP_POINTS = 64, 1024
SCALING_ARGS = ["--cpu", "2", "--keyframes", str(K), "--icp-points", str(ICP_POINTS),
                "--devices", "1", "2"]
CROSSOVER_ARGS = ["--cpu", "2", "--sizes", "64", "--devices", "1", "2"]
PP_ARGS = ["--cpu", "1", "--pts", "512", "--submap", "1024", "--n-chunks", "2"]
GPS_SCANS = 30


def _jax_script(path):
    """A JAX script of the repo, imported from its file (the environment
    it sets at import restored)."""
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


def _main_json(module, argv, path):
    assert module.main(argv + ["--out", str(path)]) == 0
    return json.loads(Path(path).read_text())


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """The two rank scripts' ``main`` at ``--cpu 2``, started together in
    the background (their ranks are processes) while the JAX side runs."""
    d = tmp_path_factory.mktemp("scaling")
    ex = ThreadPoolExecutor(max_workers=2)
    jobs = {"scaling": ex.submit(_main_json, bench_scaling, SCALING_ARGS, d / "scaling.json"),
            "crossover": ex.submit(_main_json, bench_crossover, CROSSOVER_ARGS,
                                   d / "crossover.json")}
    ex.shutdown(wait=False)
    return jobs


@pytest.fixture(scope="module")
def jax_timers():
    """JAX's own timers of ``scripts/bench_scaling.py`` on a 1-device mesh."""
    jbs = _jax_script(REPO / "scripts" / "bench_scaling.py")
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("kf",))
    cfg = JPoseGraphConfig(max_keyframes=K, max_between=2 * K, max_gps=8, lm_iters=4,
                           pcg_iters=64)
    return {"pgo_solve": jbs.time_solve(jbs.build_graph(cfg, K), cfg, mesh)[1],
            "loop_icp": jbs.time_loop_icp(ICP_POINTS, mesh)[1],
            "loop_detect": jbs.time_detect(max(K, 4096), mesh)[1]}


# ---------------------------------------------------------------------------
# bench_scaling
# ---------------------------------------------------------------------------
def test_scaling_timers_match_jax(rank_runs, jax_timers):
    out = rank_runs["scaling"].result(timeout=600)
    for key in ("pgo_solve", "loop_icp", "loop_detect"):
        assert [r["devices"] for r in out[key]] == [1, 2]
        for row in out[key]:
            # every rank of the mesh computes the same result
            assert row["aux_by_rank"] == [row["aux"]] * row["devices"], key
    want = jax_timers
    costs = [r["aux"] for r in out["pgo_solve"]]
    assert max(costs) < 1e-8 and want["pgo_solve"] < 1e-8
    np.testing.assert_allclose(costs, want["pgo_solve"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(costs, costs[0], rtol=1e-4)
    assert max(costs) <= out["pgo_start_cost"]
    for row in out["pgo_solve"]:  # the LM never ends above the cost it starts from
        assert row["aux"] <= row["start_cost"] and row["pose_dev_m"] <= 1e-4
    fits = [r["aux"] for r in out["loop_icp"]]
    assert max(fits) < 1e-4 and want["loop_icp"] < 1e-4
    np.testing.assert_allclose(fits, want["loop_icp"], rtol=0, atol=2e-5)
    assert [r["aux"] for r in out["loop_detect"]] == [want["loop_detect"]] * 2


def test_scaling_json_keys(rank_runs):
    out = rank_runs["scaling"].result(timeout=600)
    jax_keys = {"keyframes", "icp_points", "backend", "virtual_devices", "host_cores",
                "pgo_solve", "loop_icp", "loop_detect"}
    assert jax_keys | {"cards", "ranks_per_card"} <= set(out)
    assert (out["keyframes"], out["icp_points"], out["backend"]) == (K, ICP_POINTS, "cpu")
    assert out["virtual_devices"] is True and out["dist_backend"] == "gloo"
    for key in ("pgo_solve", "loop_icp", "loop_detect"):
        t1 = out[key][0]["ms"]
        for row in out[key]:
            assert {"devices", "ms", "speedup", "efficiency"} <= set(row)
            assert row["ms"] > 0
            assert row["speedup"] == pytest.approx(t1 / row["ms"], rel=1e-2, abs=2e-3)
            assert row["efficiency"] == pytest.approx(
                row["speedup"] / row["devices"], rel=1e-2, abs=2e-3)
    # the ICP is point-sharded: each rank's collectives a call, 50 steps + 1
    assert [r["collectives_per_call"] for r in out["loop_icp"]] == [51.0, 51.0]


# ---------------------------------------------------------------------------
# bench_crossover
# ---------------------------------------------------------------------------
def test_crossover_json(rank_runs):
    out = rank_runs["crossover"].result(timeout=600)
    assert {"host_cores", "backend", "stages"} <= set(out)
    assert list(out["stages"]) == ["loop_detect", "submap_gather", "pgo_solve", "voxel_query"]
    payload = {"loop_detect": 4 * 4 + 2 * 4 * 2,
               "submap_gather": 11 * 1024 * 3 * 4 + 11 * 1024 * 4,
               "pgo_solve": 4 * 64 * (64 * 6 * 4 + 8),
               "voxel_query": 3 * (8192 * 4 + 8192 * 10 * 4)}
    for stage, rows in out["stages"].items():
        (row,) = rows
        assert {"K", "single_ms", "sharded_ms", "collective_bytes", "within_1p2x"} <= set(row)
        assert row["K"] == 64 and set(row["sharded_ms"]) == {"1", "2"}
        times = [row["single_ms"], *row["sharded_ms"].values()]
        assert all(np.isfinite(t) and t > 0 for t in times), stage
        assert row["collective_bytes"] == payload[stage]
        assert row["within_1p2x"] == sorted(
            int(n) for n, ms in row["sharded_ms"].items() if ms <= 1.2 * row["single_ms"])
        assert len(row["sharded_launches"]["2"]) == 2


def test_crossover_draws_follow_jax_order():
    """Each stage's draws from the shared ``default_rng(0)``, taken in the
    ranks' order (stage by stage, for each size the single twin's and then
    each rank count's), equal the JAX script's expressions in its order."""
    sizes, counts = [64, 128], [1, 2]
    port, ref = np.random.default_rng(0), np.random.default_rng(0)
    jax_draw = {  # scripts/bench_crossover.py:113, :138, :181 (the PGO stage draws nothing)
        "loop_detect": lambda K: ref.uniform(-500, 500, (K, 3)).astype(np.float32),
        "submap_gather": lambda K: ref.normal(size=(K, 1024, 3)).astype(np.float32),
        "pgo_solve": lambda K: None,
        "voxel_query": lambda K: np.stack([
            ref.uniform(-40, 40, 8192), ref.uniform(-40, 40, 8192),
            0.05 * ref.standard_normal(8192)], 1).astype(np.float32),
    }
    assert bench_crossover.STAGES == tuple(jax_draw)
    for stage in bench_crossover.STAGES:
        for K in sizes:
            for _ in range(1 + len(counts)):
                got, want = bench_crossover.draw(stage, port, K), jax_draw[stage](K)
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# bench_pp_overlap
# ---------------------------------------------------------------------------
def test_pp_overlap_chunk_matches_jax():
    chunk, pts, sub = 5, 512, 1024
    xyz, kf = bench_pp_overlap.draws(chunk, pts, sub)
    imu = bench_pp_overlap.imu_arrays(chunk)
    assert not imu["mask"].any()  # the odometry propagates an empty IMU batch
    mc = JVoxelMapConfig(**bench_pp_overlap.MAP_CFG)
    oc = JOdomConfig(**bench_pp_overlap.ODOM_CFG)
    lc = JLoopConfig(**bench_pp_overlap.loop_cfg_kwargs(sub))
    scans = JScan(xyz=jnp.asarray(xyz), t_offset=jnp.zeros((chunk, pts), jnp.float32),
                  mask=jnp.ones((chunk, pts), bool))
    imus = JImuBatch(**{k: jnp.asarray(v) for k, v in imu.items()})
    roll = jax.jit(lambda st: jodom_rollout(st, scans, imus, jnp.float32(0.1), oc, mc))
    warm, _ = roll(jinit_odom(mc, oc))
    j_st, j_aux = roll(warm)
    n_kf = bench_pp_overlap.N_KF
    poses = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n_kf, 4, 4))
    j_rel, _, j_acc, j_fit = jax.jit(lambda cl, mk: jverify_loop(
        cl, mk, poses, jnp.ones((n_kf,), bool), jnp.int32(bench_pp_overlap.QUERY),
        jnp.int32(bench_pp_overlap.CAND), lc))(jnp.asarray(kf), jnp.ones(kf.shape[:2], bool))

    cpu = torch.device("cpu")
    prog = bench_pp_overlap.programs(chunk, pts, sub, cpu)
    with geometry_precision():
        st = prog["roll"](prog["roll"](prog["init"]()))
        rel, _, acc, fit = prog["verify"](cpu)
    np.testing.assert_allclose(st.nav.p.numpy(), np.asarray(j_st.nav.p), atol=1e-4)
    np.testing.assert_allclose(st.nav.R.numpy(), np.asarray(j_st.nav.R), atol=1e-4)
    assert bool(acc) == bool(j_acc)
    np.testing.assert_allclose(float(fit), float(j_fit), atol=1e-4)
    np.testing.assert_allclose(rel.numpy(), np.asarray(j_rel), atol=1e-4)


def test_pp_overlap_main_on_the_cpu(tmp_path):
    out = _main_json(bench_pp_overlap, PP_ARGS, tmp_path / "pp.json")
    jax_keys = {"metric", "backend", "n_chunks", "odom_only_s", "same_device_s",
                "split_device_s", "verify_cost_hidden_frac", "speedup"}
    assert jax_keys <= set(out) and out["metric"] == "pp_loop_overlap"
    assert out["odom_only_s"] > 0 and out["same_device_s"] > 0
    assert (out["split_device_s"], out["verify_cost_hidden_frac"], out["speedup"]) == (
        None, None, None)
    assert "2 CUDA devices" in out["split"]
    runs = out["accepted_by_run"]["same_device"]
    assert len(runs) == 3 and all(len(r) == 2 for r in runs)
    assert len({f for r in runs for f in r}) == 1  # the same flag in every chunk
    assert out["accepted_by_run"]["split_device"] == []


# ---------------------------------------------------------------------------
# the rank launcher, the device policy, the GPS fixes, the trace
# ---------------------------------------------------------------------------
def test_failed_rank_fails_the_run():
    """A rank that raises fails the whole run: nothing falls back to fewer
    ranks (these arguments lack the sweep, so every rank raises)."""
    args = Namespace(keyframes=8, icp_points=64, what="all", cpu=2)
    with pytest.raises(RuntimeError, match="ranks failed"):
        _ranks.run(bench_scaling._rank_entry, args, 2, True, timeout_s=120)


@pytest.mark.parametrize("module,argv", [
    (bench_scaling, ["--devices", "1"]), (bench_crossover, ["--sizes", "16"]),
    (bench_pp_overlap, [])], ids=["bench_scaling", "bench_crossover", "bench_pp_overlap"])
def test_scripts_need_cuda_or_cpu(module, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_torch_trace_needs_cuda_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with ttiming.torch_trace(str(tmp_path)):
            pass
    assert not (tmp_path / "trace.json").exists()


def _enu64(lat, lon, alt, origin):
    """WGS84 geodetic -> ENU at ``origin`` in float64 (numpy)."""
    a, e2 = 6378137.0, 6.69437999014e-3

    def ecef(la, lo, h):
        la, lo = np.radians(la), np.radians(lo)
        n = a / np.sqrt(1 - e2 * np.sin(la) ** 2)
        return np.stack([(n + h) * np.cos(la) * np.cos(lo), (n + h) * np.cos(la) * np.sin(lo),
                         (n * (1 - e2) + h) * np.sin(la)], -1)

    la0, lo0 = np.radians(origin[0]), np.radians(origin[1])
    d = ecef(lat, lon, alt) - ecef(*origin)
    sl, cl, so, co = np.sin(la0), np.cos(la0), np.sin(lo0), np.cos(lo0)
    R = np.array([[-so, co, 0.0], [-sl * co, -sl * so, cl], [cl * co, cl * so, sl]])
    return d @ R.T


@pytest.mark.parametrize("degrade", [False, True], ids=["good", "degrade_middle"])
def test_fixes_from_data_matches_bench(degrade):
    data = feeds.build_corridor_sequence(GPS_SCANS)
    bench = _jax_script(REPO / "bench.py")
    want = bench._fixes_from_data(data, degrade_middle=degrade)
    got = feeds._fixes_from_data(data, degrade_middle=degrade)
    assert len(got) == len(want) >= 20
    assert [f.stamp for f in got] == [f.stamp for f in want]
    assert [tuple(f.cov_xyz) for f in got] == [tuple(f.cov_xyz) for f in want]
    if degrade:
        assert {tuple(f.cov_xyz) for f in got} == {(9.0, 9.0, 16.0), (0.25, 0.25, 1.0)}

    def enu(fixes):
        return _enu64(*(np.array([getattr(f, k) for f in fixes]) for k in ("lat", "lon", "alt")),
                      feeds.GPS_ANCHOR)

    np.testing.assert_allclose(enu(got), enu(want), rtol=0, atol=0.6)
