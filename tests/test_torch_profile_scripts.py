"""The port's measurement scripts and public names against the JAX
package's, on the CPU (``--device cpu``: the kernels' plain versions).

Tolerances, each with its reason:
  * ``StageTimer`` stats and summary, ``colorize``, ``build_graph``'s
    arrays, hash slots, fingerprints, sorts, integer scatters and gathers:
    equal (the same numpy or integer arithmetic);
  * the crossover's costs: the PGO parity tolerance of
    ``tests/test_torch_loop_pgo.py`` (relative 1e-3, absolute 1e-4);
  * the odometry stages: the odometry parity tolerance of
    ``tests/test_torch_odom.py`` (poses and deskewed points within 1e-4 m,
    propagated states within 1e-5), and 1e-4 on plane normals and offsets
    of the associations (the same float32 sums in other orders); the
    float scatter-add and row-sum gathers within a relative 1e-6;
  * the map's slot tables equal, its moments within 1e-4 relative.
Every stage of each profile script runs at N = 2048 points, 512
downsampled points, a 2^12-slot map and R = 2 iterations.
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.core import eigh3 as jeigh3  # noqa: E402
from fastliosam_tpu.core import pointcloud as jpc  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu.odom import iekf as jiekf  # noqa: E402
from fastliosam_tpu.odom import imu as jimu  # noqa: E402
from fastliosam_tpu.pgo import graph as jgraph  # noqa: E402
from fastliosam_tpu.pgo import solver as jsolver  # noqa: E402
from fastliosam_tpu.utils import timing as jtiming  # noqa: E402
from fastliosam_tpu_torch.scripts import bench_pgo_crossover, bench_scaling  # noqa: E402
from fastliosam_tpu_torch.scripts import profile_insert, profile_step, profile_step2  # noqa: E402
from fastliosam_tpu_torch.scripts import (  # noqa: E402
    exp_gather, exp_gps_noinit_probe, microbench_gather, profile_pipeline, roofline_odom)
from fastliosam_tpu_torch.utils import timing as ttiming  # noqa: E402

from _torch_parity import N, tree_np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import bench_scaling as jbench_scaling  # noqa: E402

TINY = ["--device", "cpu", "--points", "2048", "--ds-points", "512", "--map-log2", "12",
        "--reps", "2"]


def test_stage_timer_and_colorize_match_jax():
    samples = {"odometry": [0.0123, 0.0311, 0.0207, 0.0099], "solve": [1.5, 0.25],
               "loop": [0.004]}
    jt, tt = jtiming.StageTimer(), ttiming.StageTimer()
    for name, xs in samples.items():
        jt.samples[name].extend(xs)
        tt.samples[name].extend(xs)
    assert tt.stats() == jt.stats()
    assert tt.summary() == jt.summary()
    with tt("timed"):
        pass
    assert tt.stats()["timed"]["count"] == 1
    for color in ("red", "green", "yellow", "blue", "magenta", "no-such-color"):
        assert ttiming.colorize("text", color) == jtiming.colorize("text", color)
    assert ttiming.colorize("text") == jtiming.colorize("text")


def test_public_names():
    import fastliosam_tpu_torch.core as tcore
    import fastliosam_tpu_torch.utils as tutils

    assert tcore.geodesy.LocalCartesian is not None
    assert tutils.StageTimer is ttiming.StageTimer and tutils.colorize is ttiming.colorize


def test_torch_trace_writes_a_trace(tmp_path):
    with ttiming.torch_trace(str(tmp_path), device="cpu"):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("cumsum" in ev.get("name", "") for ev in trace["traceEvents"])


@pytest.mark.parametrize("K", [16, 64])
def test_build_graph_matches_jax(K):
    jcfg = jgraph.PoseGraphConfig(max_keyframes=K, max_between=2 * K, max_gps=8)
    tcfg = bench_pgo_crossover.PoseGraphConfig(**jcfg._asdict())
    jg = jbench_scaling.build_graph(jcfg, K)
    tg = bench_scaling.build_graph(tcfg, K, device="cpu")
    for a, b in zip(tree_np(tg), tree_np(jg)):
        np.testing.assert_array_equal(a, b)


def test_crossover_costs_match_jax(tmp_path):
    out = tmp_path / "crossover.json"
    assert bench_pgo_crossover.main(["--device", "cpu", "--sizes", "16", "32", "--reps", "1",
                                     "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["card"] is None
    assert [r["keyframes"] for r in rec["rows"]] == [16, 32]
    for row in rec["rows"]:
        K = row["keyframes"]
        assert row["dense_device_ops"] is None and row["dense_over_pcg"] > 0
        for mode in ("dense", "pcg"):
            cfg = jgraph.PoseGraphConfig(max_keyframes=K, max_between=2 * K, max_gps=8,
                                         lm_iters=6, pcg_iters=96, linear_solver=mode)
            g = jbench_scaling.build_graph(cfg, K)
            _, jcost = jax.jit(lambda gg, cfg=cfg: jsolver.solve(gg, cfg))(g)
            np.testing.assert_allclose(row[f"{mode}_cost"], float(jcost), rtol=1e-3, atol=1e-4)
            assert row[f"{mode}_cost"] <= row["start_cost"]


def _run(module, argv=()):
    """The script's stages at the tiny size: ``{stage: (record, (carry,
    last output))}``, every stage present and finite."""
    args = profile_step2.parse_args(TINY + list(argv), "", module.STAGES, 2048, 512, 2)
    lines = []
    out = profile_step2.run_script(module.__name__.rsplit(".", 1)[1], args, lambda a, dev: (
        module.stages(module.make_inputs(a.points, a.ds_points, a.map_log2, a.seed, dev))),
        print_fn=lines.append)
    recs = {r["stage"]: (r, res) for r, res in out}
    assert list(recs) == list(module.STAGES)
    assert [json.loads(line)["stage"] for line in lines] == list(module.STAGES)
    for r, _ in recs.values():
        assert r["finite"] and r["device"] == "cpu" and r["host_ms"] > 0
        assert r["device_ms"] is None and r["device_ops"] is None
    return recs


def _jit(fn):
    """``fn()`` compiled as one program (much faster than JAX's eager
    dispatch for the odometry's functions)."""
    return jax.jit(fn)()


def _j(x):
    return jnp.asarray(np.asarray(x))


def _jax_inputs(pts_np, map_cfg, odom_cfg, refresh=True):
    jmc = jvh.VoxelMapConfig(**map_cfg._asdict())
    joc = jodom.OdomConfig(**odom_cfg._asdict())
    n = len(pts_np)
    pts, mask = _j(pts_np), jnp.ones((n,), bool)
    m, _ = jax.jit(lambda p: jvh.insert(jvh.make_map(jmc), jmc, p, mask,
                                        refresh_planes=refresh))(pts)
    imu = jodom.ImuBatch(stamps=_j(np.linspace(0, 0.1, 32, endpoint=False, dtype=np.float32)),
                         gyro=jnp.zeros((32, 3)), acc=_j(np.tile(np.float32([0, 0, 9.81]),
                                                                   (32, 1))),
                         mask=jnp.ones((32,), bool))
    scan = jodom.Scan(xyz=pts, t_offset=jnp.zeros((n,)), mask=mask)
    return SimpleNamespace(mc=jmc, oc=joc, pts=pts, mask=mask, m=m, imu=imu, scan=scan)


def _close_planes(t_out, j_out):
    """Normals and offsets within 1e-4 where both packages found a plane;
    the valid flags equal."""
    tn, td, tv = (N(x) for x in t_out[:3])
    jn, jd, jv = (np.asarray(x) for x in j_out[:3])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tn[tv], jn[jv], atol=1e-4)
    np.testing.assert_allclose(td[tv], jd[jv], atol=1e-4)


def _same_map(tm, jm):
    np.testing.assert_array_equal(N(tm.fp), np.asarray(jm.fp))
    np.testing.assert_allclose(N(tm.moments), np.asarray(jm.moments), rtol=1e-4, atol=1e-4)


def test_profile_step2_stages_match_jax():
    recs = _run(profile_step2)
    assert recs["probe"][0]["fused_into"] == "merged_moments"
    inp = profile_step2.make_inputs(2048, 512, 12, 0, "cpu")
    j = _jax_inputs(inp.pts_np, inp.map_cfg, inp.odom_cfg)
    _same_map(inp.state0.vmap, j.m)
    st0 = jodom.init_odom(j.mc)._replace(vmap=j.m, initialized=jnp.ones((), bool))
    pts_ds, mask_ds = j.pts[:512], j.mask[:512]

    step = jax.jit(lambda s: jodom.odom_step(s, j.scan, j.imu, 0.1, j.oc, j.mc))
    s, p = st0, None
    for _ in range(2):
        s, aux = step(s)
        p = aux["p"]
    np.testing.assert_allclose(N(recs["step"][1][1]), np.asarray(p), atol=1e-4)

    iekf = jax.jit(lambda c: jiekf.iekf_update(st0.nav, c, mask_ds, j.m, j.mc, j.oc))
    c = pts_ds
    for _ in range(2):
        nav, nm = iekf(c)
        c = c + nav.p * 1e-9
    t_nav, t_nm = recs["iekf"][1][1]
    np.testing.assert_allclose(N(t_nav.p), np.asarray(nav.p), atol=1e-4)
    np.testing.assert_allclose(N(t_nav.R), np.asarray(nav.R), atol=1e-4)
    assert abs(int(t_nm) - int(nm)) <= 5

    query = jax.jit(lambda c: jvh.query_planes_merged3(j.m, j.mc, c, mask_ds))
    c = pts_ds
    for _ in range(2):
        q = query(c)
        c = c + q[0] * 1e-9
    _close_planes(recs["query"][1][1], q)

    cv = _j(N(inp.covs))
    for _ in range(2):
        nrm, lam = jeigh3.smallest_eigvec3(cv)
        cv = cv + nrm[:, :, None] * 1e-9
    np.testing.assert_allclose(N(recs["eigh"][1][1][0]), np.asarray(nrm), atol=1e-4)

    ins = jax.jit(lambda c: jvh.insert(j.m, j.mc, c, mask_ds, refresh_planes=False))
    c = pts_ds
    for _ in range(2):
        m2, nd = ins(c)
        c = c + m2.moments[0, :3] * 1e-12
    _same_map(recs["insert"][1][1][0], m2)

    c = j.pts
    for _ in range(2):
        d = jpc.voxel_downsample(jpc.Cloud(c, j.mask), 0.5)
        c = c + d.xyz[:2048] * 1e-9
    np.testing.assert_allclose(N(recs["ds"][1][1].xyz), np.asarray(d.xyz), atol=1e-5)
    np.testing.assert_array_equal(N(recs["ds"][1][1].mask), np.asarray(d.mask))

    @jax.jit
    def imu(c):
        nav, traj = jimu.propagate(st0.nav, j.imu, j.oc, 0.1)
        return jimu.deskew(j.scan.xyz + c * 1e-9, j.scan.t_offset, j.scan.mask, traj, nav, j.oc,
                           j.imu.mask, 0.1)

    c = jnp.zeros((3,))
    for _ in range(2):
        pb = imu(c)
        c = c + pb[0] * 1e-9
    np.testing.assert_allclose(N(recs["imu"][1][1]), np.asarray(pb), atol=1e-4)

    c = jnp.zeros((3,))
    for _ in range(2):
        m2 = jvh.evict_far(j.m, j.mc, c, 150.0)
        c = c + m2.moments[0, :3] * 1e-12
    _same_map(recs["evict"][1][1], m2)


def test_profile_step_components_match_jax():
    recs = _run(profile_step)
    inp = profile_step.make_inputs(2048, 512, 12, 0, "cpu")
    j = _jax_inputs(inp.pts_np, inp.map_cfg, inp.odom_cfg)
    _same_map(inp.vmap, j.m)
    state = jodom.init_odom(j.mc)
    pts_ds, mask_ds = j.pts[:512], j.mask[:512]
    out = {k: v[1][1] for k, v in recs.items()}

    _, aux = _jit(lambda: jodom.odom_step(state, j.scan, j.imu, 0.1, j.oc, j.mc))
    np.testing.assert_allclose(N(out["step"][1]["p"]), np.asarray(aux["p"]), atol=1e-4)
    _same_map(out["insert"][0], _jit(lambda: jvh.insert(j.m, j.mc, j.pts, j.mask))[0])
    _close_planes(out["query_merged"],
                  _jit(lambda: jvh.query_planes_merged(j.m, j.mc, pts_ds, mask_ds)))
    _close_planes(out["query_cached"], _jit(lambda: jvh.query_planes(j.m, j.mc, pts_ds, mask_ds)))
    d = _jit(lambda: jpc.voxel_downsample(jpc.Cloud(j.pts, j.mask), 0.5))
    np.testing.assert_allclose(N(out["ds"].xyz), np.asarray(d.xyz), atol=1e-5)
    c = jpc.compact(jpc.Cloud(j.pts, j.mask))
    np.testing.assert_array_equal(N(out["compact"].xyz), np.asarray(c.xyz))
    nav, _ = _jit(lambda: jimu.propagate(state.nav, j.imu, j.oc, 0.1))
    for name in ("R", "p", "v"):
        np.testing.assert_allclose(N(getattr(out["propagate"][0], name)),
                                   np.asarray(getattr(nav, name)), atol=1e-5)
    nav, _ = _jit(lambda: jiekf.iekf_update(state.nav, pts_ds, mask_ds, j.m, j.mc, j.oc))
    np.testing.assert_allclose(N(out["iekf"][0].p), np.asarray(nav.p), atol=1e-4)


def test_profile_insert_stages_match_jax():
    recs = _run(profile_insert)
    assert recs["find_slots"][0]["fused_into"] == "merged_moments"
    inp = profile_insert.make_inputs(2048, 512, 12, 0, "cpu")
    j = _jax_inputs(inp.pts_np, inp.map_cfg, inp.odom_cfg, refresh=False)
    _same_map(inp.vmap, j.m)
    out = {k: v[1][1] for k, v in recs.items()}
    pts, mask = j.pts[:512], j.mask[:512]
    idx = _j(inp.idx_np)

    _same_map(out["insert"][0],
              _jit(lambda: jvh.insert(j.m, j.mc, pts, mask, refresh_planes=False))[0])
    _close_planes(out["query"], _jit(lambda: jvh.query_planes_merged3(j.m, j.mc, pts, mask)))
    coords = jvh._voxel_coords(pts, 0.5)
    np.testing.assert_array_equal(N(out["hash_fp"][0]), np.asarray(jvh._hash(coords, 1 << 12)))
    np.testing.assert_array_equal(N(out["hash_fp"][1]), np.asarray(jvh._fingerprint(coords)))
    np.testing.assert_allclose(N(out["scatter_add"]),
                               np.asarray(j.m.moments.at[idx].add(jnp.ones((512, 10)))),
                               rtol=1e-6)
    np.testing.assert_array_equal(N(out["scatter_max"]), np.asarray(
        jnp.zeros((1 << 12,), jnp.int32).at[idx].max(jnp.arange(512, dtype=jnp.int32))))
    np.testing.assert_allclose(float(out["gather"]), float(j.m.moments[idx].sum()), rtol=1e-6)
    # torch sums int32 into int64, JAX wraps in int32
    assert int(out["gather_int"]) % 2**32 == int(j.m.fp[idx].sum()) % 2**32
    d = _jit(lambda: jpc.voxel_downsample(jpc.Cloud(j.pts, j.mask), 0.5))
    np.testing.assert_allclose(N(out["ds"].xyz), np.asarray(d.xyz), atol=1e-5)
    np.testing.assert_array_equal(N(out["sort"].values), np.sort(inp.keys_np))
    state = jodom.init_state(None, j.oc)
    nav, traj = _jit(lambda: jimu.propagate(state, j.imu, j.oc, 0.1))
    for name in ("R", "p", "v"):
        np.testing.assert_allclose(N(getattr(out["propagate"][0], name)),
                                   np.asarray(getattr(nav, name)), atol=1e-5)
    pb = _jit(lambda: jimu.deskew(j.pts, _j(N(inp.toff)), j.mask, traj, nav, j.oc, j.imu.mask,
                                  0.1))
    np.testing.assert_allclose(N(out["deskew"]), np.asarray(pb), atol=1e-4)


@pytest.mark.parametrize("module", [profile_step2, profile_step, profile_insert,
                                    bench_pgo_crossover, profile_pipeline, exp_gps_noinit_probe,
                                    roofline_odom, exp_gather, microbench_gather])
def test_scripts_need_cuda_or_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {bench_pgo_crossover: ["--sizes", "16"], exp_gather: ["--xla"]}.get(module, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
