"""The port's mesh mode (``fastliosam_tpu_torch/parallel``) against the JAX
package's: each test of ``tests/test_parallel.py`` through the port.

The port runs as ranks of ``torch.distributed`` on the CPU (gloo), one
process a rank (``tests/_torch_mesh_worker.py``, which imports no JAX):
4 ranks, spawned once for the module with every case; beside them 3 ranks
(factor rows, points and keyframes that are not a multiple of the ranks,
so the port pads them) and 1 rank. The inputs are numpy from a seed. The
references are JAX on a 4-device mesh (``make_mesh(4)`` of the 8 virtual
CPU devices of ``conftest.py``) and JAX's replicated function.

Tolerances are JAX's own (``tests/test_parallel.py``): solve poses 5e-3
and cost 1e-2 relative; gram rtol 1e-4 / atol 1e-3 and the count exact;
detect and the submap window exact (clouds atol 1e-6); ICP n_corr exact,
fitness 1e-5, T 1e-4; the map's fingerprints exact, moments rtol 1e-6 /
atol 1e-5, the query's valid flags exact, normals 1e-4 and rvar rtol 1e-3
/ atol 1e-5 on valid rows, d atol 1e-3; the odometry p and R 1e-4, match
counts exact, map moments rtol 1e-5 / atol 1e-4. Every rank's result is
rank 0's bit for bit (the collectives hand every rank the same bits).
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import parallel as jpar  # noqa: E402
from fastliosam_tpu.core import se3 as jse3  # noqa: E402
from fastliosam_tpu.pgo import PoseGraphConfig as JPGC, add_between, add_gps  # noqa: E402
from fastliosam_tpu.pgo import solve as jsolve  # noqa: E402
from tests.test_pgo import build_noisy_chain, circle_poses  # noqa: E402

from _torch_mesh_worker import CASES, spawn_ranks  # noqa: E402

SH_CFG = dict(max_keyframes=64, max_between=128, max_gps=32, lm_iters=5, pcg_iters=48)
MAP_CFG = dict(capacity=1 << 12, voxel_size=0.5, min_points=5)
ODOM_MAP_CFG = dict(capacity=1 << 13, voxel_size=0.5, min_points=4)
ODOM_CFG = dict(point_filter_num=1, blind=0.1, num_ds_points=512, max_imu_per_scan=4,
                query_mode="merged3", evict_every=3, det_range=60.0)
ICP_CFG = dict(max_iterations=30, max_corr_dist=10.0, nn_chunk=256)
DETECT_CFG = dict(queries=[49, 30, 5], radius=30.0, time_gap=10.0)
SUBMAP_CFG = dict(centers=[0, 15, 31], n_sub=3)
PADDED_CASES = ("mesh", "solve", "gram", "detect", "submap", "icp")  # 3 ranks: no 2^k map


def _graph_np(g):
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


def _solve_graphs():
    """tests/test_parallel.py's two graphs: a 24-pose circle with a loop and
    GPS factors, and a 32-pose circle with a loop (the drift case)."""
    rng = np.random.default_rng(0)
    gt = circle_poses(24)
    g = build_noisy_chain(gt, rng, odom_noise=0.05, rot_noise=0.01)
    g = add_between(g, 23, 0, jse3.between(gt[-1], gt[0]),
                    jnp.asarray([100.0] * 3 + [1000.0] * 3, jnp.float32))
    for k in range(0, 24, 4):
        g = add_gps(g, k, jse3.trans(gt[k]), jnp.full((3,), 10.0, jnp.float32))
    gt2 = circle_poses(32)
    g2 = build_noisy_chain(gt2, np.random.default_rng(0), odom_noise=0.05, rot_noise=0.01)
    g2 = add_between(g2, 31, 0, jse3.between(gt2[-1], gt2[0]),
                     jnp.asarray([100.0] * 3 + [1000.0] * 3, jnp.float32))
    return (g, gt), (g2, gt2)


def _odom_inputs():
    """tests/test_parallel.py: test_sharded_odom_step_matches_replicated's
    scans (two walls and a floor) and IMU batches."""
    n_pts, n_imu, n_steps = 1024, 4, 4
    xyz, imu_g, imu_a = [], [], []
    for k in range(n_steps):
        r = np.random.default_rng(100 + k)
        xyz.append(np.concatenate([
            np.stack([r.uniform(-8, 8, 400), r.uniform(-8, 8, 400), np.full(400, -1.0)], 1),
            np.stack([np.full(312, 8.0), r.uniform(-8, 8, 312), r.uniform(-1, 3, 312)], 1),
            np.stack([r.uniform(-8, 8, 312), np.full(312, -8.0), r.uniform(-1, 3, 312)], 1),
        ]).astype(np.float32))
        r = np.random.default_rng(200 + k)
        imu_g.append(r.normal(size=(n_imu, 3)).astype(np.float32) * 0.01)
        imu_a.append((r.normal(size=(n_imu, 3)) * 0.01 + [0, 0, 9.81]).astype(np.float32))
    toff = np.linspace(0, 0.1, n_pts, endpoint=False).astype(np.float32)
    imu_t = np.linspace(0, 0.1, n_imu, endpoint=False).astype(np.float32)
    return {
        "odom.xyz": np.stack(xyz), "odom.toff": np.stack([toff] * n_steps),
        "odom.mask": np.ones((n_steps, n_pts), bool),
        "odom.imu_t": np.stack([imu_t] * n_steps), "odom.imu_g": np.stack(imu_g),
        "odom.imu_a": np.stack(imu_a), "odom.imu_m": np.ones((n_steps, n_imu), bool),
        "odom.dt": np.float32(0.1),
        "odom.map_cfg": json.dumps(ODOM_MAP_CFG), "odom.odom_cfg": json.dumps(ODOM_CFG),
    }


def make_inputs():
    """Every case's inputs, as test_parallel.py makes them (seed 0)."""
    inp = {"solve.cfg": json.dumps(SH_CFG)}
    for i, (g, _) in enumerate(_solve_graphs()):
        inp.update({f"solve{i}.{k}": v for k, v in _graph_np(g).items()})
    rng = np.random.default_rng(0)
    inp["gram.A"] = rng.normal(size=(1024, 6)).astype(np.float32)
    inp["gram.w"] = (rng.uniform(size=1024) > 0.3).astype(np.float32)
    inp["gram.r"] = rng.normal(size=1024).astype(np.float32)
    rng = np.random.default_rng(0)
    inp["detect.pos"] = rng.uniform(-40, 40, size=(64, 3)).astype(np.float32)
    inp["detect.stamps"] = (np.arange(64) * 0.7).astype(np.float32)
    inp["detect.valid"] = np.arange(64) < 50
    inp["detect.cfg"] = json.dumps(DETECT_CFG)
    rng = np.random.default_rng(0)
    inp["submap.clouds"] = rng.normal(size=(32, 64, 3)).astype(np.float32)
    inp["submap.masks"] = rng.random((32, 64)) > 0.3
    inp["submap.cfg"] = json.dumps(SUBMAP_CFG)
    rng = np.random.default_rng(0)
    base = rng.uniform(-20, 20, size=(1024, 3)).astype(np.float32)
    base[:, 2] = np.sin(base[:, 0] * 0.4) + 0.2 * base[:, 1]
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]],
                 np.float32)
    inp["icp.src"] = (base @ R.T + np.array([0.8, -0.5, 0.2], np.float32)).astype(np.float32)
    inp["icp.dst"] = base
    inp["icp.mask"] = np.ones((1024,), bool)
    inp["icp.cfg"] = json.dumps(ICP_CFG)
    rng = np.random.default_rng(0)
    n = 768
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                    0.05 * rng.standard_normal(n)], 1).astype(np.float32)
    inp["map.mask"] = rng.uniform(size=n) > 0.1
    inp["map.pts"] = pts
    inp["map.q"] = pts + rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    inp["map.pts2"] = pts + rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    inp["map.cfg"] = json.dumps(MAP_CFG)
    inp.update(_odom_inputs())
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs and each group's rank outputs: 4, 3 and 1 ranks, spawned
    together once for the module."""
    import concurrent.futures as cf

    d = tmp_path_factory.mktemp("mesh")
    inp = make_inputs()
    path = str(d / "inputs.npz")
    np.savez(path, **inp)
    groups = {4: [c for c in CASES if c != "engine"], 3: PADDED_CASES,
              1: [c for c in CASES if c != "engine"]}
    with cf.ThreadPoolExecutor(len(groups)) as ex:
        jobs = {w: ex.submit(spawn_ranks, w, path, str(d / f"w{w}"), cases)
                for w, cases in groups.items()}
        outs = {w: j.result() for w, j in jobs.items()}
    return inp, outs


def _same_on_every_rank(outs, prefix):
    keys = [k for k in outs[0] if k.startswith(prefix)]
    assert keys
    for r, o in enumerate(outs[1:], 1):
        for k in keys:
            assert np.array_equal(o[k], outs[0][k], equal_nan=True), (r, k)


@pytest.fixture(scope="module")
def jax_mesh4():
    return jpar.make_mesh(4)


@pytest.fixture(scope="module")
def jax_solve4(jax_mesh4):
    """JAX's solve on the 4-device mesh, compiled once for both graphs
    (they have the same shapes)."""
    return jax.jit(lambda g: jpar.solve_sharded(g, JPGC(**SH_CFG), jax_mesh4))


@pytest.mark.parametrize("world", [4, 3, 1])
def test_mesh_size_and_collectives(runs, world):
    """test_mesh_has_8_devices: the mesh spans every rank; psum / pmin /
    pmax / all_gather over the ranks' values; a subgroup of 2."""
    _, outs = runs
    for r, o in enumerate(outs[world]):
        assert o["mesh.size_rank"].tolist() == [world, r]
        x = np.array([[q + 1.0, -q, 2.0 * q] for q in range(world)], np.float32)
        np.testing.assert_array_equal(o["mesh.psum"], x.sum(0))
        np.testing.assert_array_equal(o["mesh.pmin"], x.min(0))
        np.testing.assert_array_equal(o["mesh.pmax"], x.max(0).astype(np.int32))
        np.testing.assert_array_equal(o["mesh.gather"][:, 0], x)
        assert o["mesh.flag"].tolist() == [True]
        sub = min(2, world)
        assert o["mesh.sub"].tolist() == ([sub, r] if r < sub else [-1, -1])
        if r < sub:
            assert o["mesh.sub_psum"].tolist() == [float(sub)]


def _jax_graph(inp, i):
    from fastliosam_tpu.pgo import PoseGraph

    return PoseGraph(**{f: jnp.asarray(inp[f"solve{i}.{f}"]) for f in PoseGraph._fields})


@pytest.mark.parametrize("world,ref", [(4, "jax_mesh4"), (4, "jax"), (3, "jax"), (1, "jax")])
def test_sharded_solve_matches_single_device(runs, jax_solve4, world, ref):
    inp, outs = runs
    g = _jax_graph(inp, 0)
    if ref == "jax_mesh4":
        g_ref, cost_ref = jax_solve4(g)
    else:
        g_ref, cost_ref = jsolve(g, JPGC(**SH_CFG), prior_pose=g.poses[0])
    o = outs[world][0]
    assert abs(float(o["solve0.cost"]) - float(cost_ref)) < 1e-2 * max(1.0, float(cost_ref))
    err = np.abs(o["solve0.poses"] - np.asarray(g_ref.poses)).max()
    assert err < 5e-3, err
    _same_on_every_rank(outs[world], "solve")


@pytest.mark.parametrize("world", [4, 3])
def test_sharded_solve_corrects_drift(runs, jax_solve4, world):
    inp, outs = runs
    gt = np.asarray(circle_poses(32))[:, :3, 3]
    before = np.linalg.norm(inp["solve1.poses"][:32, :3, 3] - gt, axis=1)
    after = np.linalg.norm(outs[world][0]["solve1.poses"][:32, :3, 3] - gt, axis=1)
    assert after.mean() < 0.7 * before.mean() + 1e-3
    if world == 4:
        g_ref, _ = jax_solve4(_jax_graph(inp, 1))
        assert np.abs(outs[4][0]["solve1.poses"] - np.asarray(g_ref.poses)).max() < 5e-3


@pytest.mark.parametrize("world", [4, 3, 1])
def test_sharded_gram_matches_dense(runs, jax_mesh4, world):
    inp, outs = runs
    A, w, r = inp["gram.A"], inp["gram.w"], inp["gram.r"]
    refs = [(A.T @ (A * w[:, None]), (A * w[:, None]).T @ r)]
    if world == 4:
        mesh = jpar.make_mesh(4, axis="pt")
        G, b, nv = jpar.sharded_gram(*(jpar.shard_leading(mesh, jnp.asarray(x), "pt")
                                       for x in (A, w, r)), mesh)
        assert int(nv) == int(np.sum(w > 0))
        refs.append((np.asarray(G), np.asarray(b)))
    o = outs[world][0]
    for G_ref, b_ref in refs:
        np.testing.assert_allclose(o["gram.G"], G_ref, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(o["gram.b"], b_ref, rtol=1e-4, atol=1e-3)
    assert int(o["gram.n"]) == int(np.sum(w > 0))
    _same_on_every_rank(outs[world], "gram")


@pytest.mark.parametrize("world", [4, 3, 1])
def test_detect_sharded_matches_replicated(runs, jax_mesh4, world):
    from fastliosam_tpu.loop.detect import fetch_closest_keyframe_idx

    inp, outs = runs
    c = DETECT_CFG
    pos, stamps, valid = (jnp.asarray(inp[f"detect.{k}"]) for k in ("pos", "stamps", "valid"))
    res = outs[world][0]["detect.res"].reshape(len(c["queries"]), 2, 2)
    for q, got in zip(c["queries"], res):
        i_ref, f_ref = fetch_closest_keyframe_idx(pos, stamps, valid, q, c["radius"],
                                                  c["time_gap"])
        expect = [int(i_ref), int(bool(f_ref))]
        if world == 4:
            i_sh, f_sh = jpar.detect_sharded(pos, stamps, valid, q, radius=c["radius"],
                                             time_gap=c["time_gap"], mesh=jax_mesh4)
            assert [int(i_sh), int(bool(f_sh))] == expect
        # the owner's broadcast and the caller's query row alike
        assert got.tolist() == [expect, expect]
    _same_on_every_rank(outs[world], "detect")


@pytest.mark.parametrize("world", [4, 3, 1])
def test_gather_submap_sharded(runs, jax_mesh4, world):
    inp, outs = runs
    clouds, masks = inp["submap.clouds"], inp["submap.masks"]
    K, n_sub = clouds.shape[0], SUBMAP_CFG["n_sub"]
    o = outs[world][0]
    for j, c in enumerate(SUBMAP_CFG["centers"]):
        win_c, win_m = o[f"submap.c{j}"], o[f"submap.m{j}"]
        for s, off in enumerate(range(-n_sub, n_sub + 1)):
            t = c + off
            if 0 <= t < K:
                np.testing.assert_allclose(win_c[s], clouds[t], atol=1e-6)
                np.testing.assert_array_equal(win_m[s], masks[t])
            else:
                assert not win_m[s].any()
        if world == 4:
            jc, jm = jpar.gather_submap_sharded(jnp.asarray(clouds), jnp.asarray(masks), c,
                                                n_sub, jax_mesh4)
            np.testing.assert_allclose(win_c, np.asarray(jc), atol=1e-6)
            np.testing.assert_array_equal(win_m, np.asarray(jm))
    _same_on_every_rank(outs[world], "submap")


@pytest.mark.parametrize("world,ref", [(4, "jax_mesh4"), (4, "jax"), (3, "jax"), (1, "jax")])
def test_icp_sharded_matches_replicated(runs, jax_mesh4, world, ref):
    from fastliosam_tpu.loop.icp import icp_align

    inp, outs = runs
    src, dst, mask = (jnp.asarray(inp[f"icp.{k}"]) for k in ("src", "dst", "mask"))
    if ref == "jax_mesh4":
        T_ref, fit_ref, nc_ref = jpar.icp_align_sharded(src, mask, dst, mask, jax_mesh4,
                                                        **ICP_CFG)
    else:
        T_ref, fit_ref, nc_ref = icp_align(src, mask, dst, mask, trim_fraction=1.0, **ICP_CFG)
    o = outs[world][0]
    assert int(o["icp.n_corr"]) == int(nc_ref)
    assert abs(float(o["icp.fit"]) - float(fit_ref)) < 1e-5
    np.testing.assert_allclose(o["icp.T"], np.asarray(T_ref), atol=1e-4)
    assert float(o["icp.fit"]) < 1e-3  # and it aligned
    _same_on_every_rank(outs[world], "icp")


def _jax_map_ref(inp, mesh):
    """The JAX map after the first and second insert batch and the merged3
    query, on ``mesh`` (the slot-sharded map) or replicated (None)."""
    from fastliosam_tpu.map import VoxelMapConfig, insert, make_map
    from fastliosam_tpu.map.voxel_hash import query_planes_merged3
    from fastliosam_tpu.parallel.sharded_map import (
        insert_sharded, make_map_sharded, query_planes_merged3_sharded)

    cfg = VoxelMapConfig(**MAP_CFG)
    pts, q, pts2 = (jnp.asarray(inp[f"map.{k}"]) for k in ("pts", "q", "pts2"))
    mask = jnp.asarray(inp["map.mask"])
    if mesh is None:
        m, drop = insert(make_map(cfg), cfg, pts, mask, refresh_planes=False)
        qres = query_planes_merged3(m, cfg, q, mask)
        m2, _ = insert(m, cfg, pts2, mask, refresh_planes=False)
    else:
        m, drop = insert_sharded(make_map_sharded(cfg, mesh), cfg, pts, mask, mesh)
        qres = query_planes_merged3_sharded(m, cfg, q, mask, mesh)
        m2, _ = insert_sharded(m, cfg, pts2, mask, mesh)
    return m, int(drop), [np.asarray(x) for x in qres], m2


@pytest.mark.parametrize("world,ref", [(4, "jax_mesh4"), (4, "jax"), (1, "jax")])
def test_sharded_voxel_map_matches_replicated(runs, jax_mesh4, world, ref):
    """Slot-range-sharded map: two insert batches and the merged3 query match
    the reference map; each rank held C/n rows only."""
    inp, outs = runs
    m, drop, (n_ref, d_ref, v_ref, c_ref), m2 = _jax_map_ref(
        inp, jax_mesh4 if ref == "jax_mesh4" else None)
    o = outs[world][0]
    assert int(o["map.shard_rows"]) == MAP_CFG["capacity"] // world
    assert int(o["map.drop"]) == drop
    np.testing.assert_array_equal(o["map.fp"], np.asarray(m.fp))
    np.testing.assert_allclose(o["map.moments"], np.asarray(m.moments), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(o["map.q_valid"], v_ref)
    vr = v_ref
    np.testing.assert_allclose(o["map.q_rvar"][vr], c_ref[vr], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(o["map.q_n"][vr], n_ref[vr], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(o["map.q_d"][vr], d_ref[vr], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(o["map.fp2"], np.asarray(m2.fp))
    np.testing.assert_allclose(o["map.moments2"], np.asarray(m2.moments), rtol=1e-6, atol=1e-5)
    _same_on_every_rank(outs[world], "map")


def test_sharded_map_matches_port_replicated_bitwise(runs):
    """The owner's rows are the replicated map's rows: the sharded insert
    and query give the port's replicated insert and query bit for bit
    (one nonzero row in each psum, the same fixed-order moment sums)."""
    from fastliosam_tpu_torch.map import VoxelMapConfig, insert, make_map
    from fastliosam_tpu_torch.map.voxel_hash import query_planes_merged3

    inp, outs = runs
    cfg = VoxelMapConfig(**MAP_CFG)
    pts, q, pts2 = (torch.from_numpy(inp[f"map.{k}"]) for k in ("pts", "q", "pts2"))
    mask = torch.from_numpy(inp["map.mask"])
    m, drop = insert(make_map(cfg, "cpu"), cfg, pts, mask, refresh_planes=False)
    qres = query_planes_merged3(m, cfg, q, mask)
    m2, drop2 = insert(m, cfg, pts2, mask, refresh_planes=False)
    for world in (4, 1):
        o = outs[world][0]
        assert int(o["map.drop"]) == int(drop) and int(o["map.drop2"]) == int(drop2)
        np.testing.assert_array_equal(o["map.fp"], m.fp.numpy())
        np.testing.assert_array_equal(o["map.moments"], m.moments.numpy())
        np.testing.assert_array_equal(o["map.moments2"], m2.moments.numpy())
        for k, v in zip(("n", "d", "valid", "rvar"), qres):
            np.testing.assert_array_equal(o[f"map.q_{k}"], v.numpy())


@pytest.mark.parametrize("world,ref", [(4, "jax_mesh4"), (4, "jax"), (1, "jax")])
def test_sharded_odom_step_matches_replicated(runs, jax_mesh4, world, ref):
    """Odometry steps over the slot-sharded map (query, insert and the
    scan-2 eviction through ``sharded_map_ops``) reproduce the reference
    trajectory and map."""
    from fastliosam_tpu.map import VoxelMapConfig
    from fastliosam_tpu.odom import ImuBatch, OdomConfig, Scan, init_odom, odom_step

    inp, outs = runs
    map_cfg, odom_cfg = VoxelMapConfig(**ODOM_MAP_CFG), OdomConfig(**ODOM_CFG)
    dt = jnp.float32(0.1)
    if ref == "jax_mesh4":
        ops = jpar.sharded_map_ops(jax_mesh4)
        step = jax.jit(lambda s, sc, im: odom_step(s, sc, im, dt, odom_cfg, map_cfg,
                                                   map_ops=ops))
        s = init_odom(map_cfg, odom_cfg)
        s = s._replace(vmap=jpar.shard_map_arrays(s.vmap, jax_mesh4))
    else:
        step = jax.jit(lambda s, sc, im: odom_step(s, sc, im, dt, odom_cfg, map_cfg))
        s = init_odom(map_cfg, odom_cfg)
    o = outs[world][0]
    for k in range(inp["odom.xyz"].shape[0]):
        sc = Scan(*(jnp.asarray(inp[f"odom.{f}"][k]) for f in ("xyz", "toff", "mask")))
        im = ImuBatch(*(jnp.asarray(inp[f"odom.imu_{f}"][k]) for f in ("t", "g", "a", "m")))
        s, aux = step(s, sc, im)
        np.testing.assert_allclose(o[f"odom.p{k}"], np.asarray(aux["p"]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(o[f"odom.R{k}"], np.asarray(aux["R"]), rtol=0, atol=1e-4)
        assert int(o[f"odom.n{k}"]) == int(aux["n_matched"])
    np.testing.assert_array_equal(o["odom.fp"], np.asarray(s.vmap.fp))
    np.testing.assert_allclose(o["odom.moments"], np.asarray(s.vmap.moments),
                               rtol=1e-5, atol=1e-4)
    _same_on_every_rank(outs[world], "odom")


def test_sharded_map_needs_capacity_multiple_of_ranks():
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.parallel import Mesh, make_map_sharded

    mesh = Mesh(None, "kf", 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        make_map_sharded(VoxelMapConfig(**MAP_CFG), mesh)


def test_rank_helper_imports_no_jax():
    import ast

    path = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
    tree = ast.parse(open(path).read())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not mods & {"jax", "jaxlib", "fastliosam_tpu"}, mods


@pytest.mark.parametrize("world", [4, 3])
def test_shard_converters_cut_the_jax_state(world):
    """``convert.py`` cuts a rank's shard from the JAX package's whole graph
    and map (given as numpy): the ranks' blocks put back in rank order are
    the padded whole, a padded between-factor measures the identity and is
    invalid, and every rank holds all the poses. No collective runs."""
    from fastliosam_tpu.map import VoxelMapConfig, insert, make_map
    from fastliosam_tpu_torch.convert import (pose_graph_shard_from_numpy,
                                              voxel_map_shard_from_numpy)
    from fastliosam_tpu_torch.parallel import Mesh

    meshes = [Mesh(None, "kf", r, world, torch.device("cpu")) for r in range(world)]
    g = _graph_np(_solve_graphs()[0][0])
    shards = [pose_graph_shard_from_numpy(g, m) for m in meshes]
    F = g["bt_i"].shape[0]
    for name in ("bt_i", "bt_rel", "bt_sqrt_info", "bt_valid", "gps_idx", "gps_xyz",
                 "gps_valid"):
        whole = np.concatenate([getattr(s, name).numpy() for s in shards])
        assert whole.shape[0] % world == 0
        np.testing.assert_array_equal(whole[: len(g[name])], g[name])
    pad_rel = np.concatenate([s.bt_rel.numpy() for s in shards])[F:]
    np.testing.assert_array_equal(pad_rel, np.broadcast_to(np.eye(4, dtype=np.float32),
                                                           pad_rel.shape))
    assert not np.concatenate([s.bt_valid.numpy() for s in shards])[F:].any()
    assert sum(int(s.n_bt) for s in shards) == int(g["n_bt"])
    for s in shards:
        np.testing.assert_array_equal(s.poses.numpy(), g["poses"])
    cfg = VoxelMapConfig(**MAP_CFG)
    rng = np.random.default_rng(0)
    m, _ = insert(make_map(cfg), cfg, jnp.asarray(rng.uniform(-8, 8, (500, 3)), jnp.float32),
                  jnp.ones((500,), bool), refresh_planes=False)
    m_np = {f: np.asarray(getattr(m, f)) for f in m._fields}
    if cfg.capacity % world:
        with pytest.raises(ValueError, match="multiple of the mesh"):
            voxel_map_shard_from_numpy(m_np, meshes[0])
        return
    vshards = [voxel_map_shard_from_numpy(m_np, mm) for mm in meshes]
    for f, v in m_np.items():
        assert all(getattr(s, f).shape[0] == cfg.capacity // world for s in vshards)
        np.testing.assert_array_equal(np.concatenate([getattr(s, f).numpy() for s in vshards]),
                                      v)
