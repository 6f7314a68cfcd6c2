"""Parity of the port's loop closure (detection, ICP, verification) and
pose-graph solver with the JAX package.

Tolerances and why:
  * ICP and verify_loop: relative transform within 1e-3 (m / rad) and
    ``accepted`` equal. Both ICPs stop on the same float32 step-size test
    but sum their Horn moments over thousands of points in other orders.
  * solve: compared at converged budgets (32 LM / 768 PCG): an
    under-converged LM accept cascade flips on float32 rounding alone
    (ROADMAP, DESIGN §2k/§2l), which would test rounding, not the port.
    Poses within 1e-3 m, cost within 1e-3 relative.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.core import se3 as jse3  # noqa: E402
from fastliosam_tpu.loop import closure as jcl  # noqa: E402
from fastliosam_tpu.loop import detect as jdet  # noqa: E402
from fastliosam_tpu.loop import icp as jicp  # noqa: E402
from fastliosam_tpu.pgo import graph as jgraph  # noqa: E402
from fastliosam_tpu.pgo import solver as jsolver  # noqa: E402
from fastliosam_tpu_torch.convert import pose_graph_from_numpy  # noqa: E402
from fastliosam_tpu_torch.loop import closure as tcl  # noqa: E402
from fastliosam_tpu_torch.loop import detect as tdet  # noqa: E402
from fastliosam_tpu_torch.loop import icp as ticp  # noqa: E402
from fastliosam_tpu_torch.pgo import graph as tgraph  # noqa: E402
from fastliosam_tpu_torch.pgo import solver as tsolver  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402


@pytest.mark.parametrize("query,radius,gap", [(9, 15.0, 30.0), (4, 100.0, 30.0),
                                              (7, 25.0, 5.0)])
def test_fetch_closest_keyframe_matches_jax(query, radius, gap):
    pos = np.zeros((10, 3), np.float32)
    pos[:5, 0] = np.arange(5) * 10
    pos[5:, 0] = 40 - np.arange(5) * 10
    pos[5:, 1] = 2.0
    stamps = np.arange(10, dtype=np.float32) * 10
    valid = np.ones(10, bool)
    valid[1] = False
    j_idx, j_found = jdet.fetch_closest_keyframe_idx(
        jnp.asarray(pos), jnp.asarray(stamps), jnp.asarray(valid), query, radius, gap)
    t_idx, t_found = tdet.fetch_closest_keyframe_idx(
        T(pos), T(stamps), T(valid), query, radius, gap)
    assert int(t_idx) == int(j_idx) and bool(t_found) == bool(j_found)


def test_horn_from_moments_matches_jax(rng):
    P = rng.normal(size=(500, 3)).astype(np.float32) * 3
    Q = (P @ np.asarray(jse3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.05, 0.1, -0.2]))[:3, :3]).T
         + 0.5).astype(np.float32)
    w = (rng.uniform(size=500) > 0.2).astype(np.float32)
    jR, jt = jicp.horn_from_moments(*jicp.horn_moments(*map(jnp.asarray, (P, Q, w))))
    tR, tt = ticp.horn_from_moments(*ticp.horn_moments(T(P), T(Q), T(w)))
    np.testing.assert_allclose(N(tR), N(jR), atol=1e-5)
    np.testing.assert_allclose(N(tt), N(jt), atol=1e-4)


@pytest.mark.parametrize("trim", [1.0, 0.8])
def test_icp_align_matches_jax(rng, trim):
    pts = rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    pts[:, 2] = 0.2 * pts[:, 0] + 0.1 * pts[:, 1]
    pts[::7, 2] += rng.uniform(0.5, 2.0, size=pts[::7, 2].shape)
    T_true = np.asarray(jse3.exp(jnp.asarray([0.4, -0.3, 0.2, 0.02, -0.03, 0.05])))
    dst = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    ones = np.ones(2000, bool)
    kw = dict(max_iterations=20, max_corr_dist=5.0, nn_chunk=512, trim_fraction=trim)
    jT, jfit, jn = jicp.icp_align(jnp.asarray(pts), jnp.asarray(ones), jnp.asarray(dst),
                                  jnp.asarray(ones), **kw)
    tT, tfit, tn = ticp.icp_align(T(pts), T(ones), T(dst), T(ones), **kw)
    np.testing.assert_allclose(N(tT), N(jT), atol=1e-3)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tfit), float(jfit), rtol=1e-2, atol=1e-6)


def _loop_store(rng):
    """The keyframe store of ``tests/test_loop.py``: a patch scene seen
    from 12 poses on a circle, the last pose drifted."""
    n_kf, P = 12, 1024
    patches = []
    for _ in range(40):
        c = rng.uniform(-8, 8, size=3)
        c[2] = abs(c[2]) * 0.3
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        u = np.cross(n, [1.0, 0.0, 0.0])
        if np.linalg.norm(u) < 0.1:
            u = np.cross(n, [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        uv = rng.uniform(-1.0, 1.0, size=(100, 2))
        patches.append(c + uv[:, :1] * u + uv[:, 1:] * v)
    scene = np.concatenate(patches).astype(np.float32)
    clouds = np.zeros((n_kf, P, 3), np.float32)
    masks = np.ones((n_kf, P), bool)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    for k in range(n_kf):
        a = 2 * np.pi * k / n_kf
        p = np.array([3 * np.cos(a), 3 * np.sin(a), 0.5], np.float32)
        poses[k, :3, 3] = p
        sel = np.argsort(np.linalg.norm(scene - p, axis=1))[:P]
        clouds[k] = scene[sel] - p
    poses[n_kf - 1, :3, 3] += np.array([0.3, -0.2, 0.1], np.float32)
    return clouds, masks, poses, np.ones(n_kf, bool)


@pytest.mark.parametrize("aniso", [True, False])
def test_verify_loop_matches_jax(rng, aniso):
    clouds, masks, poses, valid = _loop_store(rng)
    kw = dict(num_submap_keyframes=1, voxel_res=0.2, submap_points=4096,
              max_iterations=30, nn_chunk=512, radius=10.0, trim_fraction=0.7,
              aniso_noise=aniso)
    jcfg = jcl.LoopConfig(**kw)
    jout = jax.jit(lambda c, m, p, v, q, k: jcl.verify_loop(c, m, p, v, q, k, jcfg))(
        *map(jnp.asarray, (clouds, masks, poses, valid)), 11, 0)
    tout = tcl.verify_loop(T(clouds), T(masks), T(poses), T(valid), 11, 0,
                           tcl.LoopConfig(**kw), device="cpu")
    j_rel, j_si, j_acc, j_fit = map(N, jout)
    t_rel, t_si, t_acc, t_fit = map(N, tout)
    assert bool(t_acc) == bool(j_acc) and bool(j_acc)
    np.testing.assert_allclose(t_rel, j_rel, atol=1e-3)
    np.testing.assert_allclose(t_fit, j_fit, rtol=1e-2)
    np.testing.assert_allclose(t_si, j_si, rtol=1e-2)


def _noisy_graph(rng, n=24):
    """A noisy odometry chain around a circle plus one loop factor."""
    cfg = jgraph.PoseGraphConfig(max_keyframes=32, max_between=64, max_gps=8,
                                 lm_iters=32, pcg_iters=768)
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        yaw = a + np.pi / 2
        Tk = np.eye(4, dtype=np.float32)
        Tk[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        Tk[:3, 3] = [10 * np.cos(a), 10 * np.sin(a), 0.0]
        gt.append(Tk)
    g = jgraph.make_graph(cfg)
    est = jnp.asarray(gt[0])
    g = jgraph.add_keyframe(g, est)
    si = jnp.asarray([10.0] * 3 + [100.0] * 3, jnp.float32)
    for k in range(1, n):
        rel = jse3.between(jnp.asarray(gt[k - 1]), jnp.asarray(gt[k]))
        noise = np.r_[rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.01].astype(np.float32)
        rel = jse3.compose(rel, jse3.exp(jnp.asarray(noise)))
        est = jse3.compose(est, rel)
        g = jgraph.add_keyframe(g, est)
        g = jgraph.add_between(g, k - 1, k, rel, si)
    g = jgraph.add_between(g, n - 1, 0, jse3.between(jnp.asarray(gt[-1]), jnp.asarray(gt[0])),
                           jnp.asarray([100.0] * 3 + [1000.0] * 3, jnp.float32))
    return g, cfg


@pytest.mark.parametrize("linear_solver", ["pcg", "dense"])
def test_solve_matches_jax_at_converged_budget(rng, linear_solver):
    g, cfg = _noisy_graph(rng)
    cfg = cfg._replace(linear_solver=linear_solver)
    jg, jcost = jax.jit(lambda gg: jsolver.solve(gg, cfg))(g)
    tg, tcost = tsolver.solve(pose_graph_from_numpy(tree_np(g), device="cpu"),
                              tgraph.PoseGraphConfig(**cfg._asdict()), device="cpu")
    np.testing.assert_allclose(N(tg.poses), N(jg.poses), atol=1e-3)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-3, atol=1e-4)
    # the loop really moved the chain
    assert np.abs(N(tg.poses) - np.asarray(g.poses)).max() > 0.05


def test_graph_building_matches_jax():
    jcfg = jgraph.PoseGraphConfig(max_keyframes=4, max_between=3, max_gps=2)
    tcfg = tgraph.PoseGraphConfig(**jcfg._asdict())
    jg, tg = jgraph.make_graph(jcfg), tgraph.make_graph(tcfg, device="cpu")
    for k in range(6):  # overflows both capacities: masked no-ops
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = k
        si = np.full(6, k + 1.0, np.float32)
        jg = jgraph.add_keyframe(jg, jnp.asarray(pose))
        tg = tgraph.add_keyframe(tg, T(pose))
        jg = jgraph.add_between(jg, k, k + 1, jnp.asarray(pose), jnp.asarray(si))
        tg = tgraph.add_between(tg, k, k + 1, T(pose), T(si))
    jg2 = jgraph.grow(jg, jcfg._replace(max_keyframes=8, max_between=6))
    tg2 = tgraph.grow(tg, tcfg._replace(max_keyframes=8, max_between=6))
    for a, b in zip(tree_np(tg2), tree_np(jg2)):
        np.testing.assert_array_equal(a, b)
    ja = jgraph.from_arrays(jcfg, np.asarray(jg.poses[:3]), [0, 1], [1, 2],
                            np.asarray(jg.bt_rel[:2]), np.ones((2, 6), np.float32))
    ta = tgraph.from_arrays(tcfg, np.asarray(jg.poses[:3]), [0, 1], [1, 2],
                            np.asarray(jg.bt_rel[:2]), np.ones((2, 6), np.float32),
                            device="cpu")
    for a, b in zip(tree_np(ta), tree_np(ja)):
        np.testing.assert_array_equal(a, b)
