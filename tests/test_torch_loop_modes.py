"""Parity of the port's other loop-ICP modes with the JAX package:
point-to-plane ICP (``icp_align_p2pl``, its normals from the destination's
surfel map through the cached-plane query), the multi-start coarse search
(``_multistart_init``) and ``verify_loop`` with either; the engine in
these modes is ``test_torch_engine_modes.py``.

Tolerances and why:
  * ICP transforms within 1e-3 (m / rad), correspondence counts equal,
    fitness rtol 1e-2: both stop on the same float32 step-size test but sum
    their Gram or Horn moments over thousands of points in other orders
    (``test_torch_loop_pgo.py``).
  * the surfel normals of the destination map: within 1e-4 where the JAX
    plane is valid (``test_torch_voxel_hash.py``).

The JAX side of ``verify_loop`` and ``_multistart_init`` runs under
``jax.jit``, as the JAX engine runs it.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.loop import closure as jcl  # noqa: E402
from fastliosam_tpu.loop import icp as jicp  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu_torch.loop import closure as tcl  # noqa: E402
from fastliosam_tpu_torch.loop import icp as ticp  # noqa: E402
from fastliosam_tpu_torch.map import voxel_hash as tvh  # noqa: E402
from fastliosam_tpu_torch.ops import gather_cuda, nn_cuda, query_cuda  # noqa: E402

from _torch_parity import N, T  # noqa: E402
from test_torch_loop_pgo import _loop_store  # noqa: E402


def _walls_scene(rng, n=3072):
    """The walls-and-floor scene of ``tests/test_loop.py``'s point-to-plane
    test, seen from 1.2 / -0.8 / 0.4 m away."""
    m3 = n // 3
    dst = np.concatenate([
        np.stack([rng.uniform(0, 20, m3), rng.uniform(-6, 6, m3), np.zeros(m3)], 1),
        np.stack([rng.uniform(0, 20, m3), np.full(m3, 6.0), rng.uniform(0, 4, m3)], 1),
        np.stack([np.full(n - 2 * m3, 20.0), rng.uniform(-6, 6, n - 2 * m3),
                  rng.uniform(0, 4, n - 2 * m3)], 1),
    ]).astype(np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [1.2, -0.8, 0.4]
    src = (dst - T_true[:3, 3]).astype(np.float32)
    return src, dst, T_true


def test_surfel_normals_match_jax(rng):
    """The destination's surfel map and its cached-plane query, the
    normals of the point-to-plane ICP."""
    _, dst, _ = _walls_scene(rng)
    mask = np.ones(len(dst), bool)
    cfg = jcl.LoopConfig()
    jmap, jcfg = jcl._dst_surfel_map(jnp.asarray(dst), jnp.asarray(mask), cfg)
    jn, _, jv = jvh.query_planes(jmap, jcfg, jnp.asarray(dst), jnp.asarray(mask))
    tmap, tcfg = tcl._dst_surfel_map(T(dst), T(mask), tcl.LoopConfig())
    assert tcfg == tvh.VoxelMapConfig(**jcfg._asdict())
    tn, _, tv = tvh.query_planes(tmap, tcfg, T(dst), T(mask))
    np.testing.assert_array_equal(N(tmap.fp), N(jmap.fp))
    np.testing.assert_array_equal(N(tv), N(jv))
    jv = N(jv)
    assert jv.sum() > 0.8 * len(dst)
    np.testing.assert_allclose(N(tn)[jv], N(jn)[jv], atol=1e-4)


@pytest.mark.parametrize("trim", [0.9, 1.0])
def test_icp_p2pl_matches_jax(rng, trim):
    """The point-to-plane test of ``tests/test_loop.py`` through both
    packages, with the same normals (JAX's)."""
    src, dst, T_true = _walls_scene(rng)
    mask = np.ones(len(dst), bool)
    jmap, jcfg = jcl._dst_surfel_map(jnp.asarray(dst), jnp.asarray(mask), jcl.LoopConfig())
    nrm, _, nvalid = jvh.query_planes(jmap, jcfg, jnp.asarray(dst), jnp.asarray(mask))
    kw = dict(max_iterations=30, max_corr_dist=10.0, trim_fraction=trim, nn_chunk=512)
    jT, jfit, jn = jicp.icp_align_p2pl(jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
                                       jnp.asarray(mask), nrm, nvalid, **kw)
    g0, n0 = gather_cuda.launches, nn_cuda.launches
    tT, tfit, tn = ticp.icp_align_p2pl(T(src), T(mask), T(dst), T(mask), T(N(nrm)),
                                       T(N(nvalid)), **kw)
    assert gather_cuda.launches == g0 and nn_cuda.launches == n0  # CPU: plain versions
    np.testing.assert_allclose(N(tT), N(jT), atol=1e-3)
    assert int(tn) == int(jn) > 2000
    np.testing.assert_allclose(float(tfit), float(jfit), rtol=1e-2, atol=1e-6)
    err = N(tT) @ np.linalg.inv(T_true)
    assert np.abs(err[:3, 3]).max() < 0.05


def _canyon_store(rng):
    """The keyframe store of ``tests/test_loop.py``'s multi-start test: a
    canyon with a repeating 6 m lattice and one unique anchor, keyframe 1
    at the same place as keyframe 0 but with 7 m of along-canyon drift."""
    pts = []
    xs = rng.uniform(-18, 18, size=1500)
    for ywall in (-5.0, 5.0):
        pts.append(np.stack([xs, np.full_like(xs, ywall), rng.uniform(0, 4, size=len(xs))], 1))
    gx = rng.uniform(-18, 18, size=1200)
    pts.append(np.stack([gx, rng.uniform(-5, 5, size=len(gx)), np.zeros_like(gx)], 1))
    for k in range(-3, 4):
        yy = rng.uniform(-5, -4, size=80)
        pts.append(np.stack([np.full_like(yy, 6.0 * k), yy, rng.uniform(0, 2, size=len(yy))], 1))
    yy = rng.uniform(2, 5, size=300)
    pts.append(np.stack([np.full_like(yy, 8.7), yy, rng.uniform(0, 3.5, size=len(yy))], 1))
    scene = np.concatenate(pts).astype(np.float32)
    P = 4096
    clouds = np.zeros((2, P, 3), np.float32)
    clouds[0] = scene[rng.permutation(len(scene))[:P]]
    clouds[1] = scene[rng.permutation(len(scene))[:P]]
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[1, 0, 3] = 7.0
    return clouds, np.ones((2, P), bool), poses, np.ones(2, bool)


CANYON = dict(num_submap_keyframes=0, voxel_res=0.2, submap_points=4096, max_iterations=40,
              nn_chunk=512, radius=10.0, trim_fraction=0.8, icp_score_threshold=1.5,
              icp_multistart=5, multistart_step=3.5, multistart_iters=10)


def _starts(eigh3, normal, plane_valid, xp):
    """The five start translations of ``_multistart_init`` (its lines,
    through ``xp`` = numpy on the package's ``eigh3`` output)."""
    w = plane_valid.astype(np.float32)
    G = (normal * w[:, None]).T @ normal
    lam, V = (N(a) for a in eigh3(xp(0.5 * (G + G.T))))
    axis = V[:, np.argmin(lam)].copy()
    axis[2] = 0.0
    axis = axis / max(np.linalg.norm(axis), 1e-6)
    offs = (np.arange(5, dtype=np.float32) - 2.0) * np.float32(CANYON["multistart_step"])
    return offs[:, None] * axis[None, :]


def test_multistart_init_matches_jax(rng):
    """The same weak axis, the same winning start among the five coarse
    ICPs, and its transform."""
    from fastliosam_tpu.core.eigh3 import eigh3 as jeigh3
    from fastliosam_tpu_torch.core.eigh3 import eigh3 as teigh3

    clouds, masks, poses, valid = _canyon_store(rng)
    jcfg, tcfg = jcl.LoopConfig(**CANYON), tcl.LoopConfig(**CANYON)
    jargs = tuple(map(jnp.asarray, (clouds, masks, poses, valid)))
    src = jcl.build_submap(*jargs, 1, jcfg)
    dst = jcl.build_submap(*jargs, 0, jcfg)
    jmap, _ = jcl._dst_surfel_map(*dst, jcfg)
    jT0 = jax.jit(lambda s, sm, d, dm, m: jcl._multistart_init(s, sm, d, dm, m, jcfg))(
        *src, *dst, jmap)
    tsrc, tdst = (tuple(T(N(a)) for a in x) for x in (src, dst))
    tmap, _ = tcl._dst_surfel_map(*tdst, tcfg)
    n0 = nn_cuda.launches
    tT0 = tcl._multistart_init(*tsrc, *tdst, tmap, tcfg)
    assert nn_cuda.launches == n0
    # the port's starts on their own: its winner is the start whose coarse
    # transform JAX returned too
    starts = {pkg: _starts(eigh3, N(m.normal), N(m.plane_valid), arr)
              for pkg, eigh3, m, arr in (("jax", jeigh3, jmap, jnp.asarray),
                                         ("port", teigh3, tmap, T))}
    np.testing.assert_allclose(starts["port"], starts["jax"], atol=1e-4)
    assert np.abs(starts["port"][0]).max() > 1.0  # the starts really spread
    outs = []
    for off in starts["port"]:
        init = np.eye(4, dtype=np.float32)
        init[:3, 3] = off
        outs.append(ticp.icp_align(*tsrc, *tdst, init_T=T(init), max_iterations=10,
                                   max_corr_dist=15.0, nn_chunk=512, trim_fraction=0.8,
                                   convergence_eps=0.01))
    win = int(np.argmin([float(o[1]) for o in outs]))
    np.testing.assert_allclose(N(outs[win][0]), N(tT0), atol=1e-6)
    dist = [np.abs(N(o[0]) - N(jT0)).max() for o in outs]
    assert int(np.argmin(dist)) == win and dist[win] < 1e-3
    # the starts end apart: the winner is a real choice
    assert sorted(dist)[1] > 0.1


@pytest.mark.parametrize("mode", ["p2pl", "multistart"])
def test_verify_loop_modes_match_jax(rng, mode):
    """p2pl on the patch store of ``test_torch_loop_pgo.py`` (0.3 m of
    drift), the multi-start on the canyon (7 m along the lattice)."""
    if mode == "p2pl":
        clouds, masks, poses, valid = _loop_store(rng)
        query, cand = 11, 0
        # a tight step test: ‖dx‖ < 0.01 stops within one step of the fixed
        # point, and the two may stop one step apart
        kw = dict(num_submap_keyframes=1, voxel_res=0.2, submap_points=4096,
                  max_iterations=50, nn_chunk=512, radius=10.0, trim_fraction=0.7,
                  icp_method="p2pl", convergence_eps=1e-5)
    else:
        clouds, masks, poses, valid = _canyon_store(rng)
        query, cand = 1, 0
        kw = dict(CANYON)
    jcfg = jcl.LoopConfig(**kw)
    jout = jax.jit(lambda c, m, p, v: jcl.verify_loop(c, m, p, v, query, cand, jcfg))(
        *map(jnp.asarray, (clouds, masks, poses, valid)))
    q0 = query_cuda.launches
    tout = tcl.verify_loop(T(clouds), T(masks), T(poses), T(valid), query, cand,
                           tcl.LoopConfig(**kw), device="cpu")
    assert query_cuda.launches == q0
    j_rel, j_si, j_acc, j_fit = map(N, jout)
    t_rel, t_si, t_acc, t_fit = map(N, tout)
    assert bool(t_acc) == bool(j_acc)
    assert bool(j_acc) or mode == "multistart"  # a 7 m slide: rejected as one
    np.testing.assert_allclose(t_rel, j_rel, atol=1e-3)
    np.testing.assert_allclose(t_fit, j_fit, rtol=1e-2)
    np.testing.assert_allclose(t_si, j_si, rtol=1e-2)
    if mode == "multistart":
        # the multi-start recovers the 7 m drift (tests/test_loop.py)
        T_corr = poses[0] @ np.linalg.inv(t_rel)
        assert np.linalg.norm(T_corr[:3, 3]) < 1.0
