"""The port's geodesy and pose-graph marginal covariance against the JAX
package (the counterparts of ``tests/test_pgo.py``'s covariance tests).

Tolerances and why:
  * Geodesy runs in float32 in both packages (the JAX package never
    enables x64). ECEF coordinates near 6.4e6 m have a float32 spacing of
    0.5 m, so a one-ulp difference between XLA's and torch's ``sin``/``cos``
    moves an ECEF point by up to 0.5 m. Measured on the CPU over 2000
    points within ±600 m of the Hong Kong anchor: ENU ``forward`` differs
    by up to 0.61 m (29% of points differ at all), ``reverse`` latitude and
    longitude by up to 1.9e-6 deg (one float32 ulp) and altitude by up to
    1.0 m (it is a difference of two 6.4e6 m values), the HK1980 grid by up
    to 1.0 m. The tests allow 1.0 m (ENU), 4e-6 deg, 2.0 m (altitude and
    grid): two float32 spacings of the ECEF coordinates, not an error of
    the port.
  * Marginal covariance: the PCG marginal against JAX's PCG marginal within
    1e-4 relative to the block's largest entry (both run the same 256 CG
    trips, summing in other orders); against the dense Cholesky reference
    as the JAX test holds its own (rtol 0.02).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.core import geodesy as jgeo  # noqa: E402
from fastliosam_tpu.core import se3 as jse3  # noqa: E402
from fastliosam_tpu.pgo import graph as jgraph  # noqa: E402
from fastliosam_tpu.pgo import solver as jsolver  # noqa: E402
from fastliosam_tpu_torch.convert import (  # noqa: E402
    local_cartesian_from_numpy,
    pose_graph_from_numpy,
)
from fastliosam_tpu_torch.core import geodesy as tgeo  # noqa: E402
from fastliosam_tpu_torch.pgo import graph as tgraph  # noqa: E402
from fastliosam_tpu_torch.pgo import solver as tsolver  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402

ANCHOR = (22.3193, 114.1694, 10.0)
ENU_TOL, DEG_TOL, ALT_TOL = 1.0, 4e-6, 2.0


@pytest.fixture(scope="module")
def enu_points():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2000, 3)) * np.array([200.0, 200.0, 5.0])).astype(np.float32)


def test_local_cartesian_anchor_matches_jax():
    jl = jgeo.LocalCartesian.from_origin(*ANCHOR)
    tl = tgeo.LocalCartesian.from_origin(*ANCHOR)
    np.testing.assert_array_equal(N(tl.origin_ecef), N(jl.origin_ecef))
    np.testing.assert_array_equal(N(tl.rot), N(jl.rot))
    assert tl.origin_ecef.dtype == torch.float32
    back = local_cartesian_from_numpy(tree_np(jl), device="cpu")
    assert torch.equal(back.rot, tl.rot)


def test_reverse_and_forward_match_jax(enu_points):
    jl = jgeo.LocalCartesian.from_origin(*ANCHOR)
    tl = tgeo.LocalCartesian.from_origin(*ANCHOR)
    jlat, jlon, jalt = (N(a) for a in jl.reverse(jnp.asarray(enu_points)))
    tlat, tlon, talt = (N(a) for a in tl.reverse(T(enu_points)))
    np.testing.assert_allclose(tlat, jlat, rtol=0, atol=DEG_TOL)
    np.testing.assert_allclose(tlon, jlon, rtol=0, atol=DEG_TOL)
    np.testing.assert_allclose(talt, jalt, rtol=0, atol=ALT_TOL)
    # forward of the same geodetic inputs
    j_enu = N(jl.forward(jnp.asarray(jlat), jnp.asarray(jlon), jnp.asarray(jalt)))
    t_enu = N(tl.forward(T(jlat), T(jlon), T(jalt)))
    np.testing.assert_allclose(t_enu, j_enu, rtol=0, atol=ENU_TOL)
    # the scalar form the engine uses (Python floats in, one fix)
    for k in range(5):
        a = N(jl.forward(jnp.asarray(float(jlat[k])), jnp.asarray(float(jlon[k])),
                         jnp.asarray(float(jalt[k]))))
        b = N(tl.forward(float(jlat[k]), float(jlon[k]), float(jalt[k])))
        assert b.shape == (3,) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=ENU_TOL)


def test_hk1980_grid_matches_jax(enu_points):
    jl = jgeo.LocalCartesian.from_origin(*ANCHOR)
    lat, lon, alt = (N(a) for a in jl.reverse(jnp.asarray(enu_points[:500])))
    je, jn = (N(a) for a in jgeo.wgs84_to_hk1980(jnp.asarray(lat), jnp.asarray(lon),
                                                  jnp.asarray(alt)))
    te, tn = (N(a) for a in tgeo.wgs84_to_hk1980(T(lat), T(lon), T(alt)))
    np.testing.assert_allclose(te, je, rtol=0, atol=ALT_TOL)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=ALT_TOL)
    # the grid is near the HK1980 false origin around the anchor
    assert 8.0e5 < float(te.mean()) < 8.7e5 and 8.0e5 < float(tn.mean()) < 8.5e5


# ---------------------------------------------------------------------------
# marginal covariance (tests/test_pgo.py:178-340 counterparts)
# ---------------------------------------------------------------------------
CFG = jgraph.PoseGraphConfig(max_keyframes=32, max_between=64, max_gps=16)
TCFG = tgraph.PoseGraphConfig(**CFG._asdict())
# compiled once per graph shape, as the JAX engine runs it
j_marginal = jax.jit(jsolver.marginal_covariance, static_argnums=(1,))


def _chain(n, yaw=0.0, along=0):
    """Odometry chain of n poses 1 m apart along world axis ``along``, every
    pose yawed by ``yaw``; both graphs (JAX and port) and the poses."""
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                   [0.0, 0.0, 1.0]], np.float32)
    gt = []
    for k in range(n):
        Tk = np.eye(4, dtype=np.float32)
        Tk[:3, :3] = Rz
        Tk[along, 3] = float(k)
        gt.append(jnp.asarray(Tk))
    g = jgraph.add_keyframe(jgraph.make_graph(CFG), gt[0])
    sqrt_info = jnp.asarray([10.0] * 3 + [100.0] * 3, jnp.float32)
    for k in range(1, n):
        g = jgraph.add_keyframe(g, gt[k])
        g = jgraph.add_between(g, k - 1, k, jse3.between(gt[k - 1], gt[k]), sqrt_info)
    return g, gt


def _port(g):
    return pose_graph_from_numpy(tree_np(g), device="cpu")


def test_marginal_covariance_chain_matches_jax():
    g, gt = _chain(16)
    tg = _port(g)
    var_x = []
    for k in (1, 5, 15):
        j = N(j_marginal(g, CFG, jnp.int32(k)))
        t = N(tsolver.marginal_covariance(tg, TCFG, k))
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())
        var_x.append(t[0, 0])
    # per-factor translation variance 0.01: linear growth along the chain
    np.testing.assert_allclose(var_x, [0.01, 0.05, 0.15], rtol=0.05)
    # a strong GPS factor on the tail re-constrains it
    g2 = jgraph.add_gps(g, 15, jse3.trans(gt[15]), jnp.asarray([10.0] * 3, jnp.float32))
    t_tail = N(tsolver.marginal_covariance(_port(g2), TCFG, 15))
    assert t_tail[0, 0] < 0.02
    np.testing.assert_allclose(t_tail, N(j_marginal(g2, CFG, jnp.int32(15))),
                               rtol=0, atol=1e-4 * np.abs(t_tail).max())


def test_marginal_pcg_matches_dense_on_a_loopy_graph(rng):
    n = 24
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        Tk = np.array(jse3.exp(jnp.asarray([0, 0, 0, 0, 0, a + np.pi / 2], jnp.float32)))
        Tk[:3, 3] = [10 * np.cos(a), 10 * np.sin(a), 0.0]
        gt.append(Tk.astype(np.float32))
    noisy = [Tk.copy() for Tk in gt]
    for Tk in noisy[1:]:
        Tk[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.05
    si = np.array([10.0] * 3 + [100.0] * 3, np.float32)
    rels = [np.linalg.inv(gt[k]) @ gt[k + 1] for k in range(n - 1)]
    rels.append(np.linalg.inv(gt[n - 1]) @ gt[0])
    g = jgraph.from_arrays(
        CFG, [jnp.asarray(p) for p in noisy], bt_i=list(range(n - 1)) + [n - 1],
        bt_j=list(range(1, n)) + [0], bt_rel=[jnp.asarray(r) for r in rels],
        bt_sqrt_info=[jnp.asarray(si)] * (n - 1) + [jnp.asarray(si * 10)],
        gps_idx=[12, 20], gps_xyz=[jnp.asarray(gt[12][:3, 3]), jnp.asarray(gt[20][:3, 3])],
        gps_sqrt_info=[jnp.asarray([2.0] * 3, jnp.float32)] * 2,
    )
    tg = _port(g)
    for k in (0, 7, 23):
        dense = N(tsolver.marginal_covariance_dense(tg, TCFG, k))
        pcg = N(tsolver.marginal_covariance(tg, TCFG, k))
        np.testing.assert_allclose(pcg, dense, rtol=0.02, atol=1e-4 * np.abs(dense).max())
        np.testing.assert_allclose(
            dense, N(jsolver.marginal_covariance_dense(g, CFG, jnp.int32(k))),
            rtol=1e-3, atol=1e-4 * np.abs(dense).max())
        np.testing.assert_allclose(
            pcg, N(j_marginal(g, CFG, jnp.int32(k))),
            rtol=0, atol=1e-4 * np.abs(pcg).max())


@pytest.mark.parametrize("yaw,along", [(0.0, 0), (np.pi / 2, 1)])
def test_rotate_and_extrapolate_match_jax_and_truth(yaw, along):
    """Straight chain, optionally yawed 90° (local x = world y): the world
    covariance extrapolated from keyframe 6 equals the true marginal at 11,
    as in the JAX tests; rotate/extrapolate agree with JAX's."""
    g, gt = _chain(12, yaw=yaw, along=along)
    tg = _port(g)
    tv, rv = 1.0 / 10.0**2, 1.0 / 100.0**2
    covs = {}
    for k in (6, 11):
        cov = tsolver.marginal_covariance(tg, TCFG, k)
        R = T(np.asarray(jse3.rot(gt[k])))
        covs[k] = N(tsolver.rotate_cov_to_world(cov, R))
        jw = N(jsolver.rotate_cov_to_world(jnp.asarray(N(cov)), jse3.rot(gt[k])))
        np.testing.assert_allclose(covs[k], jw, rtol=1e-6, atol=1e-9)
    dxy = np.zeros(2)
    dxy[along] = 5.0
    est = tsolver.extrapolate_pose_cov(covs[6], 5, 5.0, dxy, tv, rv)
    np.testing.assert_allclose(est, covs[11][(0, 1), (0, 1)], rtol=0.02)
    np.testing.assert_array_equal(est, jsolver.extrapolate_pose_cov(covs[6], 5, 5.0, dxy, tv, rv))


def test_extrapolation_loopback_bounded_matches_jax():
    cov6 = np.zeros((6, 6))
    cov6[0, 0] = cov6[1, 1] = 0.01
    cov6[5, 5] = 0.05
    args = (cov6, 20, 40.0, np.array([1e-9, 0.0]), 1e-2, 1e-4)
    est = tsolver.extrapolate_pose_cov(*args)
    np.testing.assert_array_equal(est, jsolver.extrapolate_pose_cov(*args))
    assert est[0] > 0.01 + 20 * 1e-2 + 1.0 and est[1] > 0.01 + 20 * 1e-2 + 1.0
