"""Parity of the port's other plane-query modes with the JAX package: the
cached single-voxel query (``query_planes``, through the plain version of
the ``query_cached`` kernel), ``query_planes_merged2``, the odometry in the
``cached`` and ``merged2`` modes, the point-cloud utilities and
``gravity_from_imu``.

Tolerances and why:
  * ``query_planes``: bit for bit (the same map carried across; the result
    is a copy of its cached fields), not-found rows included.
  * ``merged2``: the pools and the merged moments bit for bit (the same
    float32 operations in the same order); the fitted planes within the
    tolerances of ``test_torch_voxel_hash.py`` (1e-4; rvar rtol 1e-3) where
    the fit has a plane (an eigenvalue gap above 1e-3 m²).
  * ``iekf_update`` from a carried-across state: pose within 1e-4, as in
    ``test_torch_odom.py``; one ``odom_step``: pose within 1e-4, the
    refreshed cached planes' normals within 1e-4 where the voxel's fit has
    a plane and their offsets within 2e-3 m (that normal error at up to
    15 m); a few scans of ``odom_step``: 1 cm (the room's floor lies on a
    voxel boundary, see ``test_torch_odom.py``).
  * point-cloud utilities: bit for bit; ``gravity_from_imu``: 1e-6 m/s².
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu.core import pointcloud as jpc  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu.odom import iekf as jiekf  # noqa: E402
from fastliosam_tpu.odom import pipeline as jpipe  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch.convert import (  # noqa: E402
    nav_state_from_numpy,
    odom_state_from_numpy,
    voxel_map_from_numpy,
)
from fastliosam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from fastliosam_tpu_torch.core import voxel as tvoxel  # noqa: E402
from fastliosam_tpu_torch.core.eigh3 import eigvalsh3  # noqa: E402
from fastliosam_tpu_torch.map import voxel_hash as tvh  # noqa: E402
from fastliosam_tpu_torch.odom import iekf as tiekf  # noqa: E402
from fastliosam_tpu_torch.ops import query_cuda  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402
from test_torch_voxel_hash import CFGS, _jax_totals, _port_cfg, _surfels, j_insert  # noqa: E402


def _slot0_points(rng, cfg, n=40):
    """Points on a plane inside a voxel whose slot is 0, so that slot 0
    holds a real cached plane and a miss reads something other than zeros."""
    grid = np.stack(np.meshgrid(*[np.arange(-30, 30)] * 3, indexing="ij"), -1).reshape(-1, 3)
    h0 = N(tvoxel.hash_slot(T(grid.astype(np.int32)), cfg.capacity))
    vox = grid[h0 == 0][0]
    uv = rng.uniform(0.05, 0.45, size=(n, 2))
    pts = np.c_[uv, np.full(n, 0.25)] + vox * cfg.voxel_size
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def cached_map():
    """A JAX map with refreshed planes (surfels plus a plane in slot 0's
    voxel), carried across, and queries that hit valid planes, planes too
    thin to be valid, voxels behind a foreign fingerprint, nothing at all,
    and masked lanes."""
    rng = np.random.default_rng(7)
    cfg = CFGS["roomy"]
    s0 = _slot0_points(rng, cfg)  # first: its voxel claims slot 0
    jm, _ = j_insert(jvh.make_map(cfg), jnp.asarray(s0), jnp.ones(len(s0), bool), cfg, True)
    for shift in ((0.0, 0.0, 0.0), (0.7, -0.4, 0.1), (0.1, 0.3, -0.05), (0.4, 0.2, 0.02)):
        pts, mask = _surfels(rng, n=3000, shift=shift)
        jm, _ = j_insert(jm, jnp.asarray(pts), jnp.asarray(mask), cfg, True)
    # two points only: a voxel whose plane is not valid (min_points 4)
    thin = np.array([[-20.1, 15.2, 3.3], [-20.2, 15.1, 3.4]], np.float32)
    jm, _ = j_insert(jm, jnp.asarray(thin), jnp.ones(2, bool), cfg, True)
    assert int(jm.fp[0]) != 0 and int(jm.plane_valid[0]) == 1

    q, qmask = _surfels(rng, n=800, shift=(0.2, 0.1, 0.0))
    fp, coords = np.asarray(jm.fp), np.asarray(jm.coords)
    occ = np.nonzero(fp != 0)[0]
    h0 = N(tvoxel.hash_slot(T(coords[occ]), cfg.capacity)).astype(np.int64)
    second = occ[occ != h0]  # found at a later probe than the first
    centres = (coords[second].astype(np.float32) + 0.5) * cfg.voxel_size
    far = rng.uniform(40.0, 60.0, size=(40, 3))
    xyz = np.concatenate([q, centres, thin, far]).astype(np.float32)
    mask = np.concatenate([qmask, np.ones(len(centres) + 2 + 40, bool)])
    mask[5:15] = False  # masked lanes that would have hit a plane
    return cfg, jm, xyz, mask, len(second)


def test_query_planes_bit_exact(cached_map):
    cfg, jm, xyz, mask, n_second = cached_map
    assert n_second > 0
    tm = voxel_map_from_numpy(tree_np(jm), device="cpu")
    jn, jd, jv = jax.jit(lambda m, p, k: jvh.query_planes(m, cfg, p, k))(
        jm, jnp.asarray(xyz), jnp.asarray(mask))
    before = query_cuda.launches
    tn, td, tv = tvh.query_planes(tm, _port_cfg(cfg), T(xyz), T(mask))
    assert query_cuda.launches == before  # the CPU runs the plain version
    np.testing.assert_array_equal(N(tn).view(np.int32), N(jn).view(np.int32))
    np.testing.assert_array_equal(N(td).view(np.int32), N(jd).view(np.int32))
    np.testing.assert_array_equal(N(tv), N(jv))
    tv = N(tv)
    assert tv.sum() > 200
    assert not tv[5:15].any()  # masked
    n = len(xyz)
    # not found (far): slot 0's plane, not zeros, and never valid
    far = slice(n - 40, n)
    assert not tv[far].any()
    np.testing.assert_array_equal(N(tn)[far], np.broadcast_to(N(tm.normal)[0], (40, 3)))
    np.testing.assert_array_equal(N(td)[far], np.full(40, N(tm.d)[0]))
    assert np.abs(N(tm.normal)[0]).sum() > 0.5
    # found but plane not valid (the thin voxel), and found at later probes
    assert not tv[n - 42:n - 40].any()
    assert tv[n - 42 - n_second:n - 42].any()


def _eigen_gap(moments):
    """λ1 − λ0 of each voxel's covariance from its (C, 10) moments."""
    m = T(moments)
    c = torch.clamp(m[:, 0], min=1.0)
    mean = m[:, 1:4] / c[:, None]
    cov = tvh._unpack_sym(m[:, 4:10]) / c[:, None, None] - mean[:, :, None] * mean[:, None, :]
    lam = N(eigvalsh3(cov))
    return lam[:, 1] - lam[:, 0]


def _jax_merged2_pools(xyz, vs):
    """The neighbour choice of the JAX package's ``query_planes_merged2``
    (``fastliosam_tpu/map/voxel_hash.py:433-442``), as pools."""
    coords0 = jvh._voxel_coords(xyz, vs)
    off = xyz - jvh._voxel_center(coords0, vs)
    ax = jnp.argmax(jnp.abs(off), axis=-1)
    onehot = (jnp.arange(3)[None, :] == ax[:, None]).astype(jnp.int32)
    step = jnp.sign(jnp.sum(off * onehot, axis=-1)).astype(jnp.int32)
    return coords0, jnp.stack([coords0, coords0 + step[:, None] * onehot])


@pytest.mark.parametrize("probes", [2, 4])
def test_query_planes_merged2_matches_jax(cached_map, probes):
    """Random surfel queries plus queries exactly at voxel centres (zero
    offset: the own voxel counted twice), on a tie of two axes (the first
    wins) and on one axis alone."""
    cfg, jm, xyz, mask, _ = cached_map
    cfg = cfg._replace(query_probes=probes)
    tm = voxel_map_from_numpy(tree_np(jm), device="cpu")
    coords = np.asarray(jm.coords)[np.asarray(jm.fp) != 0][:60]
    centres = (coords.astype(np.float32) + 0.5) * cfg.voxel_size
    special = np.concatenate([
        centres,  # exactly at the centre
        centres + np.array([0.125, -0.125, 0.0], np.float32),  # |x| = |y|: x wins
        centres + np.array([0.0, 0.0, -0.1875], np.float32),  # z alone
    ]).astype(np.float32)
    xyz = np.concatenate([xyz, special])
    mask = np.concatenate([mask, np.ones(len(special), bool)])

    jc0, jpools = jax.jit(lambda p: _jax_merged2_pools(p, cfg.voxel_size))(jnp.asarray(xyz))
    tc0, tpools = tvh.merged2_pools(T(xyz), cfg.voxel_size)
    np.testing.assert_array_equal(N(tc0), N(jc0))
    np.testing.assert_array_equal(N(tpools), N(jpools))
    n = len(xyz)
    k = len(centres)
    at_centre = slice(n - 3 * k, n - 2 * k)
    np.testing.assert_array_equal(N(tpools)[1, at_centre], N(tpools)[0, at_centre])
    tie = slice(n - 2 * k, n - k)
    np.testing.assert_array_equal(N(tpools)[1, tie] - N(tpools)[0, tie],
                                  np.broadcast_to([1, 0, 0], (k, 3)))

    got = tvh.merged_moments(tm.fp, tm.moments, tpools, tc0, T(mask), cfg.voxel_size, probes)
    want = _jax_totals(jm, cfg, jpools, jc0, jnp.asarray(mask))
    np.testing.assert_array_equal(N(got).view(np.int32), want.view(np.int32))
    # the own voxel twice: twice its count, where the probe reaches its slot
    occ = np.nonzero(np.asarray(jm.fp) != 0)[0][:60]
    h0 = N(tvoxel.hash_slot(T(coords), cfg.capacity)).astype(np.int64)
    reached = ((occ - h0) & (cfg.capacity - 1)) < probes
    assert reached.sum() > 40
    np.testing.assert_array_equal(N(got)[at_centre, 0],
                                  np.where(reached, 2 * np.asarray(jm.moments)[occ, 0], 0.0))

    jn, jd, jv, jr = jvh.query_planes_merged2(jm, cfg, jnp.asarray(xyz), jnp.asarray(mask))
    tn, td, tv, tr = tvh.query_planes_merged2(tm, _port_cfg(cfg), T(xyz), T(mask))
    jv = N(jv)
    np.testing.assert_array_equal(N(tv), jv)
    # planes compared where the fit has one: a voxel of two points (counted
    # twice, it passes min_points) is a line, λ0 = λ1 = 0, and its normal
    # is any vector across it, chosen by rounding
    sym = N(got)[:, [4, 5, 6, 8, 9, 12]]  # tot_o's upper triangle
    fit = jv & (_eigen_gap(np.concatenate([N(got)[:, :4], sym], axis=1)) > 1e-3)
    assert fit.sum() > 200
    np.testing.assert_allclose(N(tn)[fit], N(jn)[fit], atol=1e-4)
    np.testing.assert_allclose(N(td)[fit], N(jd)[fit], atol=1e-4)
    np.testing.assert_allclose(N(tr)[fit], N(jr)[fit], rtol=1e-3, atol=1e-9)


# ---------------------------------------------------------------------------
# the odometry in the cached and merged2 modes, on the room feed of
# tests/test_torch_odom.py
# ---------------------------------------------------------------------------
J_MAP = jvh.VoxelMapConfig(capacity=1 << 14, voxel_size=0.4, min_points=4)
T_MAP = tvh.VoxelMapConfig(**J_MAP._asdict())
J_ODOM = jodom.OdomConfig(point_filter_num=1, blind=0.5, filter_size_surf=0.3,
                          num_ds_points=2048, max_imu_per_scan=32, evict_every=1000)
N_SCANS = 5


@pytest.fixture(scope="module")
def room():
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=10, seed=1)
    traj = Trajectory.circle(radius=8.0, period=60.0)
    cfg = SimConfig(n_azimuth=256, n_elev=10, gyro_noise=0.0005, acc_noise=0.005,
                    gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=3)
    return simulate_sequence(world, traj, cfg, n_scans=N_SCANS), traj


def _imu_np(data, k, cap=32):
    ts, gyro, acc = data["imu"][k]
    n = len(ts)
    return (np.pad(ts, (0, cap - n), constant_values=1e9).astype(np.float32),
            np.pad(gyro, ((0, cap - n), (0, 0))).astype(np.float32),
            np.pad(acc, ((0, cap - n), (0, 0))).astype(np.float32),
            np.arange(cap) < n)


def _inputs(data, k):
    imu = _imu_np(data, k)
    pts, toff, mask = data["scans"][k]
    return ((jodom.Scan(*map(jnp.asarray, (pts, toff, mask))),
             jodom.ImuBatch(*map(jnp.asarray, imu))),
            (todom.Scan(T(pts), T(toff), T(mask)), todom.ImuBatch(*map(T, imu))))


@pytest.mark.parametrize("mode", ["cached", "merged2"])
def test_odometry_modes_match_jax(room, mode):
    """The JAX odometry over the feed in ``mode``; one iEKF update from its
    carried-across state and map, one step from its state, and the port's
    own run of every scan from the start."""
    data, traj = room
    jcfg = J_ODOM._replace(query_mode=mode)
    tcfg = todom.OdomConfig(**jcfg._asdict())
    step = jax.jit(lambda s, scan, imu, dt: jodom.odom_step(s, scan, imu, dt, jcfg, J_MAP))
    R0, p0 = traj.pose(0.0)
    nav0 = jodom.init_state(cfg=jcfg)._replace(
        R=jnp.asarray(R0, jnp.float32), p=jnp.asarray(p0, jnp.float32),
        v=jnp.asarray(traj.velocity(0.0), jnp.float32))
    st = jodom.init_odom(J_MAP, jcfg)._replace(nav=nav0)
    states, ps = [st], []
    for k in range(N_SCANS):
        (jscan, jimu_b), _ = _inputs(data, k)
        st, aux = step(st, jscan, jimu_b, jnp.float32(data["scan_dt"]))
        states.append(st)
        ps.append(np.asarray(aux["p"]))
    if mode == "cached":  # the insert refreshed the cached planes
        assert int(np.asarray(states[-1].vmap.plane_valid).sum()) > 100

    # one iterated update from a carried-across state, a few cm off
    k = 3
    st = states[k]
    pts, _, mask = data["scans"][k]
    R_gt, p_gt = data["gt"][k]
    pw = (pts[mask][:1500] @ R_gt.T + p_gt).astype(np.float32)
    pb = jnp.asarray((pw - np.asarray(st.nav.p)) @ np.asarray(st.nav.R))
    nav_w = st.nav._replace(p=st.nav.p + jnp.asarray([0.03, -0.02, 0.01], jnp.float32))
    ones = jnp.ones((pb.shape[0],), bool)
    # eager, as test_torch_voxel_hash.py queries: under jit XLA reorders the
    # closed-form eigen arithmetic, which turns the normals of the thin
    # two-voxel fits (there are many in merged2) another way
    jx, jn = jiekf.iekf_update(nav_w, pb, ones, st.vmap, J_MAP, jcfg)
    tx, tn = tiekf.iekf_update(nav_state_from_numpy(tree_np(nav_w), device="cpu"), T(N(pb)),
                               T(N(ones)), voxel_map_from_numpy(tree_np(st.vmap), device="cpu"),
                               T_MAP, tcfg)
    assert int(jn) > 50 and abs(int(tn) - int(jn)) <= 2
    np.testing.assert_allclose(N(tx.p), N(jx.p), atol=1e-4)
    np.testing.assert_allclose(N(tx.R), N(jx.R), atol=1e-4)

    # one step from the carried state (the cached refresh included)
    tstate = odom_state_from_numpy(tree_np(states[k]), device="cpu")
    _, (tscan, timu_b) = _inputs(data, k)
    tnew, aux = todom.odom_step(tstate, tscan, timu_b, data["scan_dt"], tcfg, T_MAP,
                                device="cpu")
    np.testing.assert_allclose(N(aux["p"]), ps[k], atol=1e-4)
    jnew = states[k + 1].vmap
    np.testing.assert_array_equal(N(tnew.vmap.fp), np.asarray(jnew.fp))
    pv = np.asarray(jnew.plane_valid)
    np.testing.assert_array_equal(N(tnew.vmap.plane_valid), pv)
    # normals where the voxel's fit has a plane (see the merged2 test);
    # under jit XLA also reorders the closed-form eigen arithmetic
    fit = (pv > 0) & (_eigen_gap(np.asarray(jnew.moments)) > 1e-3)
    assert fit.sum() > 100 if mode == "cached" else pv.sum() == 0  # merged2: no refresh
    np.testing.assert_allclose(N(tnew.vmap.normal)[fit], np.asarray(jnew.normal)[fit],
                               atol=1e-4)
    # d = -n·mean: the normal's 1e-4 at up to 15 m from the origin
    np.testing.assert_allclose(N(tnew.vmap.d)[fit], np.asarray(jnew.d)[fit], atol=2e-3)

    # every scan from the start
    tst = odom_state_from_numpy(tree_np(states[0]), device="cpu")
    tps = []
    for k in range(N_SCANS):
        _, (tscan, timu_b) = _inputs(data, k)
        tst, aux = todom.odom_step(tst, tscan, timu_b, data["scan_dt"], tcfg, T_MAP,
                                   device="cpu")
        tps.append(N(aux["p"]))
    np.testing.assert_allclose(np.stack(tps), np.stack(ps), atol=1e-2)
    gt = np.stack([g[1] for g in data["gt"]])
    assert np.sqrt(np.mean(np.sum((np.stack(tps) - gt) ** 2, axis=1))) < 0.10


# ---------------------------------------------------------------------------
# the point-cloud utilities and gravity_from_imu
# ---------------------------------------------------------------------------
def test_pointcloud_utilities_match_jax(rng):
    pts = rng.uniform(-20, 20, size=(500, 3)).astype(np.float32)
    mask = rng.uniform(size=500) > 0.3
    jc = jpc.make_cloud(jnp.asarray(pts), jnp.asarray(mask), capacity=640)
    tc = tpc.make_cloud(T(pts), T(mask), capacity=640)
    assert tc.capacity == jc.capacity == 640
    assert int(tc.count()) == int(jc.count()) == int(mask.sum())
    for a, b in ((tc, jc), (tpc.make_cloud(T(pts), capacity=300, device="cpu"),
                            jpc.make_cloud(jnp.asarray(pts), capacity=300))):
        np.testing.assert_array_equal(N(a.xyz), N(b.xyz))
        np.testing.assert_array_equal(N(a.mask), N(b.mask))
    cases = [
        (tpc.stride_filter(tc, 3), jpc.stride_filter(jc, 3)),
        (tpc.stride_filter(tc, 1), jpc.stride_filter(jc, 1)),
        (tpc.blind_filter(tc, 8.0), jpc.blind_filter(jc, 8.0)),
        (tpc.range_filter(tc, 15.0), jpc.range_filter(jc, 15.0)),
        (tpc.compact(tc), jpc.compact(jc)),
        (tpc.concat(tc, tpc.compact(tc)), jpc.concat(jc, jpc.compact(jc))),
    ]
    for a, b in cases:
        np.testing.assert_array_equal(N(a.xyz), N(b.xyz))
        np.testing.assert_array_equal(N(a.mask), N(b.mask))
    jx, jm = jax.jit(lambda p, m: jpc.voxel_downsample_points(p, m, 2.0))(jc.xyz, jc.mask)
    tx, tm = tpc.voxel_downsample_points(tc.xyz, tc.mask, 2.0)
    np.testing.assert_array_equal(N(tm), N(jm))
    np.testing.assert_allclose(N(tx), N(jx), atol=1e-5)


def test_gravity_from_imu_matches_jax(rng):
    acc = (rng.normal(size=(32, 3)) * 0.05 + [0.3, -0.2, 9.78]).astype(np.float32)
    mask = np.arange(32) < 21
    acc[~mask] = 100.0  # masked samples must not count
    args = (np.zeros(32, np.float32), np.zeros((32, 3), np.float32), acc, mask)
    g_j = jpipe.gravity_from_imu(jodom.ImuBatch(*map(jnp.asarray, args)))
    g_t = todom.gravity_from_imu(todom.ImuBatch(*map(T, args)))
    np.testing.assert_allclose(N(g_t), N(g_j), atol=1e-6)
    assert abs(float(np.linalg.norm(N(g_t))) - 9.81) < 1e-4
