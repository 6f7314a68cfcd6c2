"""Parity of the port's voxel-surfel hash map with the JAX package.

The hash and the fingerprint are uint32 arithmetic in JAX and int64
emulation in the port: they must agree bit for bit (negative and extreme
coordinates included), so the slot tables (``fp``, ``coords``) after an
insert must be identical. Moments are float32 sums whose order may differ
(XLA scatter vs. ``index_add_``): rtol 1e-5 / atol 1e-4 (sums of up to
~100 squared offsets ≤ 0.25 m²). Plane queries: normals and offsets within
1e-4, validity equal.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu_torch.map import voxel_hash as tvh  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402
from fastliosam_tpu_torch.convert import voxel_map_from_numpy  # noqa: E402


def test_hash_and_fingerprint_bit_exact(rng):
    coords = rng.integers(-(1 << 20), 1 << 20, size=(4096, 3)).astype(np.int32)
    extremes = np.array(
        [[0, 0, 0], [-1, -1, -1], [2**31 - 1, -(2**31), 7],
         [-(2**31), 2**31 - 1, -(2**31)], [1, -1, 0]], np.int32
    )
    coords = np.concatenate([coords, extremes])
    for cap in (1 << 14, 1 << 19):
        np.testing.assert_array_equal(
            N(tvh._hash(T(coords), cap)), N(jvh._hash(jnp.asarray(coords), cap))
        )
    fp_t = N(tvh._fingerprint(T(coords)))
    np.testing.assert_array_equal(fp_t, N(jvh._fingerprint(jnp.asarray(coords))))
    assert fp_t.dtype == np.int32 and np.all(fp_t % 2 != 0)


def _surfels(rng, n=1500, shift=(0.0, 0.0, 0.0)):
    """Points on a floor, two walls and a slanted plane (+1 cm noise), with
    a masked tail — real surfel statistics and both signs of coordinates."""
    k = n // 4
    u = rng.uniform(-6, 6, size=(n, 2))
    floor = np.c_[u[:k], np.full(k, -1.2)]
    wall_x = np.c_[np.full(k, 4.3), u[k:2 * k]]
    wall_y = np.c_[u[2 * k:3 * k, 0], np.full(k, -3.7), u[2 * k:3 * k, 1]]
    r = n - 3 * k
    slant = np.c_[u[3 * k:], 0.3 * u[3 * k:, 0] + 0.2 * u[3 * k:, 1] + 1.0]
    pts = np.concatenate([floor, wall_x, wall_y, slant]) + np.asarray(shift)
    pts += rng.normal(size=pts.shape) * 0.01
    mask = np.ones(n, bool)
    mask[-r // 4:] = False
    pts[~mask] = 1e6
    return pts.astype(np.float32), mask


CFGS = {
    "roomy": jvh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=4),
    "tight": jvh.VoxelMapConfig(capacity=1 << 9, voxel_size=0.5, min_points=4,
                                insert_probes=2, claim_probes=2, query_probes=2),
}


def _port_cfg(cfg):
    return tvh.VoxelMapConfig(**cfg._asdict())


# compiled, as the JAX package always runs (see test_torch_core: XLA's
# reciprocal multiply decides the voxel of boundary points)
j_insert = jax.jit(lambda m, p, k, cfg, refresh: jvh.insert(m, cfg, p, k, refresh),
                   static_argnums=(3, 4))


def _insert_both(rng, cfg, refresh):
    """Two inserts (the second re-visits and extends the first)."""
    jm = jvh.make_map(cfg)
    tm = tvh.make_map(_port_cfg(cfg), device="cpu")
    drops = []
    for shift in ((0.0, 0.0, 0.0), (0.7, -0.4, 0.1)):
        pts, mask = _surfels(rng, shift=shift)
        jm, jd = j_insert(jm, jnp.asarray(pts), jnp.asarray(mask), cfg, refresh)
        tm, td = tvh.insert(tm, _port_cfg(cfg), T(pts), T(mask), refresh_planes=refresh)
        drops.append((int(jd), int(td)))
    return jm, tm, drops


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("refresh", [False, True])
def test_insert_matches_jax(rng, name, refresh):
    cfg = CFGS[name]
    jm, tm, drops = _insert_both(rng, cfg, refresh)
    for jd, td in drops:
        assert jd == td
    if name == "tight":
        assert drops[-1][0] > 0  # the tight table really overflows
    np.testing.assert_array_equal(N(tm.fp), N(jm.fp))
    np.testing.assert_array_equal(N(tm.coords), N(jm.coords))
    np.testing.assert_allclose(N(tm.moments), N(jm.moments), rtol=1e-5, atol=1e-4)
    if refresh:
        np.testing.assert_array_equal(N(tm.plane_valid), N(jm.plane_valid))
        v = N(jm.plane_valid) > 0
        np.testing.assert_allclose(N(tm.normal)[v], N(jm.normal)[v], atol=1e-4)
        np.testing.assert_allclose(N(tm.d)[v], N(jm.d)[v], atol=1e-4)


@pytest.mark.parametrize("mode", ["merged", "merged3"])
def test_query_planes_merged_match_jax(rng, mode):
    cfg = CFGS["roomy"]
    jm, _, _ = _insert_both(rng, cfg, refresh=False)
    # same map in both (carried across as numpy) so only the query differs
    tm = voxel_map_from_numpy(tree_np(jm), device="cpu")
    q, qmask = _surfels(rng, n=800, shift=(0.2, 0.1, 0.0))
    q_fn = "query_planes_merged" if mode == "merged" else "query_planes_merged3"
    # eager: under jit XLA reorders the closed-form eigen arithmetic, which
    # moves the (arbitrary) normal of near-collinear fits, λ0 ≈ λ1, by up
    # to 0.07; op by op JAX rounds like torch. No random query point sits
    # on a voxel boundary, so eager division picks the same voxels.
    jn, jd, jv, jr = getattr(jvh, q_fn)(jm, cfg, jnp.asarray(q), jnp.asarray(qmask))
    tn, td, tv, tr = getattr(tvh, q_fn)(tm, _port_cfg(cfg), T(q), T(qmask))
    jv = N(jv)
    np.testing.assert_array_equal(N(tv), jv)
    assert jv.sum() > 100
    np.testing.assert_allclose(N(tn)[jv], N(jn)[jv], atol=1e-4)
    np.testing.assert_allclose(N(td)[jv], N(jd)[jv], atol=1e-4)
    # rvar divides small eigenvalues: relative float32 rounding
    np.testing.assert_allclose(N(tr)[jv], N(jr)[jv], rtol=1e-3, atol=1e-9)


def test_evict_far_matches_jax(rng):
    cfg = CFGS["roomy"]
    jm, _, _ = _insert_both(rng, cfg, refresh=True)
    tm = voxel_map_from_numpy(tree_np(jm), device="cpu")
    c = np.array([2.0, -1.0, 0.0], np.float32)
    je = jvh.evict_far(jm, cfg, jnp.asarray(c), 4.0)
    te = tvh.evict_far(tm, _port_cfg(cfg), T(c), 4.0)
    assert 0 < int(N(te.fp != 0).sum()) < int(N(tm.fp != 0).sum())
    for a, b in zip(tree_np(te), tree_np(je)):
        np.testing.assert_array_equal(a, b)
