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
from fastliosam_tpu_torch.core import voxel as tvoxel  # noqa: E402
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
            N(tvoxel.hash_slot(T(coords), cap)), N(jvh._hash(jnp.asarray(coords), cap))
        )
    fp_t = N(tvoxel.fingerprint(T(coords)))
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


# ---------------------------------------------------------------------------
# the association's merged moments (ops/assoc_cuda.py): the plain version of
# the CUDA kernel csrc/assoc.cu, which the kernel is held to bit for bit on
# the card (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import assoc_cuda  # noqa: E402


def _assoc_queries(rng, tm, cfg):
    """Surfel queries, queries in voxels whose slot sits at the second probe
    behind a foreign fingerprint, and queries far from any voxel (no slot).
    Returns ``(xyz, mask, n_second_probe)``."""
    q, qmask = _surfels(rng, n=800, shift=(0.2, 0.1, 0.0))
    fp, coords = N(tm.fp), N(tm.coords)
    occ = np.nonzero(fp != 0)[0]
    h0 = N(tvoxel.hash_slot(T(coords[occ]), cfg.capacity)).astype(np.int64)
    second = occ[occ == ((h0 + 1) & (cfg.capacity - 1))]
    # the first probe holds another voxel's fingerprint
    assert np.all(fp[(second - 1) & (cfg.capacity - 1)] != fp[second])
    centres = (coords[second].astype(np.float32) + 0.5) * cfg.voxel_size
    inner = centres + rng.uniform(-0.2, 0.2, size=centres.shape) * cfg.voxel_size
    far = rng.uniform(40.0, 60.0, size=(40, 3))
    xyz = np.concatenate([q, inner, far]).astype(np.float32)
    mask = np.concatenate([qmask, np.ones(len(inner) + len(far), bool)])
    return xyz, mask, len(second)


def _jax_totals(jm, cfg, pools, coords0, mask):
    """JAX's own merge loop (``fastliosam_tpu/map/voxel_hash.py:
    query_planes_merged``) over the given pools, stopped before the fit:
    ``(N, 13)`` ``[tot_c, tot_s, tot_o]``."""
    n = coords0.shape[0]
    c0 = jvh._voxel_center(coords0, cfg.voxel_size)
    tot_c = jnp.zeros((n,), jnp.float32)
    tot_s = jnp.zeros((n, 3), jnp.float32)
    tot_o = jnp.zeros((n, 3, 3), jnp.float32)
    for coords in pools:
        slots, found = jvh._find_slots(jm, cfg, coords, mask)
        sl = jnp.clip(slots, 0, cfg.capacity - 1)
        mom = jm.moments[sl] * found.astype(jnp.float32)[:, None]
        ci, si, oi = mom[:, 0], mom[:, 1:4], jvh._unpack_sym(mom[:, 4:10])
        dc = jvh._voxel_center(coords, cfg.voxel_size) - c0
        tot_c = tot_c + ci
        tot_s = tot_s + si + ci[:, None] * dc
        cross = si[:, :, None] * dc[:, None, :]
        tot_o = (tot_o + oi + cross + jnp.swapaxes(cross, -1, -2)
                 + ci[:, None, None] * (dc[:, :, None] * dc[:, None, :]))
    return np.concatenate([N(tot_c)[:, None], N(tot_s), N(tot_o).reshape(n, 9)], axis=1)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("probes", [2, 4])
@pytest.mark.parametrize("mode", ["merged", "merged3"])
def test_merged_moments_match_jax(rng, name, probes, mode):
    """merged_moments_ref against JAX's merge loop (bit for bit: the same
    float32 operations in the same order), and the port's query that now
    calls it against JAX's query (the tolerances of
    test_query_planes_merged_match_jax)."""
    cfg = CFGS[name]._replace(query_probes=probes)
    jm, _, _ = _insert_both(rng, cfg, refresh=False)
    tm = voxel_map_from_numpy(tree_np(jm), device="cpu")
    xyz, mask, n_second = _assoc_queries(rng, tm, cfg)
    assert n_second > 0
    pools_fn = tvh.merged_pools if mode == "merged" else tvh.merged3_pools
    coords0, pools = pools_fn(T(xyz), cfg.voxel_size)
    got = assoc_cuda.merged_moments(tm.fp, tm.moments, pools, coords0, T(mask),
                                    cfg.voxel_size, probes)  # CPU: plain version
    want = _jax_totals(jm, cfg, jnp.asarray(N(pools)), jnp.asarray(N(coords0)),
                       jnp.asarray(mask))
    np.testing.assert_array_equal(N(got).view(np.int32), want.view(np.int32))
    far = slice(len(xyz) - 40, None)
    np.testing.assert_array_equal(N(got)[far], 0.0)  # nothing found out there
    # the second-probe queries find their own voxel
    inner = slice(len(xyz) - 40 - n_second, len(xyz) - 40)
    assert np.all(N(got)[inner, 0] > 0)

    q_fn = "query_planes_merged" if mode == "merged" else "query_planes_merged3"
    jn, jd, jv, jr = getattr(jvh, q_fn)(jm, cfg, jnp.asarray(xyz), jnp.asarray(mask))
    tn, td, tv, tr = getattr(tvh, q_fn)(tm, _port_cfg(cfg), T(xyz), T(mask))
    jv = N(jv)
    np.testing.assert_array_equal(N(tv), jv)
    assert jv.sum() > 20  # the tight table drops most points: fewer planes
    np.testing.assert_allclose(N(tn)[jv], N(jn)[jv], atol=1e-4)
    np.testing.assert_allclose(N(td)[jv], N(jd)[jv], atol=1e-4)
    np.testing.assert_allclose(N(tr)[jv], N(jr)[jv], rtol=1e-3, atol=1e-9)


def _composed_totals(m, cfg, pools, coords0, mask):
    """The port's association before merged_moments: per pool, the probe
    loop of one fingerprint gather per round, one moment gather, and the
    re-referenced sums as separate tensor operations."""
    n = coords0.shape[0]
    cap = cfg.capacity
    c0 = tvh._voxel_center(coords0, cfg.voxel_size)
    tot_c = torch.zeros((n,), dtype=torch.float32)
    tot_s = torch.zeros((n, 3), dtype=torch.float32)
    tot_o = torch.zeros((n, 3, 3), dtype=torch.float32)
    for coords in pools:
        h0 = tvoxel.hash_slot(coords, cap).to(torch.int64)
        want = tvoxel.fingerprint(coords)
        slots = torch.full((n,), -1, dtype=torch.int64)
        for p in range(cfg.query_probes):
            cand = (h0 + p) & (cap - 1)
            match = tvh.gather_rows(m.fp, cand) == want
            slots = torch.where((slots < 0) & match & mask, cand, slots)
        mom = tvh.gather_rows(m.moments, slots, valid=slots >= 0)
        ci, si, oi = mom[:, 0], mom[:, 1:4], tvh._unpack_sym(mom[:, 4:10])
        dc = tvh._voxel_center(coords, cfg.voxel_size) - c0
        tot_c = tot_c + ci
        tot_s = tot_s + si + ci[:, None] * dc
        cross = si[:, :, None] * dc[:, None, :]
        tot_o = (tot_o + oi + cross + cross.transpose(-1, -2)
                 + ci[:, None, None] * (dc[:, :, None] * dc[:, None, :]))
    return tot_c, tot_s, tot_o


@pytest.mark.parametrize("mode", ["merged", "merged3"])
def test_merged_moments_equal_previous_composition(rng, mode):
    """torch.equal: the plain version gives exactly what the association's
    separate gathers and tensor operations gave, on a seeded map."""
    cfg = _port_cfg(CFGS["tight"])._replace(query_probes=3)
    tm = tvh.make_map(cfg, device="cpu")
    for shift in ((0.0, 0.0, 0.0), (0.7, -0.4, 0.1)):
        pts, pmask = _surfels(rng, shift=shift)
        tm, _ = tvh.insert(tm, cfg, T(pts), T(pmask), refresh_planes=False)
    xyz, mask, _ = _assoc_queries(rng, tm, cfg)
    pools_fn = tvh.merged_pools if mode == "merged" else tvh.merged3_pools
    coords0, pools = pools_fn(T(xyz), cfg.voxel_size)
    got = assoc_cuda.merged_moments_ref(tm.fp, tm.moments, pools, coords0, T(mask),
                                        cfg.voxel_size, cfg.query_probes)
    tot_c, tot_s, tot_o = _composed_totals(tm, cfg, pools, coords0, T(mask))
    n = len(xyz)
    assert torch.equal(got[:, 0], tot_c)
    assert torch.equal(got[:, 1:4], tot_s)
    assert torch.equal(got[:, 4:].reshape(n, 3, 3), tot_o)
    assert int((tot_c > 0).sum()) > 100


# ---------------------------------------------------------------------------
# the insert's probe-and-claim rounds (ops/insert_cuda.py): the plain version
# of the CUDA kernel csrc/insert.cu, which the kernel is held to bit for bit
# on the card (tests/test_torch_cuda.py); these pin the semantics it keeps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CFGS))
def test_insert_after_evict_matches_jax(rng, name):
    """Insert, evict_far (holes in the probe chains), re-insert points that
    overlap the survivors: the re-inserted voxels may claim a hole ahead of
    their surviving entry (the JAX package's shadowing caveat), as in JAX."""
    cfg = CFGS[name]
    pcfg = _port_cfg(cfg)
    jm, tm, _ = _insert_both(rng, cfg, refresh=False)
    c = np.array([1.0, -0.5, 0.0], np.float32)
    jm = jvh.evict_far(jm, cfg, jnp.asarray(c), 4.0)
    tm = tvh.evict_far(tm, pcfg, T(c), 4.0)
    holes = int(N(tm.fp == 0).sum())
    pts, mask = _surfels(rng, shift=(0.35, 0.2, -0.05))
    jm, jd = j_insert(jm, jnp.asarray(pts), jnp.asarray(mask), cfg, False)
    tm2, td = tvh.insert(tm, pcfg, T(pts), T(mask), refresh_planes=False)
    assert int(N(tm2.fp == 0).sum()) < holes  # the re-insert filled holes
    assert int(jd) == int(td)
    if name == "tight":
        assert int(td) > 0
    np.testing.assert_array_equal(N(tm2.fp), N(jm.fp))
    np.testing.assert_array_equal(N(tm2.coords), N(jm.coords))
    np.testing.assert_allclose(N(tm2.moments), N(jm.moments), rtol=1e-5, atol=1e-4)


def test_insert_tournament_highest_index_wins(rng):
    """Six distinct voxels that hash to one slot, inserted together in
    interleaved order, 4 rounds: each round the voxel of the highest point
    index among the unassigned wins the next slot of the chain, the
    losers of other voxels move on, and the last two voxels are dropped.
    The port's plain version and JAX agree with that order."""
    cfg = CFGS["roomy"]
    pcfg = _port_cfg(cfg)
    cap, rounds = cfg.capacity, max(cfg.insert_probes, cfg.claim_probes)
    grid = np.stack(np.meshgrid(*[np.arange(-20, 20)] * 3, indexing="ij"), -1).reshape(-1, 3)
    h0 = N(tvoxel.hash_slot(T(grid.astype(np.int32)), cap))
    b = int(np.bincount(h0).argmax())
    vox = grid[h0 == b][:6]
    assert len(vox) == 6
    # 3 points per voxel inside it, in a shuffled order
    owner = rng.permutation(np.repeat(np.arange(6), 3))
    pts = ((vox[owner] + 0.5) * cfg.voxel_size
           + rng.uniform(-0.1, 0.1, size=(len(owner), 3)) * cfg.voxel_size).astype(np.float32)
    mask = np.ones(len(owner), bool)
    last = np.array([np.nonzero(owner == v)[0].max() for v in range(6)])
    ranked = np.argsort(-last)  # voxels by their highest point index

    tm, td = tvh.insert(tvh.make_map(pcfg, device="cpu"), pcfg, T(pts), T(mask),
                        refresh_planes=False)
    jm, jd = j_insert(jvh.make_map(cfg), jnp.asarray(pts), jnp.asarray(mask), cfg, False)
    fp = N(tm.fp)
    want = N(tvoxel.fingerprint(T(vox.astype(np.int32))))
    for r in range(rounds):
        assert fp[(b + r) % cap] == want[ranked[r]]
        np.testing.assert_array_equal(N(tm.coords)[(b + r) % cap], vox[ranked[r]])
    assert int(td) == 3 * (6 - rounds) == int(jd)
    assert int((fp != 0).sum()) == rounds
    np.testing.assert_array_equal(fp, N(jm.fp))
    np.testing.assert_array_equal(N(tm.coords), N(jm.coords))
    np.testing.assert_allclose(N(tm.moments), N(jm.moments), rtol=1e-5, atol=1e-4)
