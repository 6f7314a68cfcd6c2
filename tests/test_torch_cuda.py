"""Tests that need an NVIDIA GPU: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the bitwise replay of the
scatter-adds that make the card path deterministic. They skip without CUDA.

This file imports neither JAX nor the JAX package, and uses no fixture of
``conftest.py``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: nearest neighbours, d2 rtol 1e-5 / atol 1e-4 (the expansion of
O(10) m² values in float32, with the card's and the CPU's summation
orders), indices equal except at ties, where the two candidates' distances
agree within 1e-5; planted exact ties across a slice boundary give exactly
the lower index, and two launches agree bit for bit; at map coordinates
(a centroid table up to 60 m) the expansion's rounding grows with
|s|² + |d|², so there d2 agrees within rtol 1e-5 plus 4 ulps of that sum.
The insert at the map build's 65,536-point batches and the plane
refresh's reads at its slots: bit for bit, as below. The KITTI resume:
two engines from one checkpoint equal bit for bit. The row gather,
take_along_axis and the cached-plane query are copies: equal bit for bit
(NaN fill included). The plane refresh: rows it does not touch bit for
bit, the touched ones within ``plane_fit_cuda.TOLERANCE`` (``compare``: the
plain version's cuBLAS matmul in the eigenvector rounds otherwise), lanes
bit for bit with the unbatched kernel, two launches bit for bit. The
point-to-plane normal equations: G and b within ``p2pl_cuda.TOLERANCE``
of their largest entries (the plain version's matmul sums in another
order), the trim's keys bit for bit, two launches bit for bit; the ICP's
final pose within 1e-5 m / rad of the plain versions'. The association's merged moments: equal bit for bit
(the kernel rounds every product and sum as the plain version does, in its
order). The replay: two runs equal bit for bit. The bag run through
``run_slam``: the path's kernels launch, and its replay with pageable
uploads equals it bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from fastliosam_tpu_torch.ops import nn_cuda

# ragged sizes are not multiples of the kernel's 512 sources per block, its
# 256-point tile or its slice length
SIZES = [(300, 2500), (1000, 3001), (17, 5), (256, 2048), (16384, 16384), (16383, 16001),
         (513, 257)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n, m, masked_frac=0.1):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32) * 3
    dst = (rng.normal(size=(m, 3)) * 4).astype(np.float32)
    mask = rng.uniform(size=m) > masked_frac
    return src, dst, mask


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", SIZES)
def test_nn_kernel_matches_plain_version(cuda_device, n, m):
    src, dst, mask = _inputs(n + m, n, m)
    s, d, mk = (torch.from_numpy(a).to(cuda_device) for a in (src, dst, mask))
    before = nn_cuda.launches
    k_idx, k_d2 = nn_cuda.nearest_neighbors(s, d, mk)
    torch.cuda.synchronize()
    assert nn_cuda.launches == before + 1
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(s, d, mk)
    k_idx, k_d2, r_idx, r_d2 = (t.cpu().numpy() for t in (k_idx, k_d2, r_idx, r_d2))
    np.testing.assert_allclose(k_d2, r_d2, rtol=1e-5, atol=1e-4)
    diff = k_idx != r_idx
    cand = ((src[diff] - dst[k_idx[diff]]) ** 2).sum(-1)
    alt = ((src[diff] - dst[r_idx[diff]]) ** 2).sum(-1)
    np.testing.assert_allclose(cand, alt, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_nn_kernel_all_masked(cuda_device):
    src, dst, _ = _inputs(1, 64, 256)
    idx, d2 = nn_cuda.nearest_neighbors(
        torch.from_numpy(src).to(cuda_device), torch.from_numpy(dst).to(cuda_device),
        torch.zeros(256, dtype=torch.bool, device=cuda_device),
    )
    np.testing.assert_array_equal(idx.cpu().numpy(), 0)
    np.testing.assert_allclose(d2.cpu().numpy(), 1e12)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(16384, 16384), (1000, 3001)])
def test_nn_kernel_planted_ties_and_repeat(cuda_device, n, m):
    """An exact duplicate destination on both sides of every slice boundary,
    sources on and around it: the lower index wins. Two launches give the
    same words."""
    src, dst, mask = _inputs(7, n, m)
    slices, slice_len = nn_cuda.slice_plan(n, m)
    assert slices > 1
    rng = np.random.default_rng(8)
    pairs = []
    for s in range(1, slices):
        b = s * slice_len
        if b + 2 >= m:
            break
        p = (rng.normal(size=3) * 4).astype(np.float32)
        dst[b - 2] = dst[b + 1] = p
        mask[[b - 2, b + 1]] = True
        k = 3 * len(pairs)
        src[k] = p  # on the point: the expansion may round d2 below 0
        src[k + 1: k + 3] = p + rng.normal(size=(2, 3)).astype(np.float32) * 1e-3
        pairs.append((k, b - 2))
    assert pairs
    s, d, mk = (torch.from_numpy(a).to(cuda_device) for a in (src, dst, mask))
    idx1, d21 = nn_cuda.nearest_neighbors_cuda(s, d, mk)
    idx2, d22 = nn_cuda.nearest_neighbors_cuda(s, d, mk)
    torch.cuda.synchronize()
    assert torch.equal(idx1, idx2) and torch.equal(d21.view(torch.int32), d22.view(torch.int32))
    idx = idx1.cpu().numpy()
    for k, lower in pairs:
        np.testing.assert_array_equal(idx[k: k + 3], lower)


@pytest.mark.cuda
def test_nn_kernel_rejects_bad_inputs(cuda_device):
    src = torch.zeros((8, 3), device=cuda_device)
    dst = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(src, dst, torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(src.double(), dst, torch.ones(8, dtype=torch.bool,
                                                                    device=cuda_device))
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(src[:, :2].contiguous(), dst,
                                       torch.ones(8, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(src.cpu(), dst, torch.ones(8, dtype=torch.bool,
                                                                  device=cuda_device))


# ---------------------------------------------------------------------------
# row gather and take_along_axis: copies, so the kernel must equal its plain
# version bit for bit (compared as 32-bit words, NaN included)
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import gather_cuda, take_along_cuda  # noqa: E402


def _bits(t):
    return t.contiguous().view(torch.int32).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,n,dtype,idx_dtype", [
    (1 << 12, 16, 4096, torch.float32, torch.int32),
    (1 << 12, 10, 4096, torch.float32, torch.int64),
    (1 << 12, 1, 4096, torch.int32, torch.int64),
    (1 << 19, 10, 8192, torch.float32, torch.int64),
    (1000, 3, 1000, torch.int32, torch.int32),
    (4096, 128, 333, torch.float32, torch.int32),
])
def test_gather_rows_kernel_matches_plain_version(cuda_device, c, d, n, dtype, idx_dtype):
    rng = np.random.default_rng(c + d + n)
    shape = (c,) if d == 1 and dtype == torch.int32 else (c, d)
    tab = rng.normal(size=shape).astype(np.float32)
    table = torch.from_numpy(tab).to(cuda_device)
    if dtype == torch.int32:
        table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape,
                                              dtype=np.int64).astype(np.int32)).to(cuda_device)
    # in range, negative (wrap once), below -C and at/after C (clamp)
    idx = rng.integers(-2 * c, 2 * c, size=n)
    idx[:4] = [-1, c, c + 5, -c - 1][:min(4, n)]
    idx = torch.from_numpy(idx).to(idx_dtype).to(cuda_device)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.3).to(cuda_device)
    for v in (None, valid):
        before = gather_cuda.launches
        got = gather_cuda.gather_rows(table, idx, v)
        torch.cuda.synchronize()
        assert gather_cuda.launches == before + 1
        want = gather_cuda.gather_rows_ref(table, idx, v)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,out_rows,out_cols,axis", [
    (4096, 128, 64, 128, 0), (8, 512, 8, 512, 1), (1 << 19, 128, 8192, 128, 0),
    (37, 5, 11, 5, 0), (6, 33, 6, 70, 1),
    # the vector path with rows that are not a power of two
    (5000, 72, 4000, 72, 0), (2048, 96, 2048, 160, 1),
    (1024, 512, 1024, 512, 1),
])
def test_take_along_kernel_matches_plain_version(cuda_device, rows, cols, out_rows,
                                                 out_cols, axis):
    rng = np.random.default_rng(rows + cols)
    tab = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)).to(cuda_device)
    extent = (rows, cols)[axis]
    idx = rng.integers(-extent - 3, extent + 3, size=(out_rows, out_cols)).astype(np.int32)
    idx = torch.from_numpy(idx).to(cuda_device)
    before = take_along_cuda.launches
    got = take_along_cuda.take_along_axis(tab, idx, axis)
    torch.cuda.synchronize()
    assert take_along_cuda.launches == before + 1
    want = take_along_cuda.take_along_axis_ref(tab, idx, axis)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_take_along_kernel_map_size_wrap_and_nan_fill(cuda_device):
    """The (2^19, 128) table with planted negative indices (wrap once) and
    indices out of range on both sides (NaN fill): equal bit for bit, and
    the fill lands exactly where planted."""
    rows, cols = 1 << 19, 128
    rng = np.random.default_rng(19)
    tab = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, rows, size=(8192, cols)).astype(np.int64)
    flat = idx.reshape(-1)
    spots = rng.choice(flat.size, size=4000, replace=False)
    flat[spots[:1000]] = rng.integers(-rows, 0, size=1000)  # wrap once
    flat[spots[1000:2000]] = rng.integers(rows, 2 ** 31 - 1, size=1000)  # fill
    flat[spots[2000:3000]] = rng.integers(-2 ** 31, -rows, size=1000)  # fill
    flat[spots[3000:]] = [-1, rows, -rows, -rows - 1] * 250  # the edges
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    got = take_along_cuda.take_along_axis(tab, idx_t, 0)
    want = take_along_cuda.take_along_axis_ref(tab, idx_t, 0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    nan = np.isnan(got.cpu().numpy().reshape(-1))
    out = (flat < -rows) | (flat >= rows)
    np.testing.assert_array_equal(nan, out)
    assert out.sum() == 2000 + 500


@pytest.mark.cuda
def test_gather_kernels_reject_bad_inputs(cuda_device):
    tab = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows_cuda(tab.double(), torch.zeros(3, dtype=torch.int64,
                                                               device=cuda_device))
    with pytest.raises(ValueError):
        gather_cuda.gather_rows_cuda(tab, torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError):
        take_along_cuda.take_along_axis_cuda(tab, torch.zeros((2, 5), dtype=torch.int32,
                                                              device=cuda_device), 0)


# ---------------------------------------------------------------------------
# replay: the scatter-adds of the downsample, the map insert and the PGO
# solve sum in a fixed order on the card, so two runs agree bit for bit
# ---------------------------------------------------------------------------
def _replay_inputs(dev):
    from fastliosam_tpu_torch.pgo import graph as pg

    rng = np.random.default_rng(5)
    pts = torch.from_numpy((rng.normal(size=(32768, 3)) * 8).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(size=32768) > 0.1).to(dev)
    n = 64
    poses = []
    for k in range(n):
        T = np.eye(4, dtype=np.float32)
        a = 2 * np.pi * k / n
        T[:3, 3] = [20 * np.cos(a), 20 * np.sin(a), 0.0]
        poses.append(T)
    noisy = [p.copy() for p in poses]
    for p in noisy:
        p[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.2
    rels = [np.linalg.inv(poses[k]) @ poses[(k + 1) % n] for k in range(n)]
    cfg = pg.PoseGraphConfig(max_keyframes=128, max_between=256, max_gps=16)
    graph = pg.from_arrays(cfg, noisy, bt_i=list(range(n)), bt_j=[(k + 1) % n for k in range(n)],
                           bt_rel=rels, bt_sqrt_info=[[10.0] * 3 + [100.0] * 3] * n,
                           gps_idx=[5, 40], gps_xyz=[poses[5][:3, 3], poses[40][:3, 3]],
                           gps_sqrt_info=[[2.0] * 3] * 2, device=dev)
    return pts, mask, graph, cfg


@pytest.mark.cuda
def test_insert_downsample_solve_replay_bitwise(cuda_device):
    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.pgo import solve

    pts, mask, graph, pcfg = _replay_inputs(cuda_device)
    mcfg = vh.VoxelMapConfig(capacity=1 << 19, voxel_size=0.5, insert_probes=2,
                             claim_probes=2, query_probes=2)

    def run():
        ds = voxel_downsample(Cloud(pts, mask), 0.5)
        m = vh.make_map(mcfg, cuda_device)
        for shift in (0.0, 0.13, 0.31):  # revisits: duplicates sum onto old rows
            m, _ = vh.insert(m, mcfg, pts + shift, mask, refresh_planes=True)
        g, cost = solve(graph, pcfg, device=cuda_device)
        torch.cuda.synchronize()
        return [t.cpu() for t in (ds.xyz, ds.mask, *m, g.poses, cost)]

    first, second = run(), run()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the association's merged moments: kernel and plain version bit for bit
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import assoc_cuda  # noqa: E402


def _assoc_check(vh, m, cfg, xyz, mask, mode, probes):
    pools_fn = {"merged": vh.merged_pools, "merged2": vh.merged2_pools,
                "merged3": vh.merged3_pools}[mode]
    coords0, pools = pools_fn(xyz, cfg.voxel_size)
    before = assoc_cuda.launches
    got = assoc_cuda.merged_moments(m.fp, m.moments, pools, coords0, mask, cfg.voxel_size,
                                    probes)
    torch.cuda.synchronize()
    assert assoc_cuda.launches == before + 1
    want = assoc_cuda.merged_moments_ref(m.fp, m.moments, pools, coords0, mask,
                                         cfg.voxel_size, probes)
    assert got.shape == want.shape == (xyz.shape[0], 13)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["merged", "merged2", "merged3"])
@pytest.mark.parametrize("probes", [2, 4])
def test_assoc_kernel_matches_plain_version_collisions(cuda_device, mode, probes):
    """A 512-slot map filled past its capacity: most voxels sit behind a
    foreign fingerprint, many queries find nothing."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    rng = np.random.default_rng(probes)
    cfg = vh.VoxelMapConfig(capacity=1 << 9, voxel_size=0.5, insert_probes=4,
                            claim_probes=4, query_probes=probes)
    pts = torch.from_numpy((rng.uniform(-6, 6, size=(6000, 3))).astype(np.float32))
    m = vh.make_map(cfg, cuda_device)
    m, dropped = vh.insert(m, cfg, pts.to(cuda_device),
                           torch.ones(6000, dtype=torch.bool, device=cuda_device))
    assert int(dropped) > 0  # the table really overflows
    q = torch.from_numpy(rng.uniform(-7, 7, size=(3001, 3)).astype(np.float32)).to(cuda_device)
    qmask = torch.from_numpy(rng.uniform(size=3001) > 0.2).to(cuda_device)
    got = _assoc_check(vh, m, cfg, q, qmask, mode, probes)
    found = got[:, 0] > 0
    assert 0 < int(found.sum()) < 3001


def _figure8_map(dev, n_scans=20):
    """A 2^19-slot map after inserting ``n_scans`` figure-8 scans (the sim's
    loop feed at full width) at their ground-truth poses, and the points of
    the next scan in the world frame."""
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=11)
    traj = Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
    sim = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0, seed=11,
                    time_groups=32)
    data = simulate_sequence(world, traj, sim, n_scans=n_scans + 1)
    cfg = vh.VoxelMapConfig(capacity=1 << 19, voxel_size=0.5, insert_probes=2,
                            claim_probes=2, query_probes=2)
    m = vh.make_map(cfg, dev)
    world_pts = []
    for (pts, _, hit), (R, p) in zip(data["scans"], data["gt"]):
        xyz = torch.from_numpy((pts @ R.T + p).astype(np.float32)).to(dev)
        world_pts.append((xyz, torch.from_numpy(hit).to(dev)))
    for xyz, hit in world_pts[:n_scans]:
        m, _ = vh.insert(m, cfg, xyz, hit, refresh_planes=False)
    return vh, m, cfg, world_pts[n_scans]


@pytest.mark.cuda
def test_assoc_kernel_matches_plain_version_figure8_map(cuda_device):
    vh, m, cfg, (xyz, hit) = _figure8_map(cuda_device)
    for mode in ("merged3", "merged2", "merged"):
        for probes in (2, 4):
            got = _assoc_check(vh, m, cfg, xyz, hit, mode, probes)
            assert int((got[:, 0] > 0).sum()) > 0.5 * int(hit.sum())


@pytest.mark.cuda
def test_assoc_kernel_rejects_bad_inputs(cuda_device):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    cfg = vh.VoxelMapConfig(capacity=1 << 10)
    m = vh.make_map(cfg, cuda_device)
    xyz = torch.zeros((16, 3), device=cuda_device)
    coords0, pools = vh.merged3_pools(xyz, cfg.voxel_size)
    mask = torch.ones(16, dtype=torch.bool, device=cuda_device)
    ok = (m.fp, m.moments, pools, coords0, mask, 0.5, 2)
    bad = [
        (m.fp.float(),) + ok[1:],  # dtype
        (m.fp[:1000].contiguous(),) + ok[1:],  # not a power of two
        (m.fp, m.moments[:, :9].contiguous()) + ok[2:],  # row width
        ok[:2] + (pools.long(),) + ok[3:],
        ok[:2] + (pools[..., :2].contiguous(),) + ok[3:],
        ok[:2] + (torch.cat([pools] * 3),) + ok[3:],  # too many pools
        ok[:3] + (coords0[:8].contiguous(),) + ok[4:],  # query count
        ok[:4] + (mask.int(),) + ok[5:],
        ok[:6] + (9,),  # probes
        ok[:6] + (0,),
        (m.fp.cpu(),) + ok[1:],  # device
        ok[:4] + (mask.cpu(),) + ok[5:],
    ]
    for args in bad:
        with pytest.raises(ValueError):
            assoc_cuda.merged_moments_cuda(*args)
    assoc_cuda.merged_moments_cuda(*ok)  # and the good call goes through


@pytest.mark.cuda
def test_assoc_kernel_merged2_at_voxel_centres(cuda_device):
    """merged2's pools for queries exactly at voxel centres (the own voxel
    twice) and on a tie of two axes, through the kernel at P = 2."""
    vh, m, cfg, (xyz, hit) = _figure8_map(cuda_device)
    occ = torch.nonzero(m.fp != 0)[:, 0][:4000]
    centres = (m.coords[occ].float() + 0.5) * cfg.voxel_size
    tie = centres + torch.tensor([0.125, -0.125, 0.0], device=cuda_device)
    q = torch.cat([centres, tie, xyz]).contiguous()
    mask = torch.cat([torch.ones(2 * len(occ), dtype=torch.bool, device=cuda_device), hit])
    got = _assoc_check(vh, m, cfg, q, mask, "merged2", 2)
    k = len(occ)
    assert int((got[:k, 0] > 0).sum()) > 0.9 * k  # found (own voxel, counted twice)


# ---------------------------------------------------------------------------
# the cached-plane query: kernel and plain version bit for bit (normal, d,
# valid), found and not-found rows alike
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import query_cuda  # noqa: E402


def _query_check(m, cfg, xyz, mask, probes=None):
    probes = probes or cfg.query_probes
    args = (m.fp, m.normal, m.d, m.plane_valid, xyz.contiguous(), mask.contiguous(),
            cfg.voxel_size, probes)
    before = query_cuda.launches
    got = query_cuda.query_cached(*args)
    torch.cuda.synchronize()
    assert query_cuda.launches == before + 1
    want = query_cuda.query_cached_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g) if g.is_floating_point() else g.cpu().numpy(),
                                      _bits(w) if w.is_floating_point() else w.cpu().numpy())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [1, 2, 4, 8])
def test_query_kernel_matches_plain_version_figure8_map(cuda_device, probes):
    """The figure-8 map with its planes refreshed, queried with the next
    scan's points (ragged count, some masked) and far points (no slot:
    slot 0's row, not valid)."""
    vh, m, cfg, (xyz, hit) = _figure8_map(cuda_device)
    m, _ = vh.insert(m, cfg, xyz, hit, refresh_planes=True)  # planes of the touched voxels
    far = torch.full((77, 3), 900.0, device=cuda_device) + torch.arange(77, device=cuda_device)[:, None]
    q = torch.cat([xyz[:8191], far])
    mask = torch.cat([hit[:8191], torch.ones(77, dtype=torch.bool, device=cuda_device)])
    mask[::13] = False
    n, d, valid = _query_check(m, cfg, q, mask, probes)
    assert not bool(valid[-77:].any()) and not bool(valid[::13].any())
    assert torch.equal(n[-77:], m.normal[0].expand(77, 3))
    if probes >= 2:
        assert int(valid.sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_masked", "tight", "empty_map", "surfel_map"])
def test_query_kernel_matches_plain_version_cases(cuda_device, case):
    """All queries masked; a 512-slot table filled past capacity (voxels
    behind foreign fingerprints, found at every probe); an empty map; and
    the loop closure's 2^14-slot surfel map at 16,384 queries, 4 probes."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    rng = np.random.default_rng(len(case))
    cap, n, half = {"all_masked": (1 << 12, 2000, 3.0), "tight": (1 << 9, 3001, 6.0),
                    "empty_map": (1 << 10, 1000, 3.0), "surfel_map": (1 << 14, 16384, 20.0)}[case]
    cfg = vh.VoxelMapConfig(capacity=cap, voxel_size=1.0 if case == "surfel_map" else 0.5,
                            min_points=5 if case == "surfel_map" else 3)
    pts = torch.from_numpy(rng.uniform(-half, half, size=(n, 3)).astype(np.float32))
    if case == "surfel_map":  # walls and a floor, as a submap holds
        pts[: n // 2, 2] = 0.0
        pts[n // 2:, 1] = 7.0
    pts = pts.to(cuda_device)
    m = vh.make_map(cfg, cuda_device)
    if case != "empty_map":
        m, dropped = vh.insert(m, cfg, pts, torch.ones(n, dtype=torch.bool, device=cuda_device))
        if case == "tight":
            assert int(dropped) > 0
    mask = torch.from_numpy(rng.uniform(size=n) > 0.1).to(cuda_device)
    if case == "all_masked":
        mask[:] = False
    n_, d, valid = _query_check(m, cfg, pts, mask)
    if case in ("all_masked", "empty_map"):
        assert not bool(valid.any())
    else:
        assert int(valid.sum()) > 0


@pytest.mark.cuda
def test_query_kernel_rejects_bad_inputs(cuda_device):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    m = vh.make_map(vh.VoxelMapConfig(capacity=1 << 10), cuda_device)
    xyz = torch.zeros((16, 3), device=cuda_device)
    mask = torch.ones(16, dtype=torch.bool, device=cuda_device)
    ok = (m.fp, m.normal, m.d, m.plane_valid, xyz, mask, 0.5, 2)
    bad = [
        (m.fp.float(),) + ok[1:],  # dtype
        (m.fp[:1000].contiguous(),) + ok[1:],  # not a power of two
        ok[:1] + (m.normal[:, :2].contiguous(),) + ok[2:],
        ok[:2] + (m.d[:8].contiguous(),) + ok[3:],
        ok[:3] + (m.plane_valid.bool(),) + ok[4:],
        ok[:4] + (xyz.double(),) + ok[5:],
        ok[:4] + (xyz.t().contiguous().t(),) + ok[5:],  # not contiguous
        ok[:5] + (mask.int(),) + ok[6:],
        ok[:5] + (mask[:8].contiguous(),) + ok[6:],  # query count
        ok[:7] + (9,),  # probes
        ok[:7] + (0,),
        ok[:4] + (xyz.cpu(),) + ok[5:],  # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            query_cuda.query_cached_cuda(*args)
    query_cuda.query_cached_cuda(*ok)  # and the good call goes through


# ---------------------------------------------------------------------------
# the map insert's probe-and-claim rounds: kernel and plain version bit for
# bit on fp, coords, sl, n_dropped and the upd rows of assigned points (the
# unassigned rows go to the moment scatter's dead segment, never read)
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import insert_cuda  # noqa: E402


def _insert_check(dev, m, xyz, mask, rounds, voxel_size=0.5, max_points=1000.0):
    args = (m.fp.to(dev), m.coords.to(dev), m.moments.to(dev), xyz.to(dev), mask.to(dev),
            voxel_size, rounds, max_points)
    before = insert_cuda.launches
    got = insert_cuda.insert_claim(*args)
    torch.cuda.synchronize()
    assert insert_cuda.launches == before + 1
    want = insert_cuda.insert_claim_ref(*args)
    cap = m.fp.shape[0]
    for k in (0, 1, 2, 4):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k].cpu().numpy())
    assigned = (want[2] < cap).cpu().numpy()
    np.testing.assert_array_equal(_bits(got[3])[assigned], _bits(want[3])[assigned])
    return got


def _prefilled(vh, cfg, pts, mask):
    """A map filled on the CPU (plain version), for the card's inputs."""
    m, _ = vh.insert(vh.make_map(cfg, "cpu"), cfg, pts, mask, refresh_planes=False)
    return m


def _insert_case(case, rounds):
    """``(map, xyz, mask, max_points)`` on the CPU for one card case."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    rng = np.random.default_rng(rounds + len(case))
    cap, n, half = {"roomy": (1 << 12, 3000, 3.0), "tight": (1 << 9, 3000, 6.0),
                    "all_masked": (1 << 12, 2000, 3.0), "ragged_n": (1 << 14, 8229, 12.0),
                    "large_n": (1 << 20, 300_000, 60.0), "one_voxel": (1 << 10, 2010, 0.0)}[case]
    cfg = vh.VoxelMapConfig(capacity=cap, insert_probes=rounds, claim_probes=rounds)
    max_points = 1000.0
    if case == "one_voxel":
        # 2000 points in a saturated voxel, 10 in one with room (5 points at most)
        a, b = np.array([0.1, 0.2, 0.3]), np.array([3.1, -2.2, 0.3])
        pre = np.concatenate([a + rng.uniform(0, 0.2, (10, 3)), b + rng.uniform(0, 0.2, (2, 3))])
        m = _prefilled(vh, cfg, torch.from_numpy(pre.astype(np.float32)),
                       torch.ones(12, dtype=torch.bool))
        xyz = np.concatenate([a + rng.uniform(0, 0.2, (2000, 3)),
                              b + rng.uniform(0, 0.2, (10, 3))])
        return m, torch.from_numpy(xyz.astype(np.float32)), torch.ones(n, dtype=torch.bool), 5.0
    xyz = torch.from_numpy(rng.uniform(-half, half, size=(n, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=n) > 0.1)
    if case == "all_masked":
        mask = torch.zeros(n, dtype=torch.bool)
    pre = torch.from_numpy(rng.uniform(-half, half, size=(n // 2, 3)).astype(np.float32))
    m = _prefilled(vh, cfg, pre, torch.ones(n // 2, dtype=torch.bool))
    return m, xyz, mask, max_points


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["roomy", "tight", "all_masked", "one_voxel", "ragged_n",
                                  "large_n"])
@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_insert_kernel_matches_plain_version(cuda_device, case, rounds):
    m, xyz, mask, max_points = _insert_case(case, rounds)
    got = _insert_check(cuda_device, m, xyz, mask, rounds, max_points=max_points)
    dropped, n = int(got[4]), xyz.shape[0]
    if case == "tight":
        assert dropped > 0  # the table really overflows
    if case == "all_masked":
        assert dropped == 0 and bool((got[2] == m.fp.shape[0]).all())
        assert torch.equal(got[0].cpu(), m.fp)
    if case == "one_voxel":  # the saturated voxel takes no update, the other one does
        w = got[3][:, 0].cpu()
        assert bool((w[:2000] == 0).all()) and bool((w[2000:] == 1).all())
    if case == "large_n":
        blocks, per_thread = insert_cuda.insert_claim_grid(n, cuda_device)
        assert per_thread >= 2  # beyond one point per thread of a full grid


@pytest.mark.cuda
def test_insert_kernel_evicted_holes(cuda_device):
    """Holes that evict_far punched in the probe chains, refilled by an
    overlapping re-insert: kernel and plain version agree."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    rng = np.random.default_rng(3)
    cfg = vh.VoxelMapConfig(capacity=1 << 10, insert_probes=4, claim_probes=4)
    m = _prefilled(vh, cfg, torch.from_numpy(rng.uniform(-5, 5, (3000, 3)).astype(np.float32)),
                   torch.ones(3000, dtype=torch.bool))
    ev = vh.evict_far(m, cfg, torch.tensor([2.0, 0.0, 0.0]), 4.0)
    assert int((ev.fp != 0).sum()) < int((m.fp != 0).sum())
    xyz = torch.from_numpy(rng.uniform(-5, 5, (3000, 3)).astype(np.float32))
    got = _insert_check(cuda_device, ev, xyz, torch.ones(3000, dtype=torch.bool), 4)
    assert int((got[0].cpu()[ev.fp == 0] != 0).sum()) > 0  # holes refilled


@pytest.mark.cuda
def test_insert_kernel_repeat_identical_words(cuda_device):
    m, xyz, mask, _ = _insert_case("tight", 2)
    args = (m.fp.to(cuda_device), m.coords.to(cuda_device), m.moments.to(cuda_device),
            xyz.to(cuda_device), mask.to(cuda_device), 0.5, 2, 1000.0)
    first = insert_cuda.insert_claim_cuda(*args)
    second = insert_cuda.insert_claim_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):  # every word, the unassigned upd rows too
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_insert_kernel_rejects_bad_inputs(cuda_device):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    m = vh.make_map(vh.VoxelMapConfig(capacity=1 << 10), cuda_device)
    xyz = torch.zeros((16, 3), device=cuda_device)
    mask = torch.ones(16, dtype=torch.bool, device=cuda_device)
    ok = (m.fp, m.coords, m.moments, xyz, mask, 0.5, 2, 1000.0)
    bad = [
        (m.fp.float(),) + ok[1:],  # dtype
        (m.fp[:1000].contiguous(),) + ok[1:],  # not a power of two
        ok[:1] + (m.coords[:, :2].contiguous(),) + ok[2:],
        ok[:2] + (m.moments[:, :9].contiguous(),) + ok[3:],
        ok[:3] + (xyz.double(),) + ok[4:],
        ok[:3] + (xyz[:, :2].contiguous(),) + ok[4:],
        ok[:3] + (xyz.t().contiguous().t(),) + ok[4:],  # not contiguous
        ok[:4] + (mask.int(),) + ok[5:],
        ok[:4] + (mask[:8].contiguous(),) + ok[5:],  # point count
        ok[:6] + (0,) + ok[7:],  # rounds
        ok[:3] + (xyz.cpu(),) + ok[4:],  # device
        (m.fp.cpu(),) + ok[1:],
    ]
    for args in bad:
        with pytest.raises(ValueError):
            insert_cuda.insert_claim_cuda(*args)
    insert_cuda.insert_claim_cuda(*ok)  # and the good call goes through


# ---------------------------------------------------------------------------
# the localizer's shapes: the NN of global_init's ICP against a map's voxel
# centroids, the map build's 65,536-point inserts and the plane refresh's
# reads at their slots; and a checkpoint resume through drive_kitti's staging
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_nn_kernel_matches_plain_version_centroid_shape(cuda_device):
    """2048 sources against a (2^17, 3) centroid table with ~70% of its
    slots empty (masked, at 1e6 as occupied_centroids leaves them), at map
    coordinates up to 60 m."""
    rng = np.random.default_rng(17)
    m = 1 << 17
    dst = (rng.uniform(-60, 60, size=(m, 3)) * [1, 1, 0.1]).astype(np.float32)
    occ = rng.uniform(size=m) < 0.3
    dst[~occ] = 1e6
    src = (rng.uniform(-60, 60, size=(2048, 3)) * [1, 1, 0.1]).astype(np.float32)
    s, d, mk = (torch.from_numpy(a).to(cuda_device) for a in (src, dst, occ))
    k_idx, k_d2 = nn_cuda.nearest_neighbors(s, d, mk)
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(s, d, mk)
    k_idx, k_d2, r_idx, r_d2 = (t.cpu().numpy() for t in (k_idx, k_d2, r_idx, r_d2))
    # at 60 m coordinates the float32 expansion |s|^2 + |d|^2 - 2 s.d
    # rounds to a few ulps of |s|^2 + |d|^2 (~7e3 m^2) in either order:
    # 4 ulps of that sum on top of rtol 1e-5
    mag = (src ** 2).sum(-1) + (dst[r_idx] ** 2).sum(-1)
    tol = 1e-5 * np.abs(r_d2) + 4 * 2.0 ** -23 * mag
    assert (np.abs(k_d2 - r_d2) <= tol).all()
    diff = k_idx != r_idx
    dk = ((src[diff] - dst[k_idx[diff]]) ** 2).sum(-1)
    dr = ((src[diff] - dst[r_idx[diff]]) ** 2).sum(-1)
    assert (np.abs(dk - dr) <= tol[diff]).all()
    assert occ[k_idx].all()


def _half_built_map(dev, n=65536, cap=1 << 17):
    """A map after a first 65,536-point batch, and a second overlapping
    batch (the map build's inserts, 4 rounds)."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    rng = np.random.default_rng(65)
    cfg = vh.VoxelMapConfig(capacity=cap)
    first = torch.from_numpy(rng.uniform(-40, 40, size=(n, 3)).astype(np.float32) * [1, 1, 0.1])
    m, _ = vh.insert(vh.make_map(cfg, "cpu"), cfg, first.float(), torch.ones(n, dtype=torch.bool))
    xyz = torch.from_numpy(rng.uniform(-45, 45, size=(n, 3)).astype(np.float32) * [1, 1, 0.1])
    mask = torch.from_numpy(rng.uniform(size=n) > 0.05)
    return m, xyz.float(), mask


@pytest.mark.cuda
def test_insert_kernel_matches_plain_version_map_build_batch(cuda_device):
    m, xyz, mask = _half_built_map(cuda_device)
    got = _insert_check(cuda_device, m, xyz, mask, 4)
    assert int((got[0] != 0).sum()) > int((m.fp != 0).sum())


@pytest.mark.cuda
def test_gather_rows_kernel_matches_plain_version_plane_refresh_batch(cuda_device):
    """The plane refresh after that insert: the (2^17, 10) moments and (2^17,
    3) coordinates at its 65,536 int64 slots (C where unassigned)."""
    m, xyz, mask = _half_built_map(cuda_device)
    args = (m.fp.to(cuda_device), m.coords.to(cuda_device), m.moments.to(cuda_device),
            xyz.to(cuda_device), mask.to(cuda_device), 0.5, 4, 1000.0)
    _, coords, sl, _, _ = insert_cuda.insert_claim(*args)
    assert sl.dtype == torch.int64 and sl.shape == (65536,)
    for table in (args[2], coords):
        got = gather_cuda.gather_rows(table, sl)
        want = gather_cuda.gather_rows_ref(table, sl)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_kitti_checkpoint_resume_bitwise(cuda_device, tmp_path):
    """60 scans of the synthetic KITTI circuit at small width through the
    staging of drive_kitti: an engine that saved a checkpoint at scan 30 and an
    engine restored from it drive scans 30-60 to the same bits."""
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.loop import LoopConfig
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import OdomConfig
    from fastliosam_tpu_torch.pgo import PoseGraphConfig
    from fastliosam_tpu_torch.runtime import (EngineConfig, SlamEngine, load_checkpoint,
                                              save_checkpoint)
    from fastliosam_tpu_torch.runtime.drivers import kitti_stager
    from fastliosam_tpu_torch.scripts import make_kitti_synth

    root = str(tmp_path / "kitti")
    make_kitti_synth.generate(root, "00", n_scans=60, n_azimuth=512, n_elev=16, progress=False)
    seq = KittiSequence(root, "00")

    def engine():
        return SlamEngine(
            odom_cfg=OdomConfig(point_filter_num=1, filter_size_surf=0.5, num_ds_points=2048,
                                det_range=60.0, evict_every=20, query_mode="merged3"),
            map_cfg=VoxelMapConfig(capacity=1 << 16, query_probes=2, insert_probes=2,
                                   claim_probes=2),
            loop_cfg=LoopConfig(radius=10.0, time_gap=4.0, submap_points=4096,
                                icp_score_threshold=0.5, max_sqrt_info=1.0),
            pgo_cfg=PoseGraphConfig(max_keyframes=64, max_between=128, max_gps=8),
            cfg=EngineConfig(loop_check_every=5, kf_cloud_points=1024),
            device=cuda_device)

    def drive(e, c0, c1):
        stage = kitti_stager(e, seq, 8192, 5)
        for c in range(c0, c1, 5):
            e.process_chunk_deferred(*stage(c, 5), 0.1)
        e.finish()

    first = engine()
    drive(first, 0, 30)
    save_checkpoint(first, str(tmp_path / "ckpt.npz"))
    drive(first, 30, 60)
    restored = load_checkpoint(engine(), str(tmp_path / "ckpt.npz"))
    drive(restored, 30, 60)
    assert first.kf.n == restored.kf.n > 5
    np.testing.assert_array_equal(np.stack(first.realtime_traj), np.stack(restored.realtime_traj))
    np.testing.assert_array_equal(first.keyframe_poses(), restored.keyframe_poses())
    assert first.loop_pairs == restored.loop_pairs


@pytest.mark.cuda
def test_run_slam_bag_launches_the_path_kernels(cuda_device, tmp_path, monkeypatch):
    """``run_slam --dataset bag`` on the card over 60 scans of the figure-8
    recording at 256 x 64 rays (``sim/writers.py``), loops at 10 m / 2 s
    (the 150-scan run of ``chip_smoke.py`` closes its first at 10 m / 4 s):
    the association, the insert, the plane refresh's row gather and the
    loop ICP's nearest neighbours each launch, and every pose is finite.
    The run again with plain pageable ``.to(device)`` uploads in place of
    the pinned non-blocking ones gives the same bits."""
    from fastliosam_tpu_torch.io.presets import PRESETS
    from fastliosam_tpu_torch.ops import KERNEL_MODULES
    from fastliosam_tpu_torch.scripts import run_slam
    from fastliosam_tpu_torch.sim import writers

    pre = PRESETS["newer-college2020"]
    bag = writers.write_bag(str(tmp_path / "fig8.bag"),
                            writers.render_figure8(60, pre, 256, 64), pre, 256, 64)
    for mod in KERNEL_MODULES:
        mod.reset_launches()
    argv = ["--dataset", "bag", "--preset", "newer-college2020", "--root", bag,
            "--num-ds-points", "4096", "--map-capacity-log2", "17", "--loop-radius", "10",
            "--loop-time-gap", "2", "--out", str(tmp_path / "out")]
    engine, _ = run_slam.run(argv)
    launches = {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}
    assert len(engine.realtime_traj) == 60 and len(engine.loop_attempts) >= 1
    assert np.all(np.isfinite(np.stack(engine.realtime_traj)))
    for name in ("merged_moments", "insert_claim", "refresh_planes", "nearest_neighbors"):
        assert launches[name] > 0, (name, launches)
    assert launches["gather_rows"] == 0  # its engine reads live in refresh_planes
    monkeypatch.setattr(run_slam, "upload", lambda a, dev, dtype=torch.float32:
                        torch.as_tensor(a, dtype=dtype).to(dev))
    pageable, _ = run_slam.run(argv)
    np.testing.assert_array_equal(np.stack(pageable.realtime_traj),
                                  np.stack(engine.realtime_traj))
    assert pageable.loop_pairs == engine.loop_pairs


# ---------------------------------------------------------------------------
# the map kernels at lane shapes (the batched rollout, eval/batch_eval.py):
# one launch for all lanes, bit for bit against the lane-batched plain
# version and, lane by lane, against the unbatched kernel on that lane's
# table alone
# ---------------------------------------------------------------------------
def _lane_map(vh, cfg, lanes, n, half, seed):
    """``lanes`` maps, each filled on the CPU by its own insert (planes
    fitted) of ``n`` points of another spread, stacked lane-major."""
    rng = np.random.default_rng(seed)
    maps = []
    for b in range(lanes):
        pts = torch.from_numpy(rng.uniform(-half, half, size=(n, 3)).astype(np.float32)
                               * (1.0 + 0.1 * b))
        m, _ = vh.insert(vh.make_map(cfg, "cpu"), cfg, pts, torch.ones(n, dtype=torch.bool))
        maps.append(m)
    return vh.VoxelMap(*(torch.stack(f) for f in zip(*maps)))


def _lane_queries_card(dev, lanes, n, half, seed, masked=0.1):
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(-half, half, size=(lanes, n, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(lanes, n)) > masked)
    return xyz.to(dev), mask.to(dev)


LANE_CASES = [(1, 3001), (3, 3001), (8, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n", LANE_CASES)
@pytest.mark.parametrize("mode", ["merged", "merged2", "merged3"])
def test_assoc_kernel_lanes(cuda_device, lanes, n, mode):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    cfg = vh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, query_probes=2)
    m = vh.VoxelMap(*(t.to(cuda_device) for t in _lane_map(vh, cfg, lanes, 3000, 8.0, lanes)))
    xyz, mask = _lane_queries_card(cuda_device, lanes, n, 9.0, n)
    pools_fn = {"merged": vh.merged_pools, "merged2": vh.merged2_pools,
                "merged3": vh.merged3_pools}[mode]
    coords0, pools = pools_fn(xyz, cfg.voxel_size)
    before = assoc_cuda.launches
    got = assoc_cuda.merged_moments(m.fp, m.moments, pools, coords0, mask, 0.5, 2)
    torch.cuda.synchronize()
    assert assoc_cuda.launches == before + 1 and got.shape == (lanes, n, 13)
    want = assoc_cuda.merged_moments_ref(m.fp, m.moments, pools, coords0, mask, 0.5, 2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for b in range(lanes):
        one = assoc_cuda.merged_moments_cuda(m.fp[b], m.moments[b], pools[:, b].contiguous(),
                                             coords0[b], mask[b], 0.5, 2)
        np.testing.assert_array_equal(_bits(got[b]), _bits(one))
    assert 0 < int((got[..., 0] > 0).sum()) < lanes * n


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,cap,rounds", [(1, 3000, 1 << 12, 2), (3, 3001, 1 << 9, 4),
                                                (8, 8192, 1 << 14, 2), (32, 8192, 1 << 12, 2)])
def test_insert_kernel_lanes(cuda_device, lanes, n, cap, rounds):
    """Up to 32 lanes x 8192 points in one cooperative launch; the tight
    512-slot lanes drop points, each its own count."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    cfg = vh.VoxelMapConfig(capacity=cap, insert_probes=rounds, claim_probes=rounds)
    m = vh.VoxelMap(*(t.to(cuda_device) for t in _lane_map(vh, cfg, lanes, n // 4, 6.0, cap)))
    xyz, mask = _lane_queries_card(cuda_device, lanes, n, 6.0, lanes + n)
    args = (m.fp, m.coords, m.moments, xyz, mask, 0.5, rounds, 1000.0)
    blocks, per_thread = insert_cuda.insert_claim_grid(lanes * n, cuda_device)
    assert blocks > 0 and per_thread <= 16
    before = insert_cuda.launches
    got = insert_cuda.insert_claim(*args)
    torch.cuda.synchronize()
    assert insert_cuda.launches == before + 1
    want = insert_cuda.insert_claim_ref(*args)
    assert got[4].shape == (lanes,)
    for k in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k].cpu().numpy())
    assigned = (want[2] < cap).cpu().numpy()
    np.testing.assert_array_equal(_bits(got[3])[assigned], _bits(want[3])[assigned])
    for b in range(lanes):
        one = insert_cuda.insert_claim_cuda(m.fp[b], m.coords[b], m.moments[b], xyz[b],
                                            mask[b], 0.5, rounds, 1000.0)
        for k in (0, 1, 2, 4):
            np.testing.assert_array_equal(got[k][b].cpu().numpy(), one[k].cpu().numpy())
        np.testing.assert_array_equal(_bits(got[3][b])[assigned[b]], _bits(one[3])[assigned[b]])
    if cap == 1 << 9:
        assert int(got[4].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n", LANE_CASES)
def test_query_kernel_lanes(cuda_device, lanes, n):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    cfg = vh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=3)
    m = vh.VoxelMap(*(t.to(cuda_device) for t in _lane_map(vh, cfg, lanes, 3000, 5.0, n)))
    xyz, mask = _lane_queries_card(cuda_device, lanes, n, 6.0, lanes)
    args = (m.fp, m.normal, m.d, m.plane_valid, xyz, mask, 0.5, 4)
    before = query_cuda.launches
    got = query_cuda.query_cached(*args)
    torch.cuda.synchronize()
    assert query_cuda.launches == before + 1
    want = query_cuda.query_cached_ref(*args)

    def words(t):  # float words as int32 bits, the bool valid flags as they are
        return t.cpu().numpy() if t.dtype == torch.bool else _bits(t)

    for g, w in zip(got, want):
        np.testing.assert_array_equal(words(g), words(w))
    for b in range(lanes):
        one = query_cuda.query_cached_cuda(m.fp[b], m.normal[b], m.d[b], m.plane_valid[b],
                                           xyz[b], mask[b], 0.5, 4)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(words(g[b]), words(o))
    assert 0 < int(got[2].sum()) < lanes * n


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,d,idx_dtype", [(1, 10, torch.int64), (3, 10, torch.int64),
                                               (3, 0, torch.int32), (8, 3, torch.int32)])
def test_gather_rows_kernel_lanes(cuda_device, lanes, d, idx_dtype):
    """A lane-major table, indices out of range both ways (wrapped and
    clamped within the lane) and rows masked by valid."""
    rng = np.random.default_rng(lanes + d)
    c, n = 1000, 777
    shape = (lanes, c) + ((d,) if d else ())
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-c - 50, c + 50, size=(lanes, n))).to(idx_dtype)
    idx = idx.to(cuda_device)
    valid = torch.from_numpy(rng.uniform(size=(lanes, n)) > 0.2).to(cuda_device)
    before = gather_cuda.launches
    got = gather_cuda.gather_rows(table, idx, valid, lane_major=True)
    torch.cuda.synchronize()
    assert gather_cuda.launches == before + 1 and got.shape == (lanes, n) + shape[2:]
    np.testing.assert_array_equal(
        _bits(got), _bits(gather_cuda.gather_rows_ref(table, idx, valid, lane_major=True)))
    for b in range(lanes):
        np.testing.assert_array_equal(
            _bits(got[b]), _bits(gather_cuda.gather_rows_cuda(table[b], idx[b], valid[b])))


@pytest.mark.cuda
def test_lane_kernels_reject_bad_inputs(cuda_device):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    m = vh.make_map(vh.VoxelMapConfig(capacity=1 << 10), cuda_device, lanes=3)
    xyz = torch.zeros((2, 16, 3), device=cuda_device)  # 2 lanes of points, 3 of tables
    mask = torch.ones((2, 16), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        insert_cuda.insert_claim_cuda(m.fp, m.coords, m.moments, xyz, mask, 0.5, 2, 1000.0)
    with pytest.raises(ValueError):
        query_cuda.query_cached_cuda(m.fp, m.normal, m.d, m.plane_valid, xyz, mask, 0.5, 2)
    coords0, pools = vh.merged3_pools(xyz, 0.5)
    with pytest.raises(ValueError):
        assoc_cuda.merged_moments_cuda(m.fp, m.moments, pools, coords0, mask, 0.5, 2)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows_cuda(m.moments, torch.zeros((2, 5), dtype=torch.int64,
                                                            device=cuda_device), lane_major=True)


def _room_lanes(dev, seeds, n_scans=4):
    """The room feed of tests/test_batch_eval.py (128 x 8 rays), one lane
    per seed, on the card: ``(scans, imus, start states, scan_dt)``."""
    from fastliosam_tpu_torch.eval.batch_eval import stack_states
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import ImuBatch, OdomConfig, Scan, init_odom
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    map_cfg = VoxelMapConfig(capacity=1 << 14, voxel_size=0.5, min_points=4)
    cfg = OdomConfig(point_filter_num=1, blind=0.5, filter_size_surf=0.4, num_ds_points=1024,
                     evict_every=10_000, max_imu_per_scan=32)
    traj = Trajectory.circle(radius=8.0, period=40.0)
    scans, imus, states, dt = [], [], [], None
    for seed in seeds:
        data = simulate_sequence(PlaneWorld.room(size=24.0, height=5.0, n_boxes=5, seed=seed),
                                 traj, SimConfig(n_azimuth=128, n_elev=8, seed=seed),
                                 n_scans=n_scans)
        dt = data["scan_dt"]
        scans.append([np.stack([s[i] for s in data["scans"]]) for i in range(3)])
        cap = 32
        rows = []
        for ts, gy, ac in data["imu"]:
            k = len(ts)
            rows.append((np.pad(ts, (0, cap - k), constant_values=1e9).astype(np.float32),
                         np.pad(gy, ((0, cap - k), (0, 0))).astype(np.float32),
                         np.pad(ac, ((0, cap - k), (0, 0))).astype(np.float32),
                         np.arange(cap) < k))
        imus.append([np.stack([r[i] for r in rows]) for i in range(4)])
        st = init_odom(map_cfg, cfg, device=dev)
        R0, p0 = traj.pose(0.0)
        states.append(st._replace(nav=st.nav._replace(
            R=torch.tensor(R0, dtype=torch.float32, device=dev),
            p=torch.tensor(p0, dtype=torch.float32, device=dev),
            v=torch.tensor(traj.velocity(0.0), dtype=torch.float32, device=dev))))
    sc = Scan(*(torch.from_numpy(np.stack([s[i] for s in scans])).to(dev) for i in range(3)))
    im = ImuBatch(*(torch.from_numpy(np.stack([s[i] for s in imus])).to(dev) for i in range(4)))
    return sc, im, stack_states(states), dt, cfg, map_cfg


@pytest.mark.cuda
def test_batched_rollout_on_the_card(cuda_device):
    """The batched rollout on the card: one association per query pass and
    one insert per step at 1 lane and at 4; lane isolation bit for bit;
    the replay bit for bit; each lane within 5 mm of the unbatched rollout
    (tests/test_batch_eval.py's bound)."""
    from fastliosam_tpu_torch.eval.batch_eval import batched_rollout
    from fastliosam_tpu_torch.odom import ImuBatch, Scan, odom_rollout
    from fastliosam_tpu_torch.ops import KERNEL_MODULES

    def run(seeds):
        sc, im, st, dt, cfg, map_cfg = _room_lanes(cuda_device, seeds)
        for mod in KERNEL_MODULES:
            mod.reset_launches()
        fin, aux = batched_rollout(st, sc, im, dt, cfg, map_cfg, device=cuda_device)
        torch.cuda.synchronize()
        return aux, {m.KERNEL["name"]: m.launches for m in KERNEL_MODULES}

    aux4, l4 = run([1, 7, 13, 1])
    aux1, l1 = run([1])
    for name in ("merged_moments", "insert_claim"):
        assert l4[name] == l1[name] > 0
    assert l4["insert_claim"] == 4  # one a step
    again, _ = run([1, 7, 13, 1])
    assert all(torch.equal(aux4[k], again[k]) for k in ("R", "p", "n_matched"))
    other, _ = run([1, 9, 13, 1])
    for k in ("R", "p", "n_matched"):
        assert torch.equal(other[k][[0, 2, 3]], aux4[k][[0, 2, 3]])
        assert torch.equal(aux4[k][0], aux4[k][3])
    sc, im, st, dt, cfg, map_cfg = _room_lanes(cuda_device, [7])
    one = type(st)(type(st.nav)(*(t[0] for t in st.nav)), type(st.vmap)(*(t[0] for t in st.vmap)),
                   0, False, st.w_cv[0])
    _, ref = odom_rollout(one, Scan(*(t[0] for t in sc)), ImuBatch(*(t[0] for t in im)), dt,
                          cfg, map_cfg, device=cuda_device)
    np.testing.assert_allclose(aux4["p"][1].cpu().numpy(), ref["p"].cpu().numpy(), atol=5e-3)


@pytest.mark.cuda
def test_nn_kernel_at_the_mesh_rank_shape(cuda_device):
    """The point-sharded loop ICP's nearest neighbours a rank at 4 ranks: a
    quarter of the 16,384 source points against the whole 16,384-point
    destination (``parallel/sharded_loop.py``), the tolerance above."""
    src, dst, mask = _inputs(11, 4096, 16384)
    s, d, mk = (torch.from_numpy(a).to(cuda_device) for a in (src, dst, mask))
    k_idx, k_d2 = nn_cuda.nearest_neighbors(s, d, mk)
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(s, d, mk)
    k_idx, k_d2, r_idx, r_d2 = (t.cpu().numpy() for t in (k_idx, k_d2, r_idx, r_d2))
    np.testing.assert_allclose(k_d2, r_d2, rtol=1e-5, atol=1e-4)
    diff = k_idx != r_idx
    np.testing.assert_allclose(((src[diff] - dst[k_idx[diff]]) ** 2).sum(-1),
                               ((src[diff] - dst[r_idx[diff]]) ** 2).sum(-1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_sharded_map_two_gloo_ranks_on_the_card(cuda_device, tmp_path):
    """Two gloo ranks on ``cuda:0`` (``tests/_torch_mesh_worker.py``): the
    sharded gram, two insert batches and the merged3 query against the
    port's replicated functions on the card (the insert and association
    kernels). Tolerances of ``tests/test_parallel.py``: gram rtol 1e-4 /
    atol 1e-3, fingerprints exact, moments rtol 1e-6 / atol 1e-5, valid
    flags exact, normals 1e-4, d 1e-3 and rvar rtol 1e-3 on valid rows."""
    import json

    from _torch_mesh_worker import spawn_ranks

    from fastliosam_tpu_torch.map import VoxelMapConfig, insert, make_map
    from fastliosam_tpu_torch.map.voxel_hash import query_planes_merged3

    rng = np.random.default_rng(0)
    n = 8192
    pts = np.stack([rng.uniform(-30, 30, n), rng.uniform(-30, 30, n),
                    0.05 * rng.standard_normal(n)], 1).astype(np.float32)
    cfg = dict(capacity=1 << 16, voxel_size=0.5, min_points=5, query_probes=2,
               insert_probes=2, claim_probes=2)
    inp = {"map.pts": pts, "map.mask": rng.uniform(size=n) > 0.1,
           "map.q": pts + rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32),
           "map.pts2": pts + rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
           "map.cfg": json.dumps(cfg),
           "gram.A": rng.normal(size=(4096, 6)).astype(np.float32),
           "gram.w": (rng.uniform(size=4096) > 0.3).astype(np.float32),
           "gram.r": rng.normal(size=4096).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", **inp)
    outs = spawn_ranks(2, str(tmp_path / "inputs.npz"), str(tmp_path / "out"),
                       ["gram", "map"], device="cuda:0", threads=2)
    A, w, r = inp["gram.A"], inp["gram.w"], inp["gram.r"]
    vm_cfg = VoxelMapConfig(**cfg)
    t = {k: torch.from_numpy(inp[f"map.{k}"]).to(cuda_device)
         for k in ("pts", "mask", "q", "pts2")}
    m, drop = insert(make_map(vm_cfg, cuda_device), vm_cfg, t["pts"], t["mask"],
                     refresh_planes=False)
    nrm, d, valid, rvar = (x.cpu().numpy() for x in
                           query_planes_merged3(m, vm_cfg, t["q"], t["mask"]))
    m2, _ = insert(m, vm_cfg, t["pts2"], t["mask"], refresh_planes=False)
    for o in outs:
        np.testing.assert_allclose(o["gram.G"], A.T @ (A * w[:, None]), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(o["gram.b"], (A * w[:, None]).T @ r, rtol=1e-4, atol=1e-3)
        assert int(o["gram.n"]) == int(np.sum(w > 0))
        assert int(o["map.shard_rows"]) == vm_cfg.capacity // 2
        assert int(o["map.drop"]) == int(drop)
        np.testing.assert_array_equal(o["map.fp"], m.fp.cpu().numpy())
        np.testing.assert_allclose(o["map.moments"], m.moments.cpu().numpy(),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(o["map.q_valid"], valid)
        np.testing.assert_allclose(o["map.q_n"][valid], nrm[valid], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["map.q_d"][valid], d[valid], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(o["map.q_rvar"][valid], rvar[valid], rtol=1e-3, atol=1e-5)
        np.testing.assert_array_equal(o["map.fp2"], m2.fp.cpu().numpy())
        np.testing.assert_allclose(o["map.moments2"], m2.moments.cpu().numpy(),
                                   rtol=1e-6, atol=1e-5)


# the post-processing toolbox's float64 kernels: k nearest neighbours
# (csrc/knn.cu) and the clustering's neighbour-voxel test (csrc/cluster.cu),
# each bit for bit against its plain version


from fastliosam_tpu_torch.ops.kneighbors_cuda import GRID_MIN_DST  # noqa: E402
from fastliosam_tpu_torch.scripts import exp_knn  # noqa: E402

KNN_HAZARDS = [name for name, *_ in exp_knn.hazard_sets(0, scale=0.5)]


def _knn_case(case):
    """``(src, dst, k, exclude_self)`` as numpy: random points with exact
    duplicates for an ``(n, m, k, exclude_self)`` case, else the hazard set
    of that name (``scripts/exp_knn.py``)."""
    if isinstance(case, str):
        _, src, dst, k, excl = next(s for s in exp_knn.hazard_sets(0, scale=0.5) if s[0] == case)
        return src, dst, k, excl
    n, m, k, excl = case
    rng = np.random.default_rng(n + m + k)
    dst = rng.normal(size=(m, 3)) * 4
    # exact duplicates: ties that must go to the lower index
    dst[1::7] = dst[0::7][: len(dst[1::7])]
    return (dst if excl else rng.normal(size=(n, 3)) * 4), dst, k, excl


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (5000, 5000, 20, True), (1000, 3001, 1, False), (333, 77, 32, False), (130, 130, 5, True),
    # k above 32: the row list, on both routes
    (3000, 3000, 33, True), (6000, 6000, 50, True), (2000, 5000, 100, False),
    # both sides of the dispatch's crossover
    (GRID_MIN_DST - 1, GRID_MIN_DST - 1, 20, True), (GRID_MIN_DST, GRID_MIN_DST, 20, True),
    (GRID_MIN_DST - 1, GRID_MIN_DST - 1, 1, False), (GRID_MIN_DST, GRID_MIN_DST, 1, False),
    (20000, 4 * GRID_MIN_DST, 20, False),
    *KNN_HAZARDS])
def test_knn_kernel_matches_plain_version(cuda_device, case):
    from fastliosam_tpu_torch.ops import kneighbors_cuda

    src_np, dst_np, k, exclude_self = _knn_case(case)
    d = torch.from_numpy(np.ascontiguousarray(dst_np)).to(cuda_device)
    s = d if src_np is dst_np else torch.from_numpy(np.ascontiguousarray(src_np)).to(cuda_device)
    before = kneighbors_cuda.launches
    k_d2, k_idx = kneighbors_cuda.knn(s, d, k, exclude_self)
    r_d2, r_idx = kneighbors_cuda.knn_ref(s, d, k, exclude_self)
    torch.cuda.synchronize()
    assert kneighbors_cuda.launches == before + 1
    assert torch.equal(k_d2.view(torch.int64), r_d2.view(torch.int64))
    assert torch.equal(k_idx, r_idx)
    # both routes, whichever the dispatch took, bit for bit
    for route in (kneighbors_cuda._knn_brute, kneighbors_cuda._knn_grid):
        g_d2, g_idx = route(s, d, k, exclude_self)[:2]
        torch.cuda.synchronize()
        assert torch.equal(g_d2.view(torch.int64), r_d2.view(torch.int64)), route.__name__
        assert torch.equal(g_idx, r_idx), route.__name__


@pytest.mark.cuda
def test_knn_grid_route_rescues_far_queries_and_syncs_nothing(cuda_device):
    from fastliosam_tpu_torch.ops import cluster_cuda, kneighbors_cuda
    from fastliosam_tpu_torch.postprocess.cleanup import voxelize

    street = torch.from_numpy(exp_knn.surface_cloud(3 * GRID_MIN_DST, 1)).to(cuda_device)
    far = street[:64] + 5000.0  # past every probe budget
    vox = voxelize(street, 0.5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k_d2, k_idx = kneighbors_cuda.knn(far, street, 20)
        stats = kneighbors_cuda._knn_grid(far, street, 20, False)[2]
        nb = cluster_cuda.voxel_edges(vox.sorted_pts, vox.keys, vox.offsets, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rescued = int(stats[0])
    r_d2, r_idx = kneighbors_cuda.knn_ref(far, street, 20)
    assert rescued > 0
    assert torch.equal(k_d2.view(torch.int64), r_d2.view(torch.int64))
    assert torch.equal(k_idx, r_idx)
    assert torch.equal(nb, cluster_cuda.voxel_edges_ref(vox.sorted_pts, vox.keys, vox.offsets,
                                                        0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("n,eps,apart", [(20000, 0.5, 0.0), (3000, 0.2, 0.0), (1, 0.5, 0.0),
                                          (20000, 2.0, 0.0), (6000, 0.5, 1.1e6)])
def test_voxel_edges_kernel_matches_plain_version(cuda_device, n, eps, apart):
    from fastliosam_tpu_torch.ops import cluster_cuda
    from fastliosam_tpu_torch.postprocess.cleanup import voxelize

    rng = np.random.default_rng(n)
    pts = rng.uniform(-5, 5, size=(n, 3))
    pts[::2, 0] += apart  # voxel keys over 2^21 apart
    pts = torch.from_numpy(pts).to(cuda_device)
    vox = voxelize(pts, eps)
    args = (vox.sorted_pts, vox.keys, vox.offsets, eps)
    before = cluster_cuda.launches
    got = cluster_cuda.voxel_edges(*args)
    want = cluster_cuda.voxel_edges_ref(*args)
    torch.cuda.synchronize()
    assert cluster_cuda.launches == before + 1
    assert torch.equal(got, want)
    if n > 1:  # (eps 2.0: ~160 points a voxel)
        assert 0 < int((got >= 0).sum()) < got.numel()


@pytest.mark.cuda
def test_postprocess_cleanup_on_the_card_equals_the_cpu(cuda_device):
    from fastliosam_tpu_torch.postprocess import denoise_slam_map, euclidean_clusters

    rng = np.random.default_rng(5)
    xyz = np.concatenate([rng.normal(size=(4000, 3)) * 2, rng.uniform(-40, 40, size=(200, 3))])
    for kw in ({}, {"cluster_eps": 0.5, "cluster_min_points": 10}):
        assert np.array_equal(denoise_slam_map(xyz, **kw),
                              denoise_slam_map(xyz, device="cpu", **kw))
    assert np.array_equal(euclidean_clusters(xyz, 0.7, 5), euclidean_clusters(xyz, 0.7, 5,
                                                                               device="cpu"))


# the measurement scripts (profile_step2, profile_step, profile_insert,
# bench_pgo_crossover) at small sizes: their stages launch the path's kernels
PROFILE_SMALL = ["--points", "4096", "--ds-points", "1024", "--map-log2", "14", "--reps", "2"]
PROFILE_KERNELS = {  # script: {stage: kernels it must launch}
    "profile_step2": {"step": ("merged_moments", "insert_claim"), "iekf": ("merged_moments",),
                      "query": ("merged_moments",), "probe": ("merged_moments",),
                      "insert": ("insert_claim",)},
    "profile_step": {"step": ("merged_moments", "insert_claim"),
                     "query_merged": ("merged_moments",), "iekf": ("merged_moments",),
                     "insert": ("insert_claim", "refresh_planes"),
                     "query_cached": ("query_cached",)},
    "profile_insert": {"insert": ("insert_claim",), "query": ("merged_moments",),
                       "find_slots": ("merged_moments",), "gather": ("gather_rows",),
                       "gather_int": ("gather_rows",)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("script", sorted(PROFILE_KERNELS))
def test_profile_script_stages_launch_their_kernels(cuda_device, script, tmp_path):
    import importlib
    import json

    from fastliosam_tpu_torch.ops import KERNEL_MODULES

    mod = importlib.import_module(f"fastliosam_tpu_torch.scripts.{script}")
    out = tmp_path / "stages.json"
    for m in KERNEL_MODULES:
        m.reset_launches()
    assert mod.main(PROFILE_SMALL + ["--out", str(out)]) == 0
    total = {m.KERNEL["name"]: m.launches for m in KERNEL_MODULES}
    recs = {r["stage"]: r for r in json.loads(out.read_text())}
    assert recs["baseline"]["device_ms"] > 0
    assert set(recs) == {"baseline", *mod.STAGES}
    for name in mod.STAGES:
        r = recs[name]
        assert r["finite"] and r["device"] == "cuda" and r["card"]
        assert r["device_ms"] > 0 and r["device_ops"] > 0 and r["host_ms"] > 0
    for name, kernels in PROFILE_KERNELS[script].items():
        for k in kernels:
            assert recs[name]["launches"].get(k, 0) > 0, (name, k)
    # the script's own counting leaves a caller's count whole: every stage's
    # counted run (R iterations) is inside the total
    for k in {k for ks in PROFILE_KERNELS[script].values() for k in ks}:
        assert total[k] >= sum(r["launches"].get(k, 0) * r["reps"]
                               for name, r in recs.items() if name != "baseline"), k


@pytest.mark.cuda
def test_pgo_crossover_runs_both_solvers(cuda_device, tmp_path):
    import json

    from fastliosam_tpu_torch.scripts import bench_pgo_crossover

    out = tmp_path / "crossover.json"
    assert bench_pgo_crossover.main(["--sizes", "64", "--reps", "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cuda" and rec["card"]
    (row,) = rec["rows"]
    for mode in ("dense", "pcg"):
        assert np.isfinite(row[f"{mode}_cost"]) and row[f"{mode}_cost"] <= row["start_cost"]
        assert row[f"{mode}_ms"] > 0 and row[f"{mode}_device_ops"] > 0
        assert row[f"{mode}_peak_gib"] > 0
    # PCG's solve is many more small launches than the dense factorization's
    assert row["pcg_device_ops"] > row["dense_device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("script", ["profile_step2", "profile_step", "profile_insert",
                                    "bench_pgo_crossover"])
def test_measurement_scripts_need_cuda_unless_told_cpu(cuda_device, script, monkeypatch):
    import importlib

    mod = importlib.import_module(f"fastliosam_tpu_torch.scripts.{script}")
    small = ["--sizes", "16", "--reps", "1"] if script == "bench_pgo_crossover" else (
        ["--points", "1024", "--ds-points", "256", "--map-log2", "12", "--reps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(small)
    assert mod.main(small + ["--device", "cpu"]) == 0


@pytest.mark.cuda
def test_device_events_count_what_key_averages_counts(cuda_device):
    """``utils/timing.device_events`` (the profiler's raw events) gives the
    device operations and device time that ``key_averages()`` gives."""
    from torch.profiler import ProfilerActivity, profile

    from fastliosam_tpu_torch.utils.timing import device_events

    x = torch.rand(4096, 64, device=cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            x = torch.sort(x * 1.0001 + 1e-6, dim=0).values.cumsum(0) / 4096
        torch.cuda.synchronize()
    events = device_events(prof)
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    assert sum(c for c, _ in events.values()) == sum(e.count for e in rows) > 40
    np.testing.assert_allclose(sum(ns for _, ns in events.values()) / 1e3,
                               sum(e.self_device_time_total for e in rows), rtol=1e-3)


@pytest.mark.cuda
def test_profile_pipeline_variants_repeat_bit_for_bit(cuda_device):
    """``profile_pipeline``'s four variants on the card, over the bench's
    figure-8 feed cut to 30 scans: every timed run equals its warm run bit
    for bit (trajectory, keyframes, loops, solves), and each variant runs
    the association and the insert kernels."""
    from fastliosam_tpu_torch.eval import feeds
    from fastliosam_tpu_torch.scripts import profile_pipeline

    ctx = profile_pipeline.setup(feeds.fig8_sequence(30), 5, cuda_device)
    out, runs = profile_pipeline.profile(ctx, reps=1)
    for variant, _ in profile_pipeline.VARIANTS:
        rec = out[variant]
        assert rec["replay_equal"], variant
        assert rec["launches"]["merged_moments"] > 0 and rec["launches"]["insert_claim"] > 0
        assert np.isfinite(runs[variant]["traj"]).all() and rec["scans_per_sec"] > 0
    assert out["no_kf"]["kf_loops_solves"][0] == 1 < out["full"]["kf_loops_solves"][0]


# ---------------------------------------------------------------------------
# the plane refresh (csrc/plane_fit.cu) and the point-to-plane normal
# equations (csrc/p2pl.cu): kernels against their plain versions
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import p2pl_cuda, plane_fit_cuda  # noqa: E402


def _refresh_tables(dev, seed, n, cap_log2=12, lanes=None):
    """A map with surfels, lines, single points and empty slots, and the
    slots of ``n`` points inserted into it (duplicates, drop rows where the
    table is full). Returns ``(args, cfg)``: the refresh's inputs."""
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda

    rng = np.random.default_rng(seed)
    cfg = vh.VoxelMapConfig(capacity=1 << cap_log2, voxel_size=0.5, insert_probes=2,
                            claim_probes=2, min_points=4)

    def cloud(k):
        u = rng.uniform(-8, 8, size=(k, 2))
        plane = np.c_[u, 0.2 * u[:, 0] - 1.0]  # a tilted floor
        line = np.c_[np.linspace(-8, 8, k // 4), np.full(k // 4, 3.1), np.full(k // 4, 2.2)]
        single = rng.uniform(-30, 30, size=(k // 8, 3))  # one point a voxel
        pts = np.concatenate([plane, line, single])
        pts[: k // 2] += rng.normal(size=(k // 2, 3)) * 0.01
        return torch.from_numpy(pts[:k].astype(np.float32)).to(dev)

    shape = (lanes,) if lanes else ()
    m = vh.make_map(cfg, dev, lanes=lanes)
    xyz = torch.stack([cloud(n) for _ in range(lanes)]) if lanes else cloud(n)
    mask = torch.ones(shape + (n,), dtype=torch.bool, device=dev)
    m, _ = vh.insert(m, cfg, xyz, mask, refresh_planes=True)  # old planes to keep
    xyz2 = (xyz + 0.07).contiguous()
    sl = insert_cuda.insert_claim_cuda(m.fp, m.coords, m.moments, xyz2, mask, cfg.voxel_size,
                                       2, cfg.max_points_per_voxel)[2]
    m2, _ = vh.insert(m, cfg, xyz2, mask, refresh_planes=False)
    return (m2.moments, m2.coords, sl, m.normal, m.d, m.plane_valid), cfg


def _refresh_both(args, cfg):
    tail = (cfg.voxel_size, cfg.min_points, cfg.plane_var_thresh)
    before = plane_fit_cuda.launches
    got = plane_fit_cuda.refresh_planes(*args, *tail)
    assert plane_fit_cuda.launches == before + 1
    want = plane_fit_cuda.refresh_planes_ref(*args, *tail)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap_log2", [(1, 12), (1000, 12), (4099, 12), (16384, 14),
                                         (20000, 10)])
def test_refresh_planes_kernel_matches_plain_version(cuda_device, n, cap_log2):
    """Ragged counts, duplicate slots, lines and single points (degenerate
    covariances), empty voxels, and a 2^10 table that drops points."""
    args, cfg = _refresh_tables(cuda_device, n + cap_log2, n, cap_log2)
    sl = args[2]
    if cap_log2 == 10:
        assert bool((sl == cfg.capacity).any())
    got, want = _refresh_both(args, cfg)
    rec = plane_fit_cuda.compare(got, want, *args[:3], cfg.voxel_size, cfg.plane_var_thresh)
    assert rec["ok"], rec
    again = plane_fit_cuda.refresh_planes_cuda(*args, cfg.voxel_size, cfg.min_points,
                                               cfg.plane_var_thresh)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(_bits(a) if a.is_floating_point() else a.cpu().numpy(),
                                      _bits(b) if b.is_floating_point() else b.cpu().numpy())
    for old, new in zip(args[3:], got):  # new tables: the old ones untouched
        assert new.data_ptr() != old.data_ptr()


@pytest.mark.cuda
def test_refresh_planes_kernel_drop_and_empty_slots(cuda_device):
    """Slots equal to C (the drop row) write nothing; a slot of an empty
    voxel (zero moments) gets the fit of zero moments, as the plain
    version's."""
    args, cfg = _refresh_tables(cuda_device, 5, 2000)
    cap = cfg.capacity
    empty = torch.nonzero(args[0][:, 0] == 0)[:8, 0]
    sl = torch.cat([torch.full((5,), cap, device=cuda_device), empty, args[2][:100]])
    got, want = _refresh_both((args[0], args[1], sl.contiguous(), *args[3:]), cfg)
    rec = plane_fit_cuda.compare(got, want, args[0], args[1], sl, cfg.voxel_size,
                                 cfg.plane_var_thresh)
    assert rec["ok"], rec
    assert not bool(got[2][empty].any())  # no points: never a valid plane
    only_drop = torch.full((7,), cap, device=cuda_device)
    got, _ = _refresh_both((args[0], args[1], only_drop, *args[3:]), cfg)
    for a, b in zip(got, args[3:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_refresh_planes_kernel_lanes(cuda_device):
    """Lane-major tables: one launch for 3 lanes, within tolerance of the
    plain version and lane by lane bit for bit with the unbatched kernel."""
    args, cfg = _refresh_tables(cuda_device, 9, 3000, lanes=3)
    got, want = _refresh_both(args, cfg)
    assert plane_fit_cuda.compare(got, want, *args[:3], cfg.voxel_size,
                                  cfg.plane_var_thresh)["ok"]
    for b in range(3):
        one = plane_fit_cuda.refresh_planes_cuda(*(t[b] for t in args), cfg.voxel_size,
                                                 cfg.min_points, cfg.plane_var_thresh)
        for a, o in zip(got, one):
            assert torch.equal(a[b], o)


@pytest.mark.cuda
def test_refresh_planes_kernel_rejects_bad_inputs(cuda_device):
    args, cfg = _refresh_tables(cuda_device, 3, 100)
    tail = (cfg.voxel_size, cfg.min_points, cfg.plane_var_thresh)
    moments, coords, sl, normal, d, pv = args
    with pytest.raises(ValueError):
        plane_fit_cuda.refresh_planes_cuda(moments, coords, sl.to(torch.int32), normal, d, pv,
                                           *tail)
    with pytest.raises(ValueError):
        plane_fit_cuda.refresh_planes_cuda(moments, coords, sl, normal.t(), d, pv, *tail)
    with pytest.raises(ValueError):
        plane_fit_cuda.refresh_planes_cuda(moments, coords.cpu(), sl, normal, d, pv, *tail)
    with pytest.raises(ValueError):
        plane_fit_cuda.refresh_planes_cuda(moments[:, :9].contiguous(), coords, sl, normal, d,
                                           pv, *tail)


def _p2pl_inputs(dev, seed, n, m):
    """Points near a few planes, their normals, ~5% invalid flags, a ragged
    source mask and the plain NN's neighbours of the shifted source."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-10, 10, size=(m, 2))
    k = m // 3
    dst = np.concatenate([np.c_[u[:k], np.zeros(k)], np.c_[u[k:2 * k, 0], np.full(k, 6.0),
                                                            u[k:2 * k, 1] * 0.2 + 2],
                          np.c_[np.full(m - 2 * k, 9.0), u[2 * k:]]]).astype(np.float32)
    nrm = np.concatenate([np.tile([0, 0, 1.0], (k, 1)), np.tile([0, 1.0, 0], (k, 1)),
                          np.tile([1.0, 0, 0], (m - 2 * k, 1))]).astype(np.float32)
    src = dst[rng.integers(0, m, size=n)] + np.array([0.2, -0.1, 0.05], np.float32)
    t = {name: torch.from_numpy(a).to(dev) for name, a in
         (("dst", dst), ("nrm", nrm), ("ps", src.astype(np.float32)))}
    nvalid = torch.from_numpy(rng.uniform(size=m) > 0.05).to(dev)
    mask = torch.from_numpy(rng.uniform(size=n) > 0.03).to(dev)
    idx, d2 = nn_cuda.nearest_neighbors_ref(t["ps"], t["dst"],
                                            torch.ones(m, dtype=torch.bool, device=dev))
    return t["ps"], idx, d2, mask, t["dst"], t["nrm"], nvalid


def _close(got, want):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= p2pl_cuda.TOLERANCE * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 7), (1000, 3001), (16384, 16384), (70000, 2000)])
@pytest.mark.parametrize("trim", [1.0, 0.8])
def test_p2pl_kernels_match_plain_version(cuda_device, n, m, trim):
    from fastliosam_tpu_torch.loop import icp

    s = _p2pl_inputs(cuda_device, n + m, n, m)
    max_d2 = 2.0
    thr = None
    before = p2pl_cuda.launches
    if trim < 1.0:
        ck, kk = p2pl_cuda.corr_keys(s[1], s[2], s[3], s[6], max_d2)
        cp, kp = p2pl_cuda.corr_keys_ref(s[1], s[2], s[3], s[6], max_d2)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp) and np.array_equal(_bits(kk), _bits(kp))
        thr = icp._trim_threshold(cp, kp, n, trim)
    got = p2pl_cuda.normal_eq(*s, max_d2, thr)
    assert p2pl_cuda.launches == before + (2 if trim < 1.0 else 1)
    want = p2pl_cuda.normal_eq_ref(*s, max_d2, thr)
    torch.cuda.synchronize()
    _close(got, want)
    again = p2pl_cuda.normal_eq_cuda(*s, max_d2, thr)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert torch.equal(got[0], got[0].T)


@pytest.mark.cuda
def test_p2pl_kernel_index_rule_and_empty(cuda_device):
    ps, idx, d2, mask, dst, nrm, nvalid = _p2pl_inputs(cuda_device, 4, 5000, 3000)
    m = dst.shape[0]
    odd = idx.clone()
    odd[::5] -= m
    odd[1::50] = m + 7
    fixed = idx.clone()
    fixed[1::50] = m - 1
    a = p2pl_cuda.normal_eq_cuda(ps, odd, d2, mask, dst, nrm, nvalid, 2.0)
    b = p2pl_cuda.normal_eq_cuda(ps, fixed, d2, mask, dst, nrm, nvalid, 2.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    G, bb = p2pl_cuda.normal_eq_cuda(ps, idx, d2, torch.zeros_like(mask), dst, nrm, nvalid, 2.0)
    assert not bool(G.any()) and not bool(bb.any())


@pytest.mark.cuda
def test_p2pl_kernel_rejects_bad_inputs(cuda_device):
    ps, idx, d2, mask, dst, nrm, nvalid = _p2pl_inputs(cuda_device, 5, 100, 50)
    with pytest.raises(ValueError):
        p2pl_cuda.normal_eq_cuda(ps, idx.long(), d2, mask, dst, nrm, nvalid, 2.0)
    with pytest.raises(ValueError):
        p2pl_cuda.normal_eq_cuda(ps, idx, d2, mask, dst, nrm, nvalid.int(), 2.0)
    with pytest.raises(ValueError):
        p2pl_cuda.normal_eq_cuda(ps.cpu(), idx, d2, mask, dst, nrm, nvalid, 2.0)
    with pytest.raises(ValueError):
        p2pl_cuda.corr_keys_cuda(idx, d2[:-1], mask, nvalid, 2.0)
    with pytest.raises(ValueError):
        p2pl_cuda.normal_eq_cuda(ps, idx, d2, mask, dst, nrm, nvalid, 2.0,
                                 torch.zeros(2, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("trim", [1.0, 0.8])
def test_icp_p2pl_on_the_kernels_matches_the_plain_versions(cuda_device, monkeypatch, trim):
    """``icp_align_p2pl`` on the card: the kernels' final pose within 1e-5
    m / rad of the run with the plain versions swapped in, and the run
    replayed bit for bit."""
    from fastliosam_tpu_torch.loop import icp

    ps, _, _, mask, dst, nrm, nvalid = _p2pl_inputs(cuda_device, 6, 8000, 8000)
    dmask = torch.ones(dst.shape[0], dtype=torch.bool, device=cuda_device)
    kw = dict(max_iterations=30, max_corr_dist=1.5, trim_fraction=trim)
    T1 = icp.icp_align_p2pl(ps, mask, dst, dmask, nrm, nvalid, **kw)[0]
    T2 = icp.icp_align_p2pl(ps, mask, dst, dmask, nrm, nvalid, **kw)[0]
    assert torch.equal(T1, T2)
    monkeypatch.setattr(p2pl_cuda, "normal_eq", p2pl_cuda.normal_eq_ref)
    monkeypatch.setattr(p2pl_cuda, "corr_keys", p2pl_cuda.corr_keys_ref)
    Tp = icp.icp_align_p2pl(ps, mask, dst, dmask, nrm, nvalid, **kw)[0]
    a, b = T1.double().cpu().numpy(), Tp.double().cpu().numpy()
    assert np.abs(a - b).max() <= 1e-5


# ---------------------------------------------------------------------------
# the cached-mode iEKF's rows: kernel and plain version bit for bit on every
# output (the rows, the match count, the association's slots)
# ---------------------------------------------------------------------------
from fastliosam_tpu_torch.ops import cached_rows_cuda  # noqa: E402

ROWS_TAIL = (0.5, 2, 0.001, 1.0, 1.0)  # voxel size, probes, point_cov, max_residual, ratio


def _words(t):
    return _bits(t) if t.dtype == torch.float32 else t.cpu().numpy()


def _rows_check(args, kw, tail=ROWS_TAIL):
    before = cached_rows_cuda.launches
    got = cached_rows_cuda.cached_rows(*args, *tail, **kw)
    torch.cuda.synchronize()
    assert cached_rows_cuda.launches == before + 1
    want = cached_rows_cuda.cached_rows_ref(*args, *tail, **kw)
    for name, g, w in zip(cached_rows_cuda.CachedRows._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_words(g), _words(w), err_msg=name)
    return got


@functools.lru_cache(maxsize=1)
def _figure8_planes(dev):
    """``_figure8_map`` with the next scan inserted and the planes of its
    voxels refreshed (the cached mode's map), built once a run."""
    vh, m, cfg, (xyz, hit) = _figure8_map(dev)
    m, _ = vh.insert(m, cfg, xyz, hit, refresh_planes=True)
    return vh, m, cfg, xyz, hit


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["probe", "carried", "flag_on", "flag_off", "extrinsic",
                                  "all_masked", "not_found", "tight"])
def test_cached_rows_kernel_matches_plain_version(cuda_device, case):
    """The figure-8 map with its planes refreshed; the next scan's points
    (ragged 8191 + 77 far points that find nothing, every 13th masked) in
    the body frame of a pose 2 cm and 3 mrad off: a probe, the association
    carried from a probe 0.3 m away, the device flag on and off, the
    extrinsic's columns (probing at the body points), every point masked,
    only points that find nothing, and a 2^9 table filled past capacity."""
    dev = cuda_device
    vh, m, cfg, xyz, hit = _figure8_planes(dev)
    far = torch.full((77, 3), 900.0, device=dev) + torch.arange(77, device=dev)[:, None]
    world = torch.cat([xyz[:8191], far])
    mask = torch.cat([hit[:8191], torch.ones(77, dtype=torch.bool, device=dev)])
    mask[::13] = False
    if case == "not_found":
        world, mask = far, torch.ones(77, dtype=torch.bool, device=dev)
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    if case == "tight":
        tcfg = vh.VoxelMapConfig(capacity=1 << 9, voxel_size=0.5, min_points=3)
        m, dropped = vh.insert(vh.make_map(tcfg, dev), tcfg, xyz, hit, refresh_planes=True)
        assert int(dropped) > 0
    R_true = torch.from_numpy(_rot([0.02, -0.01, 0.3])).to(dev)
    p_true = torch.tensor([1.0, -2.0, 0.5], device=dev)
    pts = ((world - p_true) @ R_true).contiguous()
    R = (R_true @ torch.from_numpy(_rot([0.003, 0.0, -0.002])).to(dev)).contiguous()
    p = p_true + torch.tensor([0.02, -0.01, 0.0], device=dev)
    kw = {}
    q_b = pts
    if case == "extrinsic":
        R_ext = torch.from_numpy(_rot([0.01, 0.02, -0.015])).to(dev)
        t_ext = torch.tensor([0.05, -0.02, 0.1], device=dev)
        p_l = ((pts - t_ext) @ R_ext).contiguous()
        q_b = (p_l @ R_ext.mT + t_ext).contiguous()
        kw = {"p_l": p_l, "R_ext": R_ext}
    table = (m.fp, m.normal, m.d, m.plane_valid)
    R0 = (R @ torch.from_numpy(_rot([0.0, 0.0, 0.02])).to(dev)).contiguous()
    p0 = p + torch.tensor([0.3, 0.0, 0.0], device=dev)
    first = _rows_check((R0, p0, q_b, mask, table, None, True),
                        dict(kw, q_query=pts if case == "extrinsic" else None))
    probe = {"carried": False, "flag_on": torch.tensor(True, device=dev),
             "flag_off": torch.tensor(False, device=dev)}.get(case, True)
    got = _rows_check((R, p, q_b, mask, table, first.slots, probe), kw)
    n_valid = int(got.n_matched)
    assert n_valid == int(got.valid.sum())
    if case in ("all_masked", "not_found"):
        assert n_valid == 0 and not bool((got.slots >= 0).any())
        assert torch.equal(got.n, m.normal[0].expand_as(got.n))  # slot 0's row
    else:
        assert n_valid > (0 if case == "tight" else 1000) and not bool(got.valid[-77:].any())
    again = cached_rows_cuda.cached_rows(R, p, q_b, mask, table, first.slots, probe, *ROWS_TAIL,
                                         **kw)
    for g, a in zip(got, again):  # the same words from launch to launch
        np.testing.assert_array_equal(_words(g), _words(a))


def _plane_lane_maps(lanes, cap=1 << 12, seed=3):
    """``lanes`` CPU-built maps with their planes fitted, stacked lane-major."""
    from fastliosam_tpu_torch.map import voxel_hash as vh

    cfg = vh.VoxelMapConfig(capacity=cap, voxel_size=0.5, min_points=3)
    rng = np.random.default_rng(seed)
    maps = []
    for b in range(lanes):
        pts = rng.uniform(-6, 6, size=(3000, 3)).astype(np.float32)
        pts[:1500, 2] = -1.0 + 0.05 * b  # a floor and a wall per lane
        pts[1500:, 0] = 4.0 - 0.1 * b
        m, _ = vh.insert(vh.make_map(cfg, "cpu"), cfg, torch.from_numpy(pts),
                         torch.ones(3000, dtype=torch.bool), refresh_planes=True)
        maps.append(m)
    return vh.VoxelMap(*(torch.stack(f) for f in zip(*maps)))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,ext", [(1, 3001, False), (3, 3001, False), (3, 3001, True),
                                         (8, 8192, False)])
def test_cached_rows_kernel_lanes(cuda_device, lanes, n, ext):
    """One launch for all lanes, a per-lane flag (every other lane probes):
    bit for bit against the lane-batched plain version and, lane by lane,
    against the unbatched kernel on that lane's table alone."""
    dev = cuda_device
    lm = _plane_lane_maps(lanes)
    m = type(lm)(*(t.to(dev) for t in lm))
    rng = np.random.default_rng(lanes + n)
    world = rng.uniform(-6, 6, size=(lanes, n, 3)).astype(np.float32)
    world[:, : n // 2, 2] = -1.0
    world[:, n // 2:, 0] = 4.0
    R = torch.from_numpy(np.stack([_rot([0.01 * b + 0.001, 0.002, 0.1]) for b in range(lanes)]))
    p = torch.from_numpy(rng.normal(size=(lanes, 3)).astype(np.float32) * 0.1)
    pts = torch.einsum("bnk,bkj->bnj", torch.from_numpy(world) - p[:, None], R).contiguous()
    R, p, pts = R.to(dev), (p + 0.01).to(dev), pts.to(dev)
    mask = torch.from_numpy(rng.uniform(size=(lanes, n)) > 0.1).to(dev)
    kw = {}
    if ext:
        R_ext = torch.stack([torch.from_numpy(_rot([0.01, 0.0, 0.02 * b + 0.01]))
                             for b in range(lanes)]).to(dev)
        kw = {"p_l": (pts @ R_ext).contiguous(), "R_ext": R_ext}
    table = (m.fp, m.normal, m.d, m.plane_valid)
    first = _rows_check((R, p + 0.3, pts, mask, table, None, True), kw)
    flag = (torch.arange(lanes, device=dev) % 2) == 0
    got = _rows_check((R, p, pts, mask, table, first.slots, flag), kw)
    assert got.n_matched.shape == (lanes,) and int(got.n_matched.min()) > 0
    for b in range(lanes):
        one_kw = {k: v[b] for k, v in kw.items()}
        one = cached_rows_cuda.cached_rows_cuda(
            R[b], p[b], pts[b], mask[b], tuple(t[b] for t in table), first.slots[b],
            bool(flag[b]), *ROWS_TAIL, **one_kw)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(_words(g[b]), _words(o))


@pytest.mark.cuda
def test_cached_rows_kernel_rejects_bad_inputs(cuda_device):
    from fastliosam_tpu_torch.map import voxel_hash as vh

    dev = cuda_device
    m = vh.make_map(vh.VoxelMapConfig(capacity=1 << 10), dev)
    R, p = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    q = torch.zeros((16, 3), device=dev)
    mask = torch.ones(16, dtype=torch.bool, device=dev)
    table = (m.fp, m.normal, m.d, m.plane_valid)
    slots = torch.zeros(16, dtype=torch.int32, device=dev)
    ok = (R, p, q, mask, table, slots, True)
    bad = [
        ((R.double(),) + ok[1:], {}),
        ((R.t(),) + ok[1:], {}),  # not contiguous
        (ok[:2] + (q[:, :2].contiguous(),) + ok[3:], {}),
        (ok[:3] + (mask[:8].contiguous(),) + ok[4:], {}),  # point count
        (ok[:4] + ((m.fp[:1000].contiguous(),) + table[1:],) + ok[5:], {}),  # capacity
        (ok[:4] + ((m.fp, m.normal, m.d, m.plane_valid.bool()),) + ok[5:], {}),
        (ok[:5] + (slots.long(),) + ok[6:], {}),
        (ok[:5] + (None, False), {}),  # no slots to carry
        (ok[:6] + (torch.ones(2, dtype=torch.bool, device=dev),), {}),  # flag per lane
        (ok[:6] + (1,), {}),
        (ok, {"p_l": q}),  # p_l without R_ext
        (ok, {"q_query": q.cpu()}),  # device
        ((R.cpu(),) + ok[1:], {}),
    ]
    for args, kw in bad:
        with pytest.raises(ValueError):
            cached_rows_cuda.cached_rows_cuda(*args, *ROWS_TAIL, **kw)
    for probes in (0, 9):
        with pytest.raises(ValueError):
            cached_rows_cuda.cached_rows_cuda(*ok, 0.5, probes, 0.001, 1.0, 1.0)
    cached_rows_cuda.cached_rows_cuda(*ok, *ROWS_TAIL)  # and the good call goes through


@pytest.mark.cuda
@pytest.mark.parametrize("gate_on_device", [False, True])
def test_cached_iekf_on_the_card_equals_its_composition(cuda_device, gate_on_device):
    """``iekf_update`` in the cached mode on the card: one ``cached_rows``
    launch an iteration, no ``query_cached`` launch and no host read, and
    the state and match count bit for bit with its run through the
    composition it replaced (the cached query and the rows in torch, the
    plain route of ``query_fn``)."""
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.odom import OdomConfig, iekf_update, init_state
    from fastliosam_tpu_torch.utils import host_reads

    dev = cuda_device
    _, m, mcfg, xyz, hit = _figure8_planes(dev)
    cfg = OdomConfig(query_mode="cached")
    R_true = torch.from_numpy(_rot([0.0, 0.0, 0.4])).to(dev)
    p_true = torch.tensor([1.0, -2.0, 0.5], device=dev)
    pts = ((xyz[:8192] - p_true) @ R_true).contiguous()
    mask = hit[:8192].contiguous()
    nav = init_state(cfg=cfg, device=dev)._replace(
        R=(R_true @ torch.from_numpy(_rot([0.004, -0.003, 0.002])).to(dev)).contiguous(),
        p=p_true + torch.tensor([0.15, -0.1, 0.05], device=dev))

    def old_route(vmap, map_cfg, pw, msk):
        n, d, valid = vh.query_planes(vmap, map_cfg, pw, msk)
        return n, d, valid, torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)

    r0, q0, c0 = host_reads(), query_cuda.launches, cached_rows_cuda.launches
    x, n_matched = iekf_update(nav, pts, mask, m, mcfg, cfg, gate_on_device=gate_on_device)
    torch.cuda.synchronize()
    assert host_reads() == r0 and query_cuda.launches == q0
    assert cached_rows_cuda.launches == c0 + cfg.max_iteration
    ox, on = iekf_update(nav, pts, mask, m, mcfg, cfg, gate_on_device=gate_on_device,
                         query_fn=old_route)
    for a, b in zip(x, ox):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(n_matched) == int(on) > 1000


# ---------------------------------------------------------------------------
# the Livox rollout's shapes (bench.py: bench_livox): 4096 downsampled points
# ---------------------------------------------------------------------------
def _livox_map(dev, n_scans=10, budget=4096):
    """The Livox feed's rosette (8192 rays, ``eval/feeds.py:
    build_livox_sequence``'s world and path) inserted for ``n_scans`` scans
    at their ground-truth poses into a 2^19-slot map (2 probes), and the
    next scan downsampled as the odometry downsamples it (0.5 m voxels, the
    first ``budget`` of the packed output) in the world frame."""
    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=7)
    traj = Trajectory.circle(radius=8.0, period=40.0, z_amp=0.3)
    sim = SimConfig(scan_rate=10.0, pattern="livox", livox_n_points=8192, max_range=120.0,
                    seed=7, time_groups=32)
    data = simulate_sequence(world, traj, sim, n_scans=n_scans + 1)
    cfg = vh.VoxelMapConfig(capacity=1 << 19, voxel_size=0.5, insert_probes=2,
                            claim_probes=2, query_probes=2)
    m = vh.make_map(cfg, dev)
    world_pts = []
    for (pts, _, hit), (R, p) in zip(data["scans"], data["gt"]):
        xyz = torch.from_numpy((pts @ R.T + p).astype(np.float32)).to(dev)
        world_pts.append((xyz, torch.from_numpy(hit).to(dev)))
    for xyz, hit in world_pts[:n_scans]:
        m, _ = vh.insert(m, cfg, xyz, hit, refresh_planes=False)
    ds = voxel_downsample(Cloud(*world_pts[n_scans]), 0.5)
    return vh, m, cfg, ds.xyz[:budget].contiguous(), ds.mask[:budget].contiguous()


@pytest.mark.cuda
def test_assoc_kernel_at_the_livox_shape(cuda_device):
    """``merged_moments`` at 4096 points x the merged stencil's 7 pools x 2
    probes: bit for bit with its plain version."""
    vh, m, cfg, xyz, mask = _livox_map(cuda_device)
    assert xyz.shape == (4096, 3)
    got = _assoc_check(vh, m, cfg, xyz, mask, "merged", 2)
    assert int((got[:, 0] > 0).sum()) > 0.5 * int(mask.sum())


@pytest.mark.cuda
def test_insert_kernel_at_the_livox_shape(cuda_device):
    """``insert_claim`` of 4096 points, 2 rounds, into the Livox map: bit for
    bit with its plain version (new voxels claimed, none dropped)."""
    vh, m, cfg, xyz, mask = _livox_map(cuda_device)
    got = _insert_check(cuda_device, m, xyz, mask, 2)
    assert int(got[4]) == 0 and int((got[0] != 0).sum()) > int((m.fp != 0).sum())
