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
two engines from one checkpoint equal bit for bit. The row gather and
take_along_axis are copies: equal bit for bit (NaN fill included). The
association's merged moments: equal bit for bit (the kernel rounds every
product and sum as the plain version does, in its order). The replay: two
runs equal bit for bit.
"""
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
    pools_fn = vh.merged_pools if mode == "merged" else vh.merged3_pools
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
@pytest.mark.parametrize("mode", ["merged", "merged3"])
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
    for mode in ("merged3", "merged"):
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
