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
the lower index, and two launches agree bit for bit. The row gather and
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
