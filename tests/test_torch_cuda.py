"""Tests that need an NVIDIA GPU: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the bitwise replay of the
scatter-adds that make the card path deterministic. They skip without CUDA.

This file imports neither JAX nor the JAX package, and uses no fixture of
``conftest.py``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: nearest neighbours, d2 rtol 1e-5 / atol 1e-4 (the expansion of
O(10) m² values in float32, with the card's and the CPU's summation
orders), indices equal except at ties, where the two candidates' distances
agree within 1e-5. The row gather and take_along_axis are copies: equal bit
for bit (NaN fill included). The replay: two runs equal bit for bit.
"""
import numpy as np
import pytest
import torch

from fastliosam_tpu_torch.ops import nn_cuda

SIZES = [(300, 2500), (1000, 3001), (17, 5), (256, 2048), (16384, 16384)]


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
def test_nn_kernel_rejects_bad_inputs(cuda_device):
    src = torch.zeros((8, 3), device=cuda_device)
    dst = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(src, dst, torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(src.double(), dst, torch.ones(8, dtype=torch.bool,
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
