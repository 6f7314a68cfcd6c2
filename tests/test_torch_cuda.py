"""Tests that need an NVIDIA GPU: each hand-written CUDA kernel against its
plain PyTorch version on the card. They skip without CUDA.

This file imports neither JAX nor the JAX package, and uses no fixture of
``conftest.py``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: d2 rtol 1e-5 / atol 1e-4 (the expansion of O(10) m² values in
float32, with the card's and the CPU's summation orders); indices equal
except at ties, where the two candidates' distances agree within 1e-5.
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
