"""The nearest-neighbour kernel's plain version against the JAX package's
Pallas kernel (interpret mode, as ``tests/test_pallas_nn.py`` runs it) and
its XLA path. The CUDA kernel itself is held against the plain version on
a card by ``tests/test_torch_cuda.py``.

Tolerances: indices exact (random inputs have no near-ties), d2 atol 1e-4
(the ‖d‖²+‖s‖²−2d·s expansion of O(10) m² values in float32).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.loop.icp import nearest_neighbors as jax_nn  # noqa: E402
from fastliosam_tpu.ops import nearest_neighbors_pallas  # noqa: E402
from fastliosam_tpu_torch.ops import nn_cuda  # noqa: E402

from _torch_parity import N, T  # noqa: E402

SIZES = [(300, 2500), (1000, 3001), (17, 5), (256, 2048)]


def _inputs(rng, n, m, masked_frac=0.1):
    src = rng.normal(size=(n, 3)).astype(np.float32) * 3
    dst = (rng.normal(size=(m, 3)) * 4).astype(np.float32)
    mask = rng.uniform(size=m) > masked_frac
    return src, dst, mask


@pytest.mark.parametrize("n,m", SIZES)
def test_plain_matches_pallas_interpret(rng, n, m):
    src, dst, mask = _inputs(rng, n, m)
    j_idx, j_d2 = nearest_neighbors_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), interpret=True
    )
    t_idx, t_d2 = nn_cuda.nearest_neighbors_ref(T(src), T(dst), T(mask))
    np.testing.assert_array_equal(N(t_idx), N(j_idx))
    np.testing.assert_allclose(N(t_d2), N(j_d2), atol=1e-4)
    assert t_idx.dtype == torch.int32 and t_d2.dtype == torch.float32


@pytest.mark.parametrize("chunk", [512, 2048])
def test_plain_matches_xla_path(rng, chunk):
    src, dst, mask = _inputs(rng, 400, 3001)
    j_idx, j_d2 = jax_nn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), chunk)
    t_idx, t_d2 = nn_cuda.nearest_neighbors_ref(T(src), T(dst), T(mask), chunk)
    np.testing.assert_array_equal(N(t_idx), N(j_idx))
    np.testing.assert_allclose(N(t_d2), N(j_d2), atol=1e-4)


def test_all_masked_gives_big_and_index_zero(rng):
    src, dst, _ = _inputs(rng, 64, 256)
    mask = np.zeros(256, bool)
    j_idx, j_d2 = nearest_neighbors_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), interpret=True
    )
    t_idx, t_d2 = nn_cuda.nearest_neighbors_ref(T(src), T(dst), T(mask))
    assert np.all(N(t_d2) > 1e10)
    np.testing.assert_array_equal(N(t_idx), 0)
    np.testing.assert_array_equal(N(t_idx), N(j_idx))
    np.testing.assert_allclose(N(t_d2), N(j_d2))


def test_dispatch_runs_plain_version_on_cpu_and_kernel_refuses_cpu(rng):
    src, dst, mask = _inputs(rng, 50, 70)
    before = nn_cuda.launches
    idx, d2 = nn_cuda.nearest_neighbors(T(src), T(dst), T(mask))
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(T(src), T(dst), T(mask))
    np.testing.assert_array_equal(N(idx), N(r_idx))
    np.testing.assert_array_equal(N(d2), N(r_d2))
    assert nn_cuda.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        nn_cuda.nearest_neighbors_cuda(T(src), T(dst), T(mask))


# ---------------------------------------------------------------------------
# the CUDA kernel's slice-merge rule (csrc/nn.cu): destinations split into
# slices, each slice's unclamped (d2, idx) from the plain version, merged
# lexicographically and then clamped, must give exactly the whole call
# ---------------------------------------------------------------------------
def _merge_slices(src, dst, mask, bounds):
    best_d = torch.full((src.shape[0],), 1.0e12)
    best_i = torch.zeros((src.shape[0],), dtype=torch.int32)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        idx, d2 = nn_cuda._nearest_raw(src, dst[lo:hi], mask[lo:hi])
        idx = idx + lo
        better = (d2 < best_d) | ((d2 == best_d) & (idx < best_i))
        best_d = torch.where(better, d2, best_d)
        best_i = torch.where(better, idx, best_i)
    return best_i, torch.clamp(best_d, min=0.0)


@pytest.mark.parametrize("case", ["boundary_tie", "masked_slice", "all_masked", "ragged"])
def test_slice_merge_equals_whole_call(rng, case):
    n, m, bounds = {"boundary_tie": (300, 2048, [0, 512, 1024, 1536, 2048]),
                    "masked_slice": (257, 1500, [0, 512, 1024, 1500]),
                    "all_masked": (64, 700, [0, 256, 700]),
                    "ragged": (17, 1001, [0, 333, 334, 900, 1001])}[case]
    src, dst, mask = _inputs(rng, n, m)
    if case == "boundary_tie":
        # one point duplicated exactly on both sides of the 1024 boundary,
        # and sources sitting on it (d2 of the expansion may round below 0)
        b = bounds[2]
        dst[b - 3] = dst[b + 5] = np.float32([0.3, -0.7, 1.1])
        mask[[b - 3, b + 5]] = True
        src[:20] = dst[b - 3] + rng.normal(size=(20, 3)).astype(np.float32) * 1e-3
        src[20] = dst[b - 3]
    elif case == "masked_slice":
        mask[bounds[1]:bounds[2]] = False
    elif case == "all_masked":
        mask[:] = False
    s, d, k = T(src), T(dst), T(mask)
    want_i, want_d = nn_cuda.nearest_neighbors_ref(s, d, k)
    got_i, got_d = _merge_slices(s, d, k, bounds)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    if case == "boundary_tie":
        assert torch.all(want_i[:21] == bounds[2] - 3)  # the lower index wins
    if case == "all_masked":
        assert torch.all(want_i == 0) and torch.all(want_d == 1.0e12)
