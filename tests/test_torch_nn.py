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
