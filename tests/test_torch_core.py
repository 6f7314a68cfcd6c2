"""Parity of the port's core geometry (so3, se3, eigh3, voxel downsample)
with the JAX package on the same numpy inputs.

Tolerances: atol 1e-5 on float32 geometry (a few ulps of O(1) values — the
two frameworks' sin/cos/acos and matmul round differently in the last
bits). The voxel downsample must agree exactly in order and mask: its
order decides which points survive the odometry point budget.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.core import eigh3 as j_eigh3  # noqa: E402
from fastliosam_tpu.core import pointcloud as j_pc  # noqa: E402
from fastliosam_tpu.core import se3 as j_se3  # noqa: E402
from fastliosam_tpu.core import so3 as j_so3  # noqa: E402
from fastliosam_tpu_torch.core import eigh3 as t_eigh3  # noqa: E402
from fastliosam_tpu_torch.core import pointcloud as t_pc  # noqa: E402
from fastliosam_tpu_torch.core import se3 as t_se3  # noqa: E402
from fastliosam_tpu_torch.core import so3 as t_so3  # noqa: E402

from _torch_parity import N, T, random_rotations  # noqa: E402

ATOL = 1e-5


def _rotvecs(rng):
    """Large angles (up to 0.9 pi, away from log's pi singularity) plus
    small ones that take the series branches."""
    big = random_rotations(rng, 64, scale=0.9)
    small = (rng.normal(size=(16, 3)) * 1e-5).astype(np.float32)
    return np.concatenate([big, small, np.zeros((1, 3), np.float32)])


@pytest.mark.parametrize(
    "name", ["hat", "exp", "left_jacobian", "left_jacobian_inv"]
)
def test_so3_vector_functions_match_jax(rng, name):
    w = _rotvecs(rng)
    ref = N(getattr(j_so3, name)(jnp.asarray(w)))
    out = N(getattr(t_so3, name)(T(w)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("name", ["log", "vee", "matrix_to_quat", "normalize_matrix"])
def test_so3_matrix_functions_match_jax(rng, name):
    R = np.asarray(j_so3.exp(jnp.asarray(_rotvecs(rng))))
    ref = N(getattr(j_so3, name)(jnp.asarray(R)))
    out = N(getattr(t_so3, name)(T(R)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_so3_quaternion_functions_match_jax(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32)
    p = rng.normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(
        N(t_so3.quat_to_matrix(T(q))), N(j_so3.quat_to_matrix(jnp.asarray(q))), atol=ATOL
    )
    np.testing.assert_allclose(
        N(t_so3.quat_mul(T(q), T(p))), N(j_so3.quat_mul(jnp.asarray(q), jnp.asarray(p))),
        atol=ATOL,
    )


def _poses(rng, n=32):
    xi = np.concatenate(
        [rng.normal(size=(n, 3)) * 3.0, random_rotations(rng, n, scale=0.9)], axis=1
    ).astype(np.float32)
    return np.asarray(j_se3.exp(jnp.asarray(xi)))


@pytest.mark.parametrize("name", ["inverse", "log", "adjoint", "rot", "trans"])
def test_se3_unary_match_jax(rng, name):
    Tm = _poses(rng)
    ref = N(getattr(j_se3, name)(jnp.asarray(Tm)))
    out = N(getattr(t_se3, name)(T(Tm)))
    # se3.log multiplies by J_l^{-1}, whose entries grow with |t| (up to
    # ~10 m here): allow a few ulps of the 10 m scale
    np.testing.assert_allclose(out, ref, atol=ATOL * (10 if name == "log" else 1))


@pytest.mark.parametrize("name", ["compose", "between", "local"])
def test_se3_binary_match_jax(rng, name):
    A, B = _poses(rng), _poses(rng)
    ref = N(getattr(j_se3, name)(jnp.asarray(A), jnp.asarray(B)))
    out = N(getattr(t_se3, name)(T(A), T(B)))
    np.testing.assert_allclose(out, ref, atol=ATOL * (10 if name == "local" else 1))


def test_se3_exp_make_apply_match_jax(rng):
    xi = np.concatenate(
        [rng.normal(size=(16, 3)), random_rotations(rng, 16)], axis=1
    ).astype(np.float32)
    np.testing.assert_allclose(
        N(t_se3.exp(T(xi))), N(j_se3.exp(jnp.asarray(xi))), atol=ATOL
    )
    Tm = _poses(rng, 4)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32) * 5
    for fn in ("apply", "apply_inverse"):
        ref = N(getattr(j_se3, fn)(jnp.asarray(Tm), jnp.asarray(pts)))
        out = N(getattr(t_se3, fn)(T(Tm), T(pts)))
        np.testing.assert_allclose(out, ref, atol=ATOL * 10)  # |p| ~ 10 m


def _sym(rng, n=256):
    """Random symmetric PSD 3x3s, incl. near-planar (surfel-like) ones."""
    B = rng.normal(size=(n, 3, 3)).astype(np.float32)
    A = B @ np.swapaxes(B, 1, 2)
    A[: n // 2, 2, :] *= 1e-2
    A[: n // 2, :, 2] *= 1e-2
    return A.astype(np.float32)


def test_eigvalsh3_matches_jax(rng):
    A = _sym(rng)
    np.testing.assert_allclose(
        N(t_eigh3.eigvalsh3(T(A))), N(j_eigh3.eigvalsh3(jnp.asarray(A))),
        atol=ATOL * 10, rtol=1e-5,  # eigenvalues up to ~20: rel. float32 rounding
    )


@pytest.mark.parametrize("name", ["eigh3", "smallest_eigvec3"])
def test_eigenvectors_match_jax_incl_sign(rng, name):
    A = _sym(rng)
    ref = getattr(j_eigh3, name)(jnp.asarray(A))
    out = getattr(t_eigh3, name)(T(A))
    # the vectors themselves — sign and choice included — must agree
    vec_ref, vec_out = (N(ref[1]), N(out[1])) if name == "eigh3" else (N(ref[0]), N(out[0]))
    np.testing.assert_allclose(vec_out, vec_ref, atol=1e-4)


def _scan_cloud(rng, n=2048, pad=200):
    xyz = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    xyz[: n // 2] = np.round(xyz[: n // 2] * 4) / 4  # many shared voxels
    mask = rng.uniform(size=n) > 0.1
    mask[-pad:] = False
    xyz[~mask] = 1e6
    return xyz, mask


@pytest.mark.parametrize("voxel", [0.3, 0.5, 1.0])
def test_voxel_downsample_order_mask_and_centroids(rng, voxel):
    xyz, mask = _scan_cloud(rng)
    # compiled, as the JAX package always runs it (XLA turns the division by
    # the voxel size into a multiply by its reciprocal; the port mirrors it)
    ref = jax.jit(j_pc.voxel_downsample, static_argnums=1)(
        j_pc.Cloud(jnp.asarray(xyz), jnp.asarray(mask)), voxel
    )
    out = t_pc.voxel_downsample(t_pc.Cloud(T(xyz), T(mask)), voxel)
    np.testing.assert_array_equal(N(out.mask), N(ref.mask))
    np.testing.assert_allclose(N(out.xyz), N(ref.xyz), atol=ATOL * 10)  # |p| ≤ 20 m
    np.testing.assert_array_equal(
        N(t_pc._pack_voxel_keys(T(xyz), T(mask), voxel)),
        N(jax.jit(j_pc._pack_voxel_keys, static_argnums=2)(
            jnp.asarray(xyz), jnp.asarray(mask), voxel)),
    )
