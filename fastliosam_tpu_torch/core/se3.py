"""Batched SE(3) operations on (R, t) pairs and 4x4 matrices (port of
``fastliosam_tpu/core/se3.py``). Tangent vectors are ``(..., 6)`` ordered
``[rho(3), theta(3)]``."""
from __future__ import annotations

import torch

from . import so3


def make(R, t):
    """(R, t) -> 4x4 homogeneous matrix."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rot(T):
    return T[..., :3, :3]


def trans(T):
    return T[..., :3, 3]


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(A, B):
    """A @ B for 4x4 pose matrices (matmul, broadcasting)."""
    return A @ B


def between(A, B):
    """Relative pose A^{-1} B (GTSAM ``Pose3::between`` semantics)."""
    return compose(inverse(A), B)


def apply(T, pts):
    """Transform points: T (..., 4, 4), pts (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def apply_inverse(T, pts):
    """Inverse-transform points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ji,...nj->...ni", R, pts - t[..., None, :])


def exp(xi):
    """SE(3) exponential. xi (..., 6) = [rho, theta] -> T (..., 4, 4)."""
    rho, theta = xi[..., :3], xi[..., 3:]
    R = so3.exp(theta)
    J = so3.left_jacobian(theta)
    t = torch.einsum("...ij,...j->...i", J, rho)
    return make(R, t)


def log(T):
    """SE(3) logarithm. T (..., 4, 4) -> xi (..., 6) = [rho, theta]."""
    theta = so3.log(T[..., :3, :3])
    Jinv = so3.left_jacobian_inv(theta)
    rho = torch.einsum("...ij,...j->...i", Jinv, T[..., :3, 3])
    return torch.cat([rho, theta], dim=-1)


def retract(T, xi):
    """Right-retract: T * Exp(xi) — the PGO solver's local update."""
    return compose(T, exp(xi))


def local(A, B):
    """Local coordinates of B in the tangent at A: Log(A^{-1} B)."""
    return log(between(A, B))


def adjoint(T):
    """Adjoint of T (..., 4, 4) -> (..., 6, 6), tangent order [rho, theta]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Ad = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    Ad[..., :3, :3] = R
    Ad[..., :3, 3:] = so3.hat(t) @ R
    Ad[..., 3:, 3:] = R
    return Ad


def from_quat_trans(q, t):
    """Quaternion [w,x,y,z] + translation -> 4x4 matrix."""
    return make(so3.quat_to_matrix(q), t)


def to_quat_trans(T):
    return so3.matrix_to_quat(T[..., :3, :3]), T[..., :3, 3]
