"""Batched SO(3) operations (port of ``fastliosam_tpu/core/so3.py``).

All functions broadcast over leading batch dimensions and have no
data-dependent control flow: small-angle series are blended in with
``torch.where``.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        *batch_shape, 3, 3
    )


def hat(w):
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp(w):
    """Rotation vector (..., 3) -> matrix (..., 3, 3); Rodrigues with a
    series fallback near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(
        theta2 > _EPS,
        (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    W = hat(w)
    W2 = W @ W
    return _eye3(w, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * W2


def log(R):
    """Matrix (..., 3, 3) -> rotation vector (..., 3) via the quaternion
    route (Shepperd extraction + atan2 angle), branch-free."""
    q = matrix_to_quat(R)
    qw = q[..., 0]
    v = q[..., 1:]
    nv = torch.linalg.vector_norm(v, dim=-1)
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qw = qw * sign
    v = v * sign[..., None]
    theta = 2.0 * torch.atan2(nv, qw)
    scale = torch.where(
        nv > 1e-7, theta / (nv + _EPS), 2.0 / torch.clamp(qw, min=_EPS)
    )
    return v * scale[..., None]


def left_jacobian(w):
    """SO(3) left Jacobian J_l(w): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.where(
        theta2 > _EPS,
        (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    b = torch.where(
        theta2 > _EPS,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    return _eye3(w, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * W2


def left_jacobian_inv(w):
    """Inverse SO(3) left Jacobian: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    half_theta = 0.5 * theta
    cot_term = torch.where(
        theta2 > _EPS,
        (1.0 - half_theta * torch.cos(half_theta) / (torch.sin(half_theta) + _EPS))
        / (theta2 + _EPS * _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    return _eye3(w, W.shape[:-2]) - 0.5 * W + cot_term[..., None, None] * W2


def quat_to_matrix(q):
    """Quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) [w, x, y, z];
    branch-free Shepperd: all four candidates, the best picked by where."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack(
        [0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1
    )
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack(
        [(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1
    )
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack(
        [(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1
    )
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack(
        [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1
    )
    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def quat_mul(a, b):
    """Hamilton product of quaternions (..., 4) [w, x, y, z]."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def normalize_matrix(R):
    """Re-orthonormalize a near-rotation with one Newton step (no SVD)."""
    RtR = R.transpose(-1, -2) @ R
    return R @ (1.5 * _eye3(R, R.shape[:-2]) - 0.5 * RtR)
