"""Closed-form eigendecomposition of batched symmetric 3x3 matrices (port of
``fastliosam_tpu/core/eigh3.py``).

The closed form itself, not ``torch.linalg.eigh``: the sign and the choice
of each eigenvector feed the plane normals and the iEKF degeneracy
projector, so they must match the JAX package's. Eigenvalues come from the
trigonometric solution of the characteristic cubic, eigenvectors from the
largest column of ``(A - o1 I)(A - o2 I)``.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def eigvalsh3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending: (..., 3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = 0.5 * (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    half_det = torch.clamp(half_det, -1.0, 1.0)
    phi = torch.acos(half_det) / 3.0
    two_pi_3 = 2.0943951023931953
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lam1 = 3.0 * q - lam0 - lam2
    return torch.stack([lam0, lam1, lam2], dim=-1)


def _eigvec(A, lam, other1, other2):
    """Eigenvector of ``lam`` as the largest column of (A-o1 I)(A-o2 I)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - other1[..., None, None] * eye) @ (A - other2[..., None, None] * eye)
    norms = torch.sum(M * M, dim=-2)  # column norms (..., 3)
    k = torch.argmax(norms, dim=-1)
    col = torch.gather(M, -1, k[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    n = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    # repeated eigenvalues: fall back to e_x (callers gate on planarity);
    # a fill, not ``fallback[..., 0] = 1.0``, which on an unbatched (3,)
    # copies a 0-dim value through the host and so syncs the stream
    fallback = torch.zeros_like(col)
    fallback.narrow(-1, 0, 1).fill_(1.0)
    safe = n[..., 0] > 1e-20
    return torch.where(safe[..., None], col / torch.clamp(n, min=_EPS), fallback)


def eigh3(A):
    """Full decomposition of symmetric (..., 3, 3): ``(eigvals ascending,
    eigvecs)`` with ``eigvecs[..., :, i]`` the unit eigenvector of
    ``eigvals[..., i]``."""
    lam = eigvalsh3(A)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    v0 = _eigvec(A, l0, l1, l2)
    v2 = _eigvec(A, l2, l0, l1)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    v1 = v1 / torch.clamp(n1, min=_EPS)
    V = torch.stack([v0, v1, v2], dim=-1)
    return lam, V


def smallest_eigvec3(A):
    """``(normal (..., 3), eigvals (..., 3))``: unit eigenvector of the
    smallest eigenvalue plus all three eigenvalues."""
    lam = eigvalsh3(A)
    v0 = _eigvec(A, lam[..., 0], lam[..., 1], lam[..., 2])
    return v0, lam
