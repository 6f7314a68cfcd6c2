"""Plain geometry of the reference odometry: SO(3), the closed-form 3x3
eigensolver, the voxel keys of the hash map and fixed-order scatter-adds.

A frozen copy of the plain PyTorch of the program's ``core/so3.py``,
``core/eigh3.py``, ``core/voxel.py`` and ``core/segment.py`` at the
benchmark's first version, cut to one lane: the benchmark's answers are
judged against it, so it does not move when the program does. It imports
nothing of the program.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(like, batch_shape):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*batch_shape, 3, 3)


def hat(w):
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def so3_exp(w):
    """Rotation vector (..., 3) -> matrix; Rodrigues, a series near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS),
                    0.5 - theta2 / 24.0)
    W = hat(w)
    return _eye3(w, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _matrix_to_quat(R):
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)))
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def so3_log(R):
    """Matrix (..., 3, 3) -> rotation vector (..., 3), through the quaternion."""
    q = _matrix_to_quat(R)
    qw, v = q[..., 0], q[..., 1:]
    nv = torch.linalg.vector_norm(v, dim=-1)
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qw = qw * sign
    v = v * sign[..., None]
    theta = 2.0 * torch.atan2(nv, qw)
    scale = torch.where(nv > 1e-7, theta / (nv + _EPS), 2.0 / torch.clamp(qw, min=_EPS))
    return v * scale[..., None]


def normalize_matrix(R):
    """Re-orthonormalize a near-rotation with one Newton step."""
    return R @ (1.5 * _eye3(R, R.shape[:-2]) - 0.5 * (R.transpose(-1, -2) @ R))


# --- symmetric 3x3 eigenproblems (closed form) ---------------------------
_EIG_EPS = 1e-12


def eigvalsh3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EIG_EPS))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = 0.5 * (c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02)
                      + c02 * (c01 * c12 - c11 * c02))
    phi = torch.acos(torch.clamp(half_det, -1.0, 1.0)) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    return torch.stack([lam0, 3.0 * q - lam0 - lam2, lam2], dim=-1)


def _eigvec(A, other1, other2):
    """Eigenvector as the largest column of (A - o1 I)(A - o2 I); e_x where
    the eigenvalue is repeated."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - other1[..., None, None] * eye) @ (A - other2[..., None, None] * eye)
    k = torch.argmax(torch.sum(M * M, dim=-2), dim=-1)
    col = torch.gather(M, -1, k[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    n = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    fallback = torch.zeros_like(col)
    fallback.narrow(-1, 0, 1).fill_(1.0)
    return torch.where((n[..., 0] > 1e-20)[..., None], col / torch.clamp(n, min=_EIG_EPS),
                       fallback)


def eigh3(A):
    """``(eigvals ascending, eigvecs)``, ``eigvecs[..., :, i]`` of ``eigvals[..., i]``."""
    lam = eigvalsh3(A)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    v0 = _eigvec(A, l1, l2)
    v2 = _eigvec(A, l0, l1)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True), min=_EIG_EPS)
    return lam, torch.stack([v0, v1, v2], dim=-1)


def smallest_eigvec3(A):
    """``(unit eigenvector of the smallest eigenvalue, eigvals)``."""
    lam = eigvalsh3(A)
    return _eigvec(A, lam[..., 1], lam[..., 2]), lam


# --- voxel keys: uint32 arithmetic emulated in int64 ---------------------
P1, P2, P3 = 73856093, 19349669, 83492791  # slot hash
Q1, Q2, Q3 = 2654435761, 805459861, 3674653429  # fingerprint hash
_MASK32 = 0xFFFFFFFF


def voxel_coords(xyz, voxel_size):
    """int32 voxel coordinates (the point times the float32 reciprocal)."""
    return torch.floor(xyz * (1.0 / voxel_size)).to(torch.int32)


def voxel_center(coords, voxel_size):
    return (coords.to(torch.float32) + 0.5) * voxel_size


def _mul32(a, k: int):
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def hash_slot(coords, capacity):
    """First probe slot (int32) of int32 voxel coords (..., 3)."""
    c = coords.to(torch.int64) & _MASK32
    h = (_mul32(c[..., 0], P1) + _mul32(c[..., 1], P2) + _mul32(c[..., 2], P3)) & _MASK32
    return (_mix32(h) & (capacity - 1)).to(torch.int32)


def fingerprint(coords):
    """Odd int32 identity word of a voxel (0 marks an empty slot)."""
    c = coords.to(torch.int64) & _MASK32
    h = (_mul32(c[..., 0], Q1) + _mul32(c[..., 1], Q2) + _mul32(c[..., 2], Q3)) & _MASK32
    h = _mix32(h) | 1
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


# --- scatter-adds in a fixed order ----------------------------------------
_DEAD_KEY = 1 << 62


def index_add_(table, index, values, dead=None):
    """In place ``table[i] += Σ values[k]`` over ``index[k] == i``, each row
    summed in index order (the same bits on the card as on the CPU);
    elements where ``dead`` holds are summed alone (they point at a row
    that is never read)."""
    index = index.to(torch.int64).reshape(-1)
    n = index.shape[0]
    if n == 0:
        return table
    dev = index.device
    ar = torch.arange(n, device=dev)
    key = index if dead is None else torch.where(dead.reshape(-1), _DEAD_KEY + ar, index)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = skey[1:] != skey[:-1]
    run = torch.cumsum(is_start.to(torch.int64), 0) - 1
    elem_pos = ar + run + 1
    head_pos = torch.where(is_start, ar + run, 2 * n)
    lengths = torch.zeros((n + 1,), dtype=torch.int64, device=dev).index_add_(
        0, run, torch.ones_like(run)) + 1
    sidx = index[order]
    data = torch.empty((2 * n + 1,) + tuple(table.shape[1:]), dtype=table.dtype, device=dev)
    data[elem_pos] = values[order].to(table.dtype)
    data[head_pos] = table[sidx]
    sums = torch.segment_reduce(data, "sum", lengths=lengths, unsafe=True)
    table[sidx] = sums[run]
    return table


def scatter_add(index, values, size: int, dead=None):
    """``zeros((size, ...)).index_add_(0, index, values)`` in the fixed order."""
    table = torch.zeros((size,) + tuple(values.shape[1:]), dtype=values.dtype,
                        device=values.device)
    return index_add_(table, index, values, dead)
