"""Point-to-point and point-to-plane ICP with brute-force nearest
neighbours (port of ``fastliosam_tpu/loop/icp.py``).

The nearest-neighbour search is the CUDA kernel on the card
(``ops/nn_cuda.py``) and its plain version on the CPU. The point-to-point
step is Horn's quaternion method with a shifted power iteration on the 4x4
N-matrix; the point-to-plane step solves a 6x6 Gauss-Newton system, and
its reads of the destination rows at the neighbours, the residuals and
the two products of the system are one kernel (``ops/p2pl_cuda.py``), two
with a trim. The JAX ``lax.while_loop`` becomes
a Python loop that reads the step size back each iteration (one counted
host sync per iteration).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import se3, so3
from ..ops import nn_cuda, p2pl_cuda
from ..ops.nn_cuda import nearest_neighbors_ref as nearest_neighbors  # noqa: F401
from ..utils.precision import geometry_precision
from ..utils.sync import host_read

_BIG = p2pl_cuda.BIG


def horn_moments(P, Q, w):
    """Sufficient statistics ``(Sw, Sp (3), Sq (3), Spq (3,3))`` of the
    weighted Horn problem."""
    Sw = torch.sum(w)
    Sp = torch.sum(P * w[:, None], dim=0)
    Sq = torch.sum(Q * w[:, None], dim=0)
    Spq = (P * w[:, None]).T @ Q
    return Sw, Sp, Sq, Spq


def horn_from_moments(Sw, Sp, Sq, Spq):
    """Solve Horn's absolute orientation from summed moments."""
    dev = Spq.device
    wsum = torch.clamp(Sw, min=1e-6)
    mu_p = Sp / wsum
    mu_q = Sq / wsum
    S = Spq - torch.outer(Sp, Sq) / wsum
    tr = torch.trace(S)
    A = S - S.T
    delta = torch.stack([A[1, 2], A[2, 0], A[0, 1]])
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    N = torch.cat(
        [
            torch.cat([tr[None], delta])[None, :],
            torch.cat([delta[:, None], S + S.T - tr * eye3], dim=1),
        ]
    )
    # shift so the max eigenvalue is dominant
    shift = torch.sum(torch.abs(N)) + 1e-3
    M = N + shift * torch.eye(4, dtype=torch.float32, device=dev)
    q = torch.eye(4, dtype=torch.float32, device=dev)[0]
    for _ in range(30):
        q = M @ q
        q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    R = so3.quat_to_matrix(q)
    t = mu_q - R @ mu_p
    return R, t


def _horn_quat(P, Q, w):
    """Weighted absolute orientation: R, t minimizing Σw‖R p + t − q‖²."""
    return horn_from_moments(*horn_moments(P, Q, w))


@geometry_precision()
def icp_align(
    src,
    src_mask,
    dst,
    dst_mask,
    init_T=None,
    max_iterations: int = 50,
    max_corr_dist: float = 52.5,
    nn_chunk: int = 2048,
    trim_fraction: float = 1.0,
    convergence_eps: float = 0.01,
):
    """Iterative closest point. Returns ``(T, fitness, n_corr)``: T maps
    src into dst's frame, fitness is the PCL-style mean squared
    correspondence distance. ``trim_fraction < 1`` trims to the best
    fraction of correspondences; ``convergence_eps > 0`` stops once the
    per-step update (rotation angle + translation norm) falls below it."""
    dev = src.device
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=dev)
    n = src.shape[0]
    dst = dst.contiguous()
    dst_mask = dst_mask.contiguous()
    max_d2 = max_corr_dist * max_corr_dist

    def nn(ps):
        return nn_cuda.nearest_neighbors(ps.contiguous(), dst, dst_mask, nn_chunk)

    def step(T):
        ps = se3.apply(T, src[None])[0]
        nn_idx, nn_d2 = nn(ps)
        corr = _trimmed(src_mask & (nn_d2 < max_d2), nn_d2, n, trim_fraction)
        R, t = _horn_quat(ps, dst[nn_idx.to(torch.int64)], corr.to(torch.float32))
        T_new = se3.compose(se3.make(R, t), T)
        delta = torch.linalg.vector_norm(so3.log(R)) + torch.linalg.vector_norm(t)
        return T_new, delta

    T = init_T
    if convergence_eps > 0.0:
        T = _iterate(step, T, max_iterations, convergence_eps)
    else:
        for _ in range(max_iterations):
            T, _ = step(T)
    return (T,) + _fitness(nn, src, src_mask, T, max_d2)


@geometry_precision()
def icp_align_p2pl(
    src,
    src_mask,
    dst,
    dst_mask,
    dst_normals,
    dst_nvalid,
    init_T=None,
    max_iterations: int = 50,
    max_corr_dist: float = 52.5,
    nn_chunk: int = 2048,
    trim_fraction: float = 1.0,
    convergence_eps: float = 0.01,
):
    """Point-to-plane ICP: minimizes Σ w (n·(T·p − q))² over SE(3) with the
    destination's per-point surfel normals ``dst_normals`` (valid where
    ``dst_nvalid``). Each iteration solves the 6x6 Gauss-Newton system of
    rows ``[(T·p)×n, n]`` with a 1e-6 ridge and stops once ``‖dx‖`` falls
    to ``convergence_eps``; the fitness stays the PCL-style mean squared
    point-to-point distance. Returns ``(T, fitness, n_corr)``."""
    dev = src.device
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=dev)
    n = src.shape[0]
    dst = dst.contiguous()
    dst_mask = dst_mask.contiguous()
    dst_normals = dst_normals.contiguous()
    nvalid = dst_nvalid.to(torch.bool).contiguous()
    src_mask = src_mask.contiguous()
    max_d2 = max_corr_dist * max_corr_dist
    ridge = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)

    def nn(ps):
        return nn_cuda.nearest_neighbors(ps.contiguous(), dst, dst_mask, nn_chunk)

    def step(T):
        ps = se3.apply(T, src[None])[0]
        nn_idx, nn_d2 = nn(ps)
        thr = None
        if trim_fraction < 1.0:
            corr, key = p2pl_cuda.corr_keys(nn_idx, nn_d2, src_mask, nvalid, max_d2)
            thr = _trim_threshold(corr, key, n, trim_fraction)
        G, b = p2pl_cuda.normal_eq(ps.contiguous(), nn_idx, nn_d2, src_mask, dst,
                                   dst_normals, nvalid, max_d2, thr)
        dx = torch.linalg.solve_ex(G + ridge, -b).result  # [dtheta, dt]
        T_new = se3.compose(se3.make(so3.exp(dx[:3]), dx[3:]), T)
        return T_new, torch.linalg.vector_norm(dx)

    T = _iterate(step, init_T, max_iterations, convergence_eps)
    return (T,) + _fitness(nn, src, src_mask, T, max_d2)


def _trim_threshold(corr, key, n: int, trim_fraction: float):
    """The 1-element distance threshold of the best ``trim_fraction`` of
    the correspondences ``corr``, from their sort keys ``key`` (the
    distances, ``_BIG`` where ``corr`` is false)."""
    d2s = torch.sort(key).values
    n_corr = torch.sum(corr.to(torch.int32))
    k = torch.clamp((n_corr.to(torch.float32) * trim_fraction).to(torch.int32), 1, n - 1)
    return d2s.gather(0, k.to(torch.int64).reshape(1))  # no 0-dim index: it syncs


def _trimmed(corr, nn_d2, n: int, trim_fraction: float):
    """``corr`` trimmed to the best ``trim_fraction`` of its distances
    (unchanged at 1)."""
    if trim_fraction >= 1.0:
        return corr
    key = torch.where(corr, nn_d2, _BIG)
    return corr & (nn_d2 <= _trim_threshold(corr, key, n, trim_fraction))


def _iterate(step, T, max_iterations: int, convergence_eps: float):
    """``T = step(T)`` while fewer than ``max_iterations`` ran and the last
    step size exceeds ``convergence_eps`` (the JAX ``lax.while_loop``; the
    step size is read back each iteration)."""
    eps = np.float32(convergence_eps)
    it, delta = 0, np.float32(np.inf)
    while it < max_iterations and delta > eps:
        T, d = step(T)
        it += 1
        delta = host_read(d)
    return T


def _fitness(nn, src, src_mask, T, max_d2):
    """``(fitness, n_corr)``: the PCL-style mean squared point-to-point
    distance of the correspondences within ``max_d2`` at ``T`` (inf with
    none)."""
    ps = se3.apply(T, src[None])[0]
    _, nn_d2 = nn(ps)
    corr = src_mask & (nn_d2 < max_d2)
    n_corr = torch.sum(corr.to(torch.int32))
    fitness = torch.sum(torch.where(corr, nn_d2, 0.0)) / torch.clamp(
        n_corr.to(torch.float32), min=1.0
    )
    return torch.where(n_corr > 0, fitness, torch.inf), n_corr
