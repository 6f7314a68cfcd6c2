"""Batched point-to-point ICP with brute-force nearest neighbours (port of
``fastliosam_tpu/loop/icp.py``).

The nearest-neighbour search is the CUDA kernel on the card
(``ops/nn_cuda.py``) and its plain version on the CPU. The alignment step
is Horn's quaternion method with a shifted power iteration on the 4x4
N-matrix. The JAX ``lax.while_loop`` becomes a Python loop that reads the
step size back each iteration (one counted host sync per iteration).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import se3, so3
from ..ops import nn_cuda
from ..ops.nn_cuda import nearest_neighbors_ref as nearest_neighbors  # noqa: F401
from ..utils.precision import geometry_precision
from ..utils.sync import host_read

_BIG = 1.0e12


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

    def corr_weights(nn_d2):
        corr = src_mask & (nn_d2 < max_d2)
        if trim_fraction < 1.0:
            d2s = torch.sort(torch.where(corr, nn_d2, _BIG)).values
            n_corr = torch.sum(corr.to(torch.int32))
            k = torch.clamp(
                (n_corr.to(torch.float32) * trim_fraction).to(torch.int32), 1, n - 1
            )
            thr = d2s.gather(0, k.to(torch.int64).reshape(1))  # no 0-dim index: it syncs
            corr = corr & (nn_d2 <= thr)
        return corr

    def step(T):
        ps = se3.apply(T, src[None])[0]
        nn_idx, nn_d2 = nn(ps)
        w = corr_weights(nn_d2).to(torch.float32)
        R, t = _horn_quat(ps, dst[nn_idx.to(torch.int64)], w)
        T_new = se3.compose(se3.make(R, t), T)
        delta = torch.linalg.vector_norm(so3.log(R)) + torch.linalg.vector_norm(t)
        return T_new, delta

    T = init_T
    if convergence_eps > 0.0:
        eps = np.float32(convergence_eps)
        it, delta = 0, np.float32(np.inf)
        while it < max_iterations and delta > eps:
            T, d = step(T)
            it += 1
            delta = host_read(d)
    else:
        for _ in range(max_iterations):
            T, _ = step(T)

    ps = se3.apply(T, src[None])[0]
    _, nn_d2 = nn(ps)
    corr = src_mask & (nn_d2 < max_d2)
    n_corr = torch.sum(corr.to(torch.int32))
    fitness = torch.sum(torch.where(corr, nn_d2, 0.0)) / torch.clamp(
        n_corr.to(torch.float32), min=1.0
    )
    fitness = torch.where(n_corr > 0, fitness, torch.inf)
    return T, fitness, n_corr
