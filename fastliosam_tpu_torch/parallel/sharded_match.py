"""Point-axis sharding for scan matching (port of
``fastliosam_tpu/parallel/sharded_match.py``).

For huge scans (HDL-64, ~130k points) the residual / Jacobian / Gram work
of the iEKF update shards along the point axis: each rank holds a point
block, reduces its ``(N_local, 6)`` Jacobian to the 6x6 Gram and the rhs,
and one collective combines them: 42 floats and the valid count, whatever
the scan's size.
"""
from __future__ import annotations

import torch

from .mesh import Mesh


def sharded_gram(A, w, r, mesh: Mesh, axis: str = "pt"):
    """This rank's rows ``A (n, k)``, weights ``w (n,)`` and residuals
    ``r (n,)`` -> the whole mesh's ``(G (k, k), b (k,), n_valid)``, the
    same on every rank. ``G``, ``b`` and the count travel in one buffer,
    one ``all_reduce`` (the count as float32: exact below 2^24)."""
    k = A.shape[1]
    Aw = A * w[:, None]
    G = A.T @ Aw
    b = Aw.T @ r
    n = torch.sum((w > 0).to(torch.float32))
    tot = mesh.psum(torch.cat([G.reshape(-1), b, n[None]]))
    return tot[: k * k].reshape(k, k), tot[k * k: k * k + k], tot[-1].to(torch.int32)
