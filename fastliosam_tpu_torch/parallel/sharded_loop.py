"""Keyframe- and point-axis sharding for loop closure (port of
``fastliosam_tpu/parallel/sharded_loop.py``).

* :func:`detect_sharded`: keyframe positions and stamps sharded along
  ``kf``; each rank searches its block and the ``(min distance, index)``
  pairs meet in one packed all-gather. The same answer as the replicated
  :func:`fastliosam_tpu_torch.loop.detect.fetch_closest_keyframe_idx`.
* :func:`gather_submap_sharded`: the keyframe clouds live sharded along
  ``kf`` (each rank stores K/n clouds); the ±n_sub window around a centre
  keyframe is put together with one ``psum`` of a ``(span, P, 3)`` buffer.
* :func:`icp_align_sharded`: the submap ICP shards the source points:
  each rank matches its block against the whole destination through the
  CUDA nearest-neighbour kernel (``ops/nn_cuda.py``, ``csrc/nn.cu``) and
  one ``psum`` of the 16 Horn moments a step combines them.

A sharded argument is this rank's block of the leading axis
(:func:`parallel.mesh.shard_leading` cuts it from a replicated tensor);
every result is the same on every rank.
"""
from __future__ import annotations

import torch

from ..core import se3
from ..loop.icp import horn_from_moments, horn_moments
from ..ops import nn_cuda
from ..utils.precision import geometry_precision
from .mesh import Mesh


def detect_sharded(
    positions,  # (K/n, 3) this rank's keyframe translations
    stamps,  # (K/n,)
    kf_valid,  # (K/n,)
    query_idx: int,
    radius: float,
    time_gap: float,
    mesh: Mesh,
    axis: str = "kf",
    query_row=None,  # optional (4,) [qpos, qstamp], the same on every rank
):
    """Sharded radius + time-gap candidate search. Returns ``(idx, found)``
    as the replicated search does. A caller that already holds the query
    keyframe's position and stamp passes them as ``query_row``; otherwise
    the owning rank broadcasts them with one ``psum`` of its row."""
    Kl = positions.shape[0]
    gidx = mesh.rank * Kl + torch.arange(Kl, device=positions.device)
    if query_row is None:
        own_q = (gidx == int(query_idx)).to(torch.float32)
        query_row = mesh.psum(torch.sum(
            own_q[:, None] * torch.cat([positions, stamps[:, None]], dim=-1), dim=0))
    qrow = torch.as_tensor(query_row, dtype=torch.float32, device=positions.device)
    d = torch.linalg.vector_norm(positions - qrow[:3], dim=-1)
    ok = kf_valid & (d < radius) & (torch.abs(qrow[3] - stamps) > time_gap)
    dm = torch.where(ok, d, torch.inf)
    li = torch.argmin(dm).reshape(1)
    # one packed (distance, global index) pair per rank, gathered once
    allp = mesh.all_gather(torch.cat([dm[li], gidx[li].to(torch.float32)]))
    w = torch.argmin(allp[:, 0]).reshape(1)  # first rank on a tie: the lower index
    best = allp[w][0]
    found = torch.isfinite(best[0])
    return torch.where(found, best[1].to(torch.int32), -1), found


def gather_submap_sharded(
    kf_clouds,  # (K/n, P, 3) this rank's body-frame clouds
    kf_masks,  # (K/n, P)
    center_idx: int,
    n_sub: int,
    mesh: Mesh,
    axis: str = "kf",
):
    """The ±``n_sub`` keyframe window around ``center_idx`` from the
    sharded cloud store: ``(span, P, 3)`` clouds and ``(span, P)`` masks
    (rows outside the store fully masked), the same on every rank; the
    submap / voxelize / ICP path then runs on them as in
    ``loop/closure.py: build_submap``."""
    Kl = kf_clouds.shape[0]
    K = Kl * mesh.size
    dev = kf_clouds.device
    tgt = int(center_idx) + torch.arange(-n_sub, n_sub + 1, device=dev)
    take = (tgt >= 0) & (tgt < K) & (torch.div(tgt, Kl, rounding_mode="floor") == mesh.rank)
    li = torch.clamp(tgt - mesh.rank * Kl, 0, Kl - 1)
    win_c = torch.where(take[:, None, None], kf_clouds[li], 0.0)
    win_m = (take[:, None] & kf_masks[li]).to(torch.int32)
    # one collective: the clouds and the masks in one float buffer
    tot = mesh.psum(torch.cat([win_c, win_m[..., None].to(torch.float32)], dim=-1))
    return tot[..., :3], tot[..., 3] > 0


@geometry_precision()
def icp_align_sharded(
    src,  # (N/n, 3) this rank's block of the source points
    src_mask,  # (N/n,)
    dst,  # (M, 3) the whole destination
    dst_mask,  # (M,)
    mesh: Mesh,
    axis: str | None = None,
    init_T=None,
    max_iterations: int = 50,
    max_corr_dist: float = 52.5,
    nn_chunk: int = 2048,
):
    """Point-sharded ICP: each step every rank finds the nearest
    neighbours of its source block in the whole destination and the 16
    Horn moments are summed with one ``psum``; the 4x4 Horn problem is
    solved on every rank. Untrimmed and ``max_iterations`` steps long (PCL
    semantics: a global trim needs a distributed order statistic). Returns
    ``(T, fitness, n_corr)``, the same on every rank."""
    dev = src.device
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=dev)
    dst = dst.contiguous()
    dst_mask = dst_mask.contiguous()
    max_d2 = max_corr_dist * max_corr_dist

    def nn(ps):
        return nn_cuda.nearest_neighbors(ps.contiguous(), dst, dst_mask, nn_chunk)

    T = init_T
    for _ in range(max_iterations):
        ps = se3.apply(T, src[None])[0]
        nn_idx, nn_d2 = nn(ps)
        w = (src_mask & (nn_d2 < max_d2)).to(torch.float32)
        Sw, Sp, Sq, Spq = horn_moments(ps, dst[nn_idx.to(torch.int64)], w)
        m = mesh.psum(torch.cat([Sw[None], Sp, Sq, Spq.reshape(-1)]))
        R, t = horn_from_moments(m[0], m[1:4], m[4:7], m[7:16].reshape(3, 3))
        T = se3.compose(se3.make(R, t), T)
    ps = se3.apply(T, src[None])[0]
    _, nn_d2 = nn(ps)
    corr = src_mask & (nn_d2 < max_d2)
    # the count (exact in float32 below 2^24) and the squared sum in one psum
    tot = mesh.psum(torch.stack([torch.sum(corr.to(torch.float32)),
                                 torch.sum(torch.where(corr, nn_d2, 0.0))]))
    n_corr = tot[0].to(torch.int32)
    fitness = tot[1] / torch.clamp(tot[0], min=1.0)
    return T, torch.where(n_corr > 0, fitness, torch.inf), n_corr
