"""Submap assembly + loop verification (port of
``fastliosam_tpu/loop/closure.py``).

``LoopConfig`` has the JAX package's fields and defaults; its docstrings
there record why each deliberate divergence from the reference exists.
Both ICP methods (``icp_method="point"`` and ``"p2pl"``, whose normals come
from the destination's surfel map through the cached-plane query) and the
multi-start coarse search (``icp_multistart > 1``) are ported, and so is
the alignment backend ``icp_fn`` (the mesh's point-sharded ICP,
``parallel/sharded_loop.py: icp_align_sharded``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.eigh3 import eigh3
from ..core.pointcloud import Cloud, voxel_downsample
from ..map import voxel_hash as vh
from ..utils.device import resolve_device, to_device
from ..utils.precision import geometry_precision
from .icp import icp_align, icp_align_p2pl


class LoopConfig(NamedTuple):
    radius: float = 35.0
    time_gap: float = 30.0
    num_submap_keyframes: int = 5
    voxel_res: float = 0.3
    icp_score_threshold: float = 1.5
    max_iterations: int = 50
    convergence_eps: float = 0.01
    max_corr_factor: float = 1.5
    submap_points: int = 16384
    nn_chunk: int = 2048
    trim_fraction: float = 0.8
    min_correspondences: int = 100
    icp_method: str = "point"
    aniso_noise: bool = True
    aniso_voxel: float = 1.0
    aniso_tau: float = 0.3
    aniso_floor: float = 0.02
    aniso_blend: float = 0.25
    degen_move_limit: float = 2.0
    icp_multistart: int = 1
    multistart_step: float = 4.0
    multistart_iters: int = 12
    max_sqrt_info: float = 0.0

    @classmethod
    def reference_exact(cls, **overrides):
        """Every documented divergence restored to the reference spec."""
        base = dict(
            radius=35.0, time_gap=30.0, num_submap_keyframes=5,
            voxel_res=0.3, icp_score_threshold=1.5, max_iterations=50,
            convergence_eps=0.01, max_corr_factor=1.5, trim_fraction=1.0,
            min_correspondences=0, icp_method="point", aniso_noise=False,
            degen_move_limit=0.0,
        )
        base.update(overrides)
        return cls(**base)


def build_submap(
    kf_clouds,  # (K, P, 3) keyframe clouds in body frame
    kf_cloud_masks,  # (K, P)
    poses,  # (K, 4, 4) corrected keyframe poses
    kf_valid,  # (K,)
    center_idx: int,
    cfg: LoopConfig,
):
    """World-frame submap of ±num_submap_keyframes around ``center_idx``,
    voxelized and packed to the ``submap_points`` budget."""
    dev = kf_clouds.device
    span = 2 * cfg.num_submap_keyframes + 1
    K = kf_clouds.shape[0]
    raw = int(center_idx) + torch.arange(
        -cfg.num_submap_keyframes, cfg.num_submap_keyframes + 1, device=dev
    )
    idx = torch.clamp(raw, 0, K - 1)
    sel_valid = kf_valid[idx] & (raw >= 0) & (raw < K)
    masks = kf_cloud_masks[idx] & sel_valid[:, None]
    world = se3.apply(poses[idx], kf_clouds[idx])
    flat = world.reshape(span * kf_clouds.shape[1], 3)
    ds = voxel_downsample(Cloud(xyz=flat, mask=masks.reshape(-1)), cfg.voxel_res)
    budget = min(cfg.submap_points, ds.xyz.shape[0])
    return ds.xyz[:budget], ds.mask[:budget]


@geometry_precision()
def verify_loop(
    kf_clouds,
    kf_cloud_masks,
    poses,
    kf_valid,
    query_idx: int,
    cand_idx: int,
    cfg: LoopConfig,
    icp_fn=None,
    device=None,
):
    """ICP-verify a loop candidate. Returns ``(rel, sqrt_info, accepted,
    fitness)`` as device tensors: ``rel`` is the between-factor measurement
    from query to candidate, ``(icp_tf · T_q)⁻¹ · T_c``, and ``sqrt_info``
    the diagonal sqrt information (1/sqrt(fitness), anisotropic in
    translation when ``cfg.aniso_noise``).

    ``icp_fn`` overrides the submap alignment: ``(src, src_mask, dst,
    dst_mask) -> (T, fitness, n_corr)``; the multi-start search is off
    then, as in the JAX package."""
    dev = resolve_device(device)
    kf_clouds, kf_cloud_masks, poses, kf_valid = to_device(
        (kf_clouds, kf_cloud_masks, poses, kf_valid), dev
    )
    src, src_mask = build_submap(kf_clouds, kf_cloud_masks, poses, kf_valid,
                                 query_idx, cfg)
    dst, dst_mask = build_submap(kf_clouds, kf_cloud_masks, poses, kf_valid,
                                 cand_idx, cfg)
    # the destination's surfel map: the point-to-plane normals, the
    # anisotropic-noise coverage Gram and the multi-start's weak axis
    multistart = cfg.icp_multistart > 1 and icp_fn is None
    if cfg.icp_method == "p2pl" or cfg.aniso_noise or multistart:
        dst_map, dst_map_cfg = _dst_surfel_map(dst, dst_mask, cfg)
    init_T = torch.eye(4, dtype=torch.float32, device=dev)
    if multistart:
        init_T = _multistart_init(src, src_mask, dst, dst_mask, dst_map, cfg)
    icp_kw = dict(init_T=init_T, max_iterations=cfg.max_iterations,
                  max_corr_dist=cfg.radius * cfg.max_corr_factor, nn_chunk=cfg.nn_chunk,
                  trim_fraction=cfg.trim_fraction, convergence_eps=cfg.convergence_eps)
    if icp_fn is not None:
        icp_tf, fitness, n_corr = icp_fn(src, src_mask, dst, dst_mask)
    elif cfg.icp_method == "p2pl":
        nrm_pts, _, nvalid = vh.query_planes(dst_map, dst_map_cfg, dst, dst_mask)
        icp_tf, fitness, n_corr = icp_align_p2pl(src, src_mask, dst, dst_mask, nrm_pts,
                                                 nvalid, **icp_kw)
    else:
        icp_tf, fitness, n_corr = icp_align(src, src_mask, dst, dst_mask, **icp_kw)
    accepted = (fitness < cfg.icp_score_threshold) & (n_corr > cfg.min_correspondences)
    T_q = poses[query_idx]
    T_c = poses[cand_idx]
    pose_from = se3.compose(icp_tf, T_q)
    rel = se3.between(pose_from, T_c)
    base_info = 1.0 / torch.sqrt(torch.clamp(fitness, min=1e-4))
    t_info = base_info
    if cfg.max_sqrt_info > 0.0:
        # translation only: ICP slides are translational
        t_info = torch.clamp(base_info, max=cfg.max_sqrt_info)
    sqrt_info = torch.cat([t_info.expand(3), base_info.expand(3)]).to(torch.float32)
    if cfg.aniso_noise:
        R_c = se3.rot(T_c)
        scale_t = _aniso_translation_scales_from_map(dst_map, R_c, cfg)
        base = sqrt_info[:3]
        if cfg.aniso_blend > 0.0:
            u = torch.clamp(
                (scale_t - (1.0 - cfg.aniso_blend)) / cfg.aniso_blend, 0.0, 1.0
            )
            trans_info = scale_t + u * (base - scale_t)
        else:
            trans_info = torch.where(scale_t >= 0.999, base, scale_t)
        sqrt_info = torch.cat([trans_info, sqrt_info[3:]])
        if cfg.degen_move_limit > 0.0:
            # slide rejection: the query's correction in the candidate frame
            d_body = R_c.T @ (se3.trans(pose_from) - se3.trans(T_q))
            weak = scale_t < 1.0
            slid = torch.any(weak & (torch.abs(d_body) > cfg.degen_move_limit))
            accepted = accepted & ~slid
    return rel, sqrt_info, accepted, fitness


def _multistart_init(src, src_mask, dst, dst_mask, dst_map, cfg: LoopConfig):
    """Coarse multi-start search: a short point-to-point ICP from
    ``icp_multistart`` initial translations spaced ``multistart_step`` apart
    along the destination's weakest horizontal normal-coverage direction
    (the axis slides live on); returns the coarse transform of the best
    fitness (the first on a tie) as the refinement's seed. The starts run
    one after another, as the JAX package's ``lax.map`` runs them."""
    w = dst_map.plane_valid.to(torch.float32)
    Gw = (dst_map.normal * w[:, None]).T @ dst_map.normal
    lam, V = eigh3(0.5 * (Gw + Gw.T))
    # 1-element indices: indexing with a 0-dim tensor would read it back
    axis = V.index_select(1, torch.argmin(lam).reshape(1))[:, 0]
    # slides are horizontal (vehicle motion): project out z, normalize
    axis = torch.cat([axis[:2], torch.zeros_like(axis[2:])])
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=1e-6)
    M = cfg.icp_multistart
    offs = (torch.arange(M, dtype=torch.float32, device=dst.device) - (M - 1) / 2.0) \
        * cfg.multistart_step
    inits = torch.eye(4, dtype=torch.float32, device=dst.device).repeat(M, 1, 1)
    inits[:, :3, 3] = offs[:, None] * axis[None, :]
    Ts, fits = [], []
    for k in range(M):
        T, fit, _ = icp_align(
            src, src_mask, dst, dst_mask, init_T=inits[k],
            max_iterations=cfg.multistart_iters,
            max_corr_dist=cfg.radius * cfg.max_corr_factor,
            nn_chunk=cfg.nn_chunk,
            trim_fraction=cfg.trim_fraction,
            convergence_eps=cfg.convergence_eps,
        )
        Ts.append(T)
        fits.append(fit)
    return torch.stack(Ts).index_select(0, torch.argmin(torch.stack(fits)).reshape(1))[0]


def _dst_surfel_map(dst, dst_mask, cfg: LoopConfig):
    """Throwaway voxel-surfel map of the destination submap with the plane
    cache refreshed, and its config: the point-to-plane normals, the
    anisotropic-noise coverage Gram and the multi-start's weak axis."""
    vm_cfg = vh.VoxelMapConfig(capacity=1 << 14, voxel_size=cfg.aniso_voxel,
                               min_points=5)
    m, _ = vh.insert(vh.make_map(vm_cfg, dst.device), vm_cfg, dst, dst_mask,
                     refresh_planes=True)
    return m, vm_cfg


def _aniso_translation_scales_from_map(m, R_c, cfg: LoopConfig):
    """Per-axis translation sqrt-info scales (candidate body frame) from
    the destination's surface-normal coverage Gram ``Σ n nᵀ``."""
    w = m.plane_valid.to(torch.float32)
    Gw = (m.normal * w[:, None]).T @ m.normal
    Gb = R_c.T @ Gw @ R_c
    s = torch.diagonal(Gb)
    s_rel = s / torch.clamp(torch.max(s), min=1e-6)
    return torch.clamp(s_rel / cfg.aniso_tau, cfg.aniso_floor, 1.0).to(torch.float32)
