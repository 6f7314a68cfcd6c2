"""Submap assembly + loop verification (port of
``fastliosam_tpu/loop/closure.py``).

``LoopConfig`` has the JAX package's fields and defaults; its docstrings
there record why each deliberate divergence from the reference exists.
Point-to-plane ICP (``icp_method="p2pl"``) and multi-start ICP
(``icp_multistart > 1``) are later slices and raise here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.pointcloud import Cloud, voxel_downsample
from ..map import voxel_hash as vh
from ..utils.device import resolve_device, to_device
from ..utils.precision import geometry_precision
from .icp import icp_align


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
    translation when ``cfg.aniso_noise``)."""
    if icp_fn is not None:
        raise NotImplementedError("icp_fn (sharded ICP backends) is not ported yet")
    if cfg.icp_method != "point":
        raise NotImplementedError(f"icp_method={cfg.icp_method!r} is not ported yet")
    if cfg.icp_multistart > 1:
        raise NotImplementedError("icp_multistart > 1 is not ported yet")
    dev = resolve_device(device)
    kf_clouds, kf_cloud_masks, poses, kf_valid = to_device(
        (kf_clouds, kf_cloud_masks, poses, kf_valid), dev
    )
    src, src_mask = build_submap(kf_clouds, kf_cloud_masks, poses, kf_valid,
                                 query_idx, cfg)
    dst, dst_mask = build_submap(kf_clouds, kf_cloud_masks, poses, kf_valid,
                                 cand_idx, cfg)
    icp_tf, fitness, n_corr = icp_align(
        src,
        src_mask,
        dst,
        dst_mask,
        max_iterations=cfg.max_iterations,
        max_corr_dist=cfg.radius * cfg.max_corr_factor,
        nn_chunk=cfg.nn_chunk,
        trim_fraction=cfg.trim_fraction,
        convergence_eps=cfg.convergence_eps,
    )
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
        dst_map = _dst_surfel_map(dst, dst_mask, cfg)
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


def _dst_surfel_map(dst, dst_mask, cfg: LoopConfig):
    """Throwaway voxel-surfel map of the destination submap with the plane
    cache refreshed (feeds the anisotropic-noise coverage Gram)."""
    vm_cfg = vh.VoxelMapConfig(capacity=1 << 14, voxel_size=cfg.aniso_voxel,
                               min_points=5)
    m, _ = vh.insert(vh.make_map(vm_cfg, dst.device), vm_cfg, dst, dst_mask,
                     refresh_planes=True)
    return m


def _aniso_translation_scales_from_map(m, R_c, cfg: LoopConfig):
    """Per-axis translation sqrt-info scales (candidate body frame) from
    the destination's surface-normal coverage Gram ``Σ n nᵀ``."""
    w = m.plane_valid.to(torch.float32)
    Gw = (m.normal * w[:, None]).T @ m.normal
    Gb = R_c.T @ Gw @ R_c
    s = torch.diagonal(Gb)
    s_rel = s / torch.clamp(torch.max(s), min=1e-6)
    return torch.clamp(s_rel / cfg.aniso_tau, cfg.aniso_floor, 1.0).to(torch.float32)
