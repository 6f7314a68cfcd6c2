"""Factor-sharded pose-graph solve (port of
``fastliosam_tpu/parallel/sharded_pgo.py``): the factor lists (between and
GPS) shard along the ``kf`` axis, the poses stay replicated, and every
global quantity of the LM / PCG loop is one ``psum`` over the mesh.

Each rank linearizes its factor rows and scatters them into ``(K, 6)``
(or ``(K, 6, 6)``) in the fixed order of ``core/segment.py``; ``psum``
combines ``b``, the diagonal blocks, every ``A·v`` of the PCG and the
cost. The prior, the PCG's dot products and the step acceptance run on
the replicated ``(K, 6)`` vectors, as in JAX, so every rank computes the
same bits and takes the same steps. With ``loop_gnc_barc > 0`` the GNC
weights are per factor, hence local; only the anneal's start (the largest
loop residual) is a ``pmax``.

As in the JAX package the sharded solve applies no Huber weights and
always runs the PCG (never the dense factorization).
"""
from __future__ import annotations

import torch

from ..core import se3
from ..pgo.graph import PoseGraph, PoseGraphConfig
from ..pgo.solver import (
    _between_residuals,
    _gnc_loop_weights,
    _gps_residuals,
    _linearize,
    _loop_resid2,
    _pcg,
    _prior_residual,
)
from ..utils.precision import geometry_precision
from .mesh import Mesh, pad_to_multiple, shard_leading

_FACTOR_FIELDS = ("bt_i", "bt_j", "bt_rel", "bt_sqrt_info", "bt_valid",
                  "gps_idx", "gps_xyz", "gps_sqrt_info", "gps_valid")


def shard_factors(g: PoseGraph, mesh: Mesh) -> PoseGraph:
    """This rank's block of the factor rows of ``g`` (padded to a multiple
    of the mesh; a padded between-factor measures the identity and every
    padded row is invalid), with the poses and keyframe flags whole and
    the factor counters this block's."""
    blocks = {}
    for name in _FACTOR_FIELDS:
        x = pad_to_multiple(getattr(g, name), mesh.size)
        if name == "bt_rel" and x.shape[0] > g.bt_rel.shape[0]:
            # padded rows measure the identity (an invalid factor all the same)
            x[g.bt_rel.shape[0]:] = torch.eye(4, dtype=x.dtype, device=x.device)
        blocks[name] = shard_leading(mesh, x)
    return g._replace(
        poses=g.poses.to(mesh.device), kf_valid=g.kf_valid.to(mesh.device),
        n_kf=g.n_kf.to(mesh.device),
        n_bt=torch.sum(blocks["bt_valid"].to(torch.int32)),
        n_gps=torch.sum(blocks["gps_valid"].to(torch.int32)),
        **blocks,
    )


@geometry_precision()
def solve_sharded(g: PoseGraph, cfg: PoseGraphConfig, mesh: Mesh, axis: str = "kf"):
    """LM solve with the factor rows sharded over the mesh; returns
    ``(graph, cost)`` as :func:`fastliosam_tpu_torch.pgo.solve` does, the
    same on every rank, with the prior on the first pose as there. ``g``
    is the whole graph, as every rank holds it."""
    g = g._replace(**{f: getattr(g, f).to(mesh.device) for f in g._fields})
    prior_pose = g.poses[0]
    # no robust kernel on the sharded path (as in the JAX package)
    lin_cfg = cfg._replace(loop_huber_delta=0.0, gps_huber_delta=0.0)
    gl = shard_factors(g, mesh)
    kf_mask = g.kf_valid[:, None].to(torch.float32)

    def cost_of(gw, poses):
        gg = gw._replace(poses=poses)
        rb, _, _ = _between_residuals(gg)
        rg, _ = _gps_residuals(gg)
        total = mesh.psum(0.5 * (torch.sum(rb * rb) + torch.sum(rg * rg)))
        rp, _ = _prior_residual(gg, cfg, prior_pose)
        return total + 0.5 * torch.sum(rp * rp)

    def lm_scan(gw, poses):
        """The LM loop of ``pgo.solve`` under fixed (GNC-scaled) weights."""
        cost = cost_of(gw, poses)
        lam = torch.full((), cfg.lambda_init, dtype=torch.float32, device=mesh.device)
        for _ in range(cfg.lm_iters):
            b, Hd, matvec = _linearize(gw._replace(poses=poses), lin_cfg, prior_pose,
                                       reduce=mesh.psum)
            dx = _pcg(matvec, b, Hd, lam, cfg.pcg_iters) * kf_mask
            cand = se3.retract(poses, dx)
            cand = torch.where(g.kf_valid[:, None, None], cand, poses)
            new_cost = cost_of(gw, cand)
            accept = new_cost < cost
            poses = torch.where(accept, cand, poses)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
                              1e-9, 1e6)
        return poses, cost

    if cfg.loop_gnc_barc <= 0.0:
        poses, cost = lm_scan(gl, g.poses)
        return g._replace(poses=poses), cost

    is_loop = (torch.abs(gl.bt_i - gl.bt_j) > 1) & gl.bt_valid
    r2max = mesh.pmax(torch.max(torch.where(is_loop, _loop_resid2(gl, cfg, g.poses), 0.0)))
    mu = torch.clamp(2.0 * r2max / float(cfg.loop_gnc_barc ** 2), min=1.0)
    if cfg.gnc_div > 0.0:
        gnc_div = torch.full((), cfg.gnc_div, dtype=torch.float32, device=mesh.device)
    else:  # auto: land on mu = 1 at the last stage
        gnc_div = torch.exp(torch.log(mu) / float(max(cfg.gnc_stages - 1, 1)))
    poses = g.poses
    for _ in range(cfg.gnc_stages):
        sw = torch.sqrt(_gnc_loop_weights(gl, cfg, poses, mu))
        poses, cost = lm_scan(gl._replace(bt_sqrt_info=gl.bt_sqrt_info * sw[:, None]), poses)
        mu = torch.clamp(mu / gnc_div, min=1.0)
    return g._replace(poses=poses), cost
