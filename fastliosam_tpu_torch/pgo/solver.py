"""Batched Levenberg–Marquardt pose-graph solver with a PCG linear stage
(port of ``fastliosam_tpu/pgo/solver.py``).

Each LM iteration re-linearizes every factor in one batch and solves the
damped normal equations with matrix-free block-Jacobi preconditioned CG
(``A·v`` = gathers + scatter-adds over the factor lists) or, with
``linear_solver="dense"``, a Cholesky factorization. Step acceptance is a
``torch.where`` on device, so a solve reads nothing back. ``index_add_``
scatter-adds run in a run-dependent order on CUDA, so repeated solves
agree to float32 rounding, not bit for bit.

``marginal_covariance`` (GPS only) is a later slice.
"""
from __future__ import annotations

import torch

from ..core import se3, so3
from ..utils.device import resolve_device, to_device, upload
from ..utils.precision import geometry_precision
from .graph import PoseGraph, PoseGraphConfig

_EPS = 1e-12


def _ad_se3(xi):
    """SE(3) adjoint of a tangent vector (..., 6) -> (..., 6, 6)."""
    rho, th = xi[..., :3], xi[..., 3:]
    Z = torch.zeros(xi.shape[:-1] + (6, 6), dtype=xi.dtype, device=xi.device)
    Z[..., :3, :3] = so3.hat(th)
    Z[..., :3, 3:] = so3.hat(rho)
    Z[..., 3:, 3:] = so3.hat(th)
    return Z


def _jr_inv(r):
    """First-order inverse right Jacobian of SE(3): I + 0.5 ad(r)."""
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    return eye + 0.5 * _ad_se3(r)


def _long(t):
    return t.to(torch.int64)


def _between_residuals(g: PoseGraph, cfg: PoseGraphConfig | None = None):
    """Whitened residuals + Jacobian blocks of all between factors."""
    Ti = g.poses[_long(g.bt_i)]
    Tj = g.poses[_long(g.bt_j)]
    E = se3.compose(se3.inverse(g.bt_rel), se3.between(Ti, Tj))
    r0 = se3.log(E)
    Jr = _jr_inv(r0)
    Ad = se3.adjoint(se3.between(Tj, Ti))
    w = g.bt_sqrt_info * g.bt_valid[:, None]
    if cfg is not None and cfg.loop_huber_delta > 0.0:
        is_loop = torch.abs(g.bt_i - g.bt_j) > 1
        rn = torch.linalg.vector_norm(w * r0, dim=-1)
        hub = torch.sqrt(torch.clamp(cfg.loop_huber_delta / torch.clamp(rn, min=_EPS), max=1.0))
        w = w * torch.where(is_loop, hub, 1.0)[:, None]
    Jj = w[:, :, None] * Jr
    Ji = -w[:, :, None] * (Jr @ Ad)
    return w * r0, Ji, Jj


def _gps_residuals(g: PoseGraph, cfg: PoseGraphConfig | None = None):
    Ti = g.poses[_long(g.gps_idx)]
    r0 = se3.trans(Ti) - g.gps_xyz
    w = g.gps_sqrt_info * g.gps_valid[:, None]
    if cfg is not None and cfg.gps_huber_delta > 0.0:
        rn = torch.linalg.vector_norm(w * r0, dim=-1)
        hub = torch.sqrt(torch.clamp(cfg.gps_huber_delta / torch.clamp(rn, min=_EPS), max=1.0))
        w = w * hub[:, None]
    # d trans(T Exp(xi))/d xi = [R, 0]
    J = torch.cat([se3.rot(Ti), torch.zeros_like(se3.rot(Ti))], dim=-1)
    return w * r0, w[:, :, None] * J


def _prior_residual(g: PoseGraph, cfg: PoseGraphConfig, prior_pose):
    r0 = se3.log(se3.between(prior_pose, g.poses[0]))
    w = cfg.prior_sqrt_info
    return w * r0, w * _jr_inv(r0)


def graph_cost(g: PoseGraph, cfg: PoseGraphConfig, prior_pose=None):
    """0.5 * sum of squared whitened residuals (masked)."""
    if prior_pose is None:
        prior_pose = torch.eye(4, dtype=torch.float32, device=g.poses.device)
    rb, _, _ = _between_residuals(g, cfg)
    rg, _ = _gps_residuals(g, cfg)
    rp, _ = _prior_residual(g, cfg, prior_pose)
    return 0.5 * (torch.sum(rb * rb) + torch.sum(rg * rg) + torch.sum(rp * rp))


def _assemble_dense(g: PoseGraph, cfg: PoseGraphConfig, prior_pose):
    """Full (K, K, 6, 6) Gauss-Newton normal matrix + (K, 6) rhs."""
    K = g.poses.shape[0]
    dev = g.poses.device
    rb, Ji, Jj = _between_residuals(g, cfg)
    rg, Jg = _gps_residuals(g, cfg)
    rp, Jp = _prior_residual(g, cfg, prior_pose)
    bi, bj, gi = _long(g.bt_i), _long(g.bt_j), _long(g.gps_idx)

    Hf = torch.zeros((K * K, 6, 6), dtype=torch.float32, device=dev)
    Hf.index_add_(0, bi * K + bi, torch.einsum("fki,fkj->fij", Ji, Ji))
    Hf.index_add_(0, bj * K + bj, torch.einsum("fki,fkj->fij", Jj, Jj))
    Hij = torch.einsum("fki,fkj->fij", Ji, Jj)
    Hf.index_add_(0, bi * K + bj, Hij)
    Hf.index_add_(0, bj * K + bi, Hij.transpose(-1, -2))
    Hf.index_add_(0, gi * K + gi, torch.einsum("fki,fkj->fij", Jg, Jg))
    Hf[0] += Jp.T @ Jp
    H = Hf.reshape(K, K, 6, 6)

    b = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    b.index_add_(0, bi, -torch.einsum("fij,fi->fj", Ji, rb))
    b.index_add_(0, bj, -torch.einsum("fij,fi->fj", Jj, rb))
    b.index_add_(0, gi, -torch.einsum("fij,fi->fj", Jg, rg))
    b[0] += -(Jp.T @ rp)
    return H, b


def _dense_step(g: PoseGraph, cfg: PoseGraphConfig, prior_pose, lam):
    K = g.poses.shape[0]
    H, b = _assemble_dense(g, cfg, prior_pose)
    ar = torch.arange(K, device=g.poses.device)
    dk = torch.diagonal(H[ar, ar], dim1=-2, dim2=-1)
    damp = lam * dk + 1e-6
    Hfull = H.transpose(1, 2).reshape(K * 6, K * 6) + torch.diag(damp.reshape(-1))
    L = torch.linalg.cholesky_ex(Hfull).L
    y = torch.linalg.solve_triangular(L, b.reshape(-1, 1), upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True)
    return dx.reshape(K, 6)


def _linearize(g: PoseGraph, cfg: PoseGraphConfig, prior_pose):
    """``b = -JᵀWr``, per-pose diagonal Hessian blocks, and a matvec."""
    K = g.poses.shape[0]
    dev = g.poses.device
    rb, Ji, Jj = _between_residuals(g, cfg)
    rg, Jg = _gps_residuals(g, cfg)
    rp, Jp = _prior_residual(g, cfg, prior_pose)
    bi, bj, gi = _long(g.bt_i), _long(g.bt_j), _long(g.gps_idx)

    b = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    b.index_add_(0, bi, -torch.einsum("fij,fi->fj", Ji, rb))
    b.index_add_(0, bj, -torch.einsum("fij,fi->fj", Jj, rb))
    b.index_add_(0, gi, -torch.einsum("fij,fi->fj", Jg, rg))
    b[0] += -(Jp.T @ rp)

    Hd = torch.zeros((K, 6, 6), dtype=torch.float32, device=dev)
    Hd.index_add_(0, bi, torch.einsum("fki,fkj->fij", Ji, Ji))
    Hd.index_add_(0, bj, torch.einsum("fki,fkj->fij", Jj, Jj))
    Hd.index_add_(0, gi, torch.einsum("fki,fkj->fij", Jg, Jg))
    Hd[0] += Jp.T @ Jp
    diag = torch.diagonal(Hd, dim1=-2, dim2=-1)

    def matvec(v, lam):
        """(JᵀWJ + lam·diag(H) + eps·I) v for v (K, 6)."""
        ub = torch.einsum("fij,fj->fi", Ji, v[bi]) + torch.einsum("fij,fj->fi", Jj, v[bj])
        y = torch.zeros((K, 6), dtype=torch.float32, device=dev)
        y.index_add_(0, bi, torch.einsum("fij,fi->fj", Ji, ub))
        y.index_add_(0, bj, torch.einsum("fij,fi->fj", Jj, ub))
        ug = torch.einsum("fij,fj->fi", Jg, v[gi])
        y.index_add_(0, gi, torch.einsum("fij,fi->fj", Jg, ug))
        y[0] += Jp.T @ (Jp @ v[0])
        return y + lam * diag * v + 1e-6 * v

    return b, Hd, matvec


def _pcg(matvec, b, Hd, lam, iters):
    """Block-Jacobi preconditioned CG for (K, 6) unknowns."""
    diag = torch.diagonal(Hd, dim1=-2, dim2=-1)
    Minv = torch.linalg.inv_ex(Hd + torch.diag_embed(lam * diag + 1e-6)).inverse

    def apply_M(r):
        return torch.einsum("kij,kj->ki", Minv, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = matvec(p, lam)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > _EPS, rz / torch.clamp(pAp, min=_EPS), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > _EPS, rz_new / torch.clamp(rz, min=_EPS), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


@geometry_precision()
def _loop_resid2(g: PoseGraph, cfg: PoseGraphConfig, poses):
    """Chain-aware squared consistency residual per between factor — the
    GNC measure: a loop spanning d hops is judged against sigma²_meas +
    d·sigma²_hop."""
    Ti = poses[_long(g.bt_i)]
    Tj = poses[_long(g.bt_j)]
    r0 = se3.log(se3.compose(se3.inverse(g.bt_rel), se3.between(Ti, Tj)))
    rt2 = torch.sum(r0[:, :3] ** 2, dim=-1)
    rr2 = torch.sum(r0[:, 3:] ** 2, dim=-1)
    d = torch.abs(g.bt_i - g.bt_j).to(torch.float32)
    si_t = torch.mean(g.bt_sqrt_info[:, :3], dim=-1)
    si_r = torch.mean(g.bt_sqrt_info[:, 3:], dim=-1)
    var_t = 1.0 / torch.clamp(si_t, min=_EPS) ** 2 + cfg.gnc_hop_trans_var * d
    var_r = 1.0 / torch.clamp(si_r, min=_EPS) ** 2 + cfg.gnc_hop_rot_var * d
    return (rt2 / var_t + rr2 / var_r) * g.bt_valid


def _gnc_loop_weights(g: PoseGraph, cfg: PoseGraphConfig, poses, mu):
    """Per-factor GNC-GM weights: 1 on the odometry chain, annealed
    Geman-McClure on loop factors."""
    rn2 = _loop_resid2(g, cfg, poses)
    c2 = float(cfg.loop_gnc_barc ** 2)
    w = (mu * c2 / (rn2 + mu * c2)) ** 2
    is_loop = torch.abs(g.bt_i - g.bt_j) > 1
    return torch.where(is_loop & g.bt_valid, w, 1.0)


@geometry_precision()
def solve(g: PoseGraph, cfg: PoseGraphConfig, prior_pose=None, device=None):
    """Run the LM loop; returns ``(graph with optimized poses, cost)``.
    With ``cfg.loop_gnc_barc > 0`` the LM loop runs inside the staged GNC
    anneal of the JAX package."""
    dev = resolve_device(device)
    g = to_device(g, dev)
    if prior_pose is None:
        prior_pose = g.poses[0]
    if not isinstance(prior_pose, torch.Tensor):
        prior_pose = upload(prior_pose, dev)
    prior_pose = prior_pose.to(dev)
    kf_mask = g.kf_valid[:, None].to(torch.float32)
    use_dense = cfg.linear_solver == "dense"

    def lm_scan(gw, poses):
        cost = graph_cost(gw._replace(poses=poses), cfg, prior_pose)
        lam = torch.full((), cfg.lambda_init, dtype=torch.float32, device=dev)
        for _ in range(cfg.lm_iters):
            gg = gw._replace(poses=poses)
            if use_dense:
                dx = _dense_step(gg, cfg, prior_pose, lam)
            else:
                b, Hd, matvec = _linearize(gg, cfg, prior_pose)
                dx = _pcg(matvec, b, Hd, lam, cfg.pcg_iters)
            dx = dx * kf_mask
            cand = se3.retract(poses, dx)
            cand = torch.where(g.kf_valid[:, None, None], cand, poses)
            new_cost = graph_cost(gw._replace(poses=cand), cfg, prior_pose)
            accept = new_cost < cost
            poses = torch.where(accept, cand, poses)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
            lam = torch.clamp(lam, 1e-9, 1e6)
        return poses, cost

    if cfg.loop_gnc_barc <= 0.0:
        poses, cost = lm_scan(g, g.poses)
        return g._replace(poses=poses), cost

    # mu_0 from the worst loop residual at the initial poses
    rn2 = _loop_resid2(g, cfg, g.poses)
    is_loop = (torch.abs(g.bt_i - g.bt_j) > 1) & g.bt_valid
    r2max = torch.max(torch.where(is_loop, rn2, 0.0))
    mu = torch.clamp(2.0 * r2max / float(cfg.loop_gnc_barc ** 2), min=1.0)
    if cfg.gnc_div > 0.0:
        gnc_div = torch.full((), cfg.gnc_div, dtype=torch.float32, device=dev)
    else:  # auto: land on mu = 1 at the last stage
        gnc_div = torch.exp(torch.log(mu) / float(max(cfg.gnc_stages - 1, 1)))
    poses = g.poses
    for _ in range(cfg.gnc_stages):
        sw = torch.sqrt(_gnc_loop_weights(g, cfg, poses, mu))
        gw = g._replace(bt_sqrt_info=g.bt_sqrt_info * sw[:, None])
        poses, cost = lm_scan(gw, poses)
        mu = torch.clamp(mu / gnc_div, min=1.0)
    return g._replace(poses=poses), cost
