"""Batched Levenberg–Marquardt pose-graph solver with a PCG linear stage
(port of ``fastliosam_tpu/pgo/solver.py``).

Each LM iteration re-linearizes every factor in one batch and solves the
damped normal equations with matrix-free block-Jacobi preconditioned CG
(``A·v`` = gathers + scatter-adds over the factor lists) or, with
``linear_solver="dense"``, a Cholesky factorization. Step acceptance is a
``torch.where`` on device, so a solve reads nothing back. The scatter-adds
of the normal equations and the matvec sum in a fixed order
(``core/segment.py``; one sort per linearization), so a solve is
bit-for-bit repeatable on the card, as in JAX.

``marginal_covariance`` solves the six columns of H⁻¹ of one keyframe
with the same matvec and preconditioner (the GPS pose-covariance gate).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import se3, segment, so3
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
    rb, Ji, Jj = _between_residuals(g, cfg)
    rg, Jg = _gps_residuals(g, cfg)
    rp, Jp = _prior_residual(g, cfg, prior_pose)
    bi, bj, gi = _long(g.bt_i), _long(g.bt_j), _long(g.gps_idx)

    Hij = torch.einsum("fki,fkj->fij", Ji, Jj)
    Hf = segment.scatter_add(
        torch.cat([bi * K + bi, bj * K + bj, bi * K + bj, bj * K + bi, gi * K + gi]),
        torch.cat([torch.einsum("fki,fkj->fij", Ji, Ji),
                   torch.einsum("fki,fkj->fij", Jj, Jj),
                   Hij, Hij.transpose(-1, -2),
                   torch.einsum("fki,fkj->fij", Jg, Jg)]),
        K * K,
    )
    Hf[0] += Jp.T @ Jp
    H = Hf.reshape(K, K, 6, 6)

    b = segment.scatter_add(torch.cat([bi, bj, gi]), _rhs_terms(Ji, Jj, Jg, rb, rg), K)
    b[0] += -(Jp.T @ rp)
    return H, b


def _rhs_terms(Ji, Jj, Jg, rb, rg):
    """The per-factor terms of ``b = -JᵀWr``, in the order of the
    concatenated ``[bt_i, bt_j, gps_idx]`` scatter."""
    return -torch.cat([torch.einsum("fij,fi->fj", Ji, rb),
                       torch.einsum("fij,fi->fj", Jj, rb),
                       torch.einsum("fij,fi->fj", Jg, rg)])


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


def _linearize(g: PoseGraph, cfg: PoseGraphConfig, prior_pose, reduce=None):
    """``b = -JᵀWr``, per-pose diagonal Hessian blocks, and a matvec.
    ``reduce`` (the factor-sharded solve's ``psum``) combines the factor
    rows' scatter of ``b``, of the blocks and of every ``A·v`` across
    ranks before the prior's term is added."""
    K = g.poses.shape[0]
    dev = g.poses.device
    rb, Ji, Jj = _between_residuals(g, cfg)
    rg, Jg = _gps_residuals(g, cfg)
    rp, Jp = _prior_residual(g, cfg, prior_pose)
    bi, bj, gi = _long(g.bt_i), _long(g.bt_j), _long(g.gps_idx)

    # one sort of the factor endpoints serves b, the diagonal blocks and
    # every matvec of this linearization
    plan = segment.segment_plan(torch.cat([bi, bj, gi]))

    def scatter(terms, row_shape):
        zeros = torch.zeros((K,) + row_shape, dtype=torch.float32, device=dev)
        out = segment.index_add_(zeros, plan, terms)
        return out if reduce is None else reduce(out)

    b = scatter(_rhs_terms(Ji, Jj, Jg, rb, rg), (6,))
    b[0] += -(Jp.T @ rp)

    Hd = scatter(torch.cat([torch.einsum("fki,fkj->fij", Ji, Ji),
                            torch.einsum("fki,fkj->fij", Jj, Jj),
                            torch.einsum("fki,fkj->fij", Jg, Jg)]), (6, 6))
    Hd[0] += Jp.T @ Jp
    diag = torch.diagonal(Hd, dim1=-2, dim2=-1)

    def matvec(v, lam):
        """(JᵀWJ + lam·diag(H) + eps·I) v for v (K, 6), or for B vectors at
        once as v (K, B, 6)."""
        ub = (torch.einsum("fij,f...j->f...i", Ji, v[bi])
              + torch.einsum("fij,f...j->f...i", Jj, v[bj]))
        ug = torch.einsum("fij,f...j->f...i", Jg, v[gi])
        y = scatter(torch.cat([torch.einsum("fij,f...i->f...j", Ji, ub),
                               torch.einsum("fij,f...i->f...j", Jj, ub),
                               torch.einsum("fij,f...i->f...j", Jg, ug)]),
                    tuple(v.shape[1:]))
        v0 = v[0]
        y[0] += Jp.T @ (Jp @ v0) if v0.dim() == 1 else (Jp.T @ (Jp @ v0.T)).T
        d = diag.reshape((K,) + (1,) * (v.dim() - 2) + (6,))
        return y + lam * d * v + 1e-6 * v

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


@geometry_precision()
def marginal_covariance_dense(g: PoseGraph, cfg: PoseGraphConfig, idx: int,
                              prior_pose=None):
    """Dense-reference marginal covariance: assembles the (6K, 6K) normal
    matrix and Cholesky-factorizes it. Kept only as the tests' ground
    truth; the runtime path is :func:`marginal_covariance`."""
    if prior_pose is None:
        prior_pose = g.poses[0]
    K = g.poses.shape[0]
    dev = g.poses.device
    H, _ = _assemble_dense(g, cfg, prior_pose)
    Hfull = H.transpose(1, 2).reshape(K * 6, K * 6)
    invalid = torch.repeat_interleave(~g.kf_valid, 6).to(torch.float32)
    Hfull = Hfull + torch.diag(invalid + 1e-6)
    L = torch.linalg.cholesky_ex(Hfull).L
    cols = torch.arange(6, device=dev)
    E = torch.zeros((K * 6, 6), dtype=torch.float32, device=dev)
    E[idx * 6 + cols, cols] = 1.0
    y = torch.linalg.solve_triangular(L, E, upper=False)
    X = torch.linalg.solve_triangular(L.T, y, upper=True)
    return X[idx * 6: idx * 6 + 6]


@geometry_precision()
def marginal_covariance(g: PoseGraph, cfg: PoseGraphConfig, idx: int,
                        prior_pose=None):
    """6×6 marginal covariance block of keyframe ``idx`` at the current
    linearization (the reference's ``ISAM2::marginalCovariance`` read),
    tangent order [trans, rot].

    Matrix-free: the six columns of H⁻¹ that belong to keyframe ``idx``
    are solved together, as one batched block-Jacobi PCG of
    ``cfg.marginal_pcg_iters`` trips over the LM stage's matvec (the JAX
    package vmaps six CGs). Invalid keyframe blocks are decoupled with a
    unit diagonal so the system stays SPD. Runs on the device with no host
    read."""
    if prior_pose is None:
        prior_pose = g.poses[0]
    K = g.poses.shape[0]
    dev = g.poses.device
    _, Hd, matvec = _linearize(g, cfg, prior_pose)
    invalid = (~g.kf_valid).to(torch.float32)

    def mv(v):  # v (K, 6 columns, 6): H v + decoupling of invalid blocks
        return matvec(v, 0.0) + invalid[:, None, None] * v

    Minv = torch.linalg.inv_ex(
        Hd + torch.diag_embed(invalid[:, None] * torch.ones((1, 6), device=dev) + 1e-6)
    ).inverse

    def apply_M(r):
        return torch.einsum("kij,kbj->kbi", Minv, r)

    def dot(a, b):  # one inner product per column
        return torch.sum(a * b, dim=(0, 2))

    cols = torch.arange(6, device=dev)
    E = torch.zeros((K, 6, 6), dtype=torch.float32, device=dev)
    E[idx, cols, cols] = 1.0
    x = torch.zeros_like(E)
    r = E
    z = apply_M(r)
    p = z
    rz = dot(r, z)
    for _ in range(cfg.marginal_pcg_iters):
        Ap = mv(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > _EPS, rz / torch.clamp(pAp, min=_EPS), 0.0)
        x = x + alpha[None, :, None] * p
        r = r - alpha[None, :, None] * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > _EPS, rz_new / torch.clamp(rz, min=_EPS), 0.0)
        p = z + beta[None, :, None] * p
        rz = rz_new
    cov = x[idx]  # row c = e_cᵀ H⁻¹ restricted to block idx
    return 0.5 * (cov + cov.T)


def rotate_cov_to_world(cov6, R):
    """Conjugate a [trans, rot] right-perturbation tangent covariance into
    the world frame: ``blkdiag(R, R) · cov6 · blkdiag(R, R)ᵀ``. Needed
    before :func:`extrapolate_pose_cov`, whose displacement is world-frame."""
    Z = torch.zeros((3, 3), dtype=cov6.dtype, device=cov6.device)
    J = torch.cat([torch.cat([R, Z], dim=1), torch.cat([Z, R], dim=1)], dim=0)
    return J @ cov6 @ J.T


def extrapolate_pose_cov(cov6, dk, path_len, dxy, trans_var, rot_var):
    """First-order dead-reckoning extrapolation of the x/y translation
    marginal variances ``dk`` keyframes past the last solve (host numpy:
    the engine's GPS gate between solves). ``cov6`` is the world-frame
    6×6 [trans, rot] marginal at the solve (see
    :func:`rotate_cov_to_world`), ``path_len`` the odometry path length
    since, ``dxy`` the (2,) world x/y displacement since. Per axis: the
    translation random walk, the solve-time yaw variance and (t, yaw)
    cross-covariance levered by the perpendicular displacement, and the
    yaw noise injected after the solve; on loop-backs (net displacement ≪
    path length) the lever is bounded isotropically by the path
    half-length, blended continuously. Returns the (2,) variances (the
    JAX package's docstring has the derivation)."""
    var = np.array([cov6[0, 0], cov6[1, 1]], np.float64)
    dk = int(dk)
    if dk <= 0:
        return var
    yaw_var = float(cov6[5, 5])
    cov_x_yaw = float(cov6[0, 5])
    cov_y_yaw = float(cov6[1, 5])
    dx, dy = float(dxy[0]), float(dxy[1])
    norm2 = dx * dx + dy * dy
    dbar = float(path_len) / dk
    s2 = (dk - 1) * dk * (2 * dk - 1) / 6.0  # Σ_{m<dk} m²
    walk = rot_var * dbar * dbar * s2
    lev2 = 0.25 * path_len * path_len
    inv_n2 = 1.0 / max(norm2, 1e-12)
    lev_x = dy * dy * yaw_var - 2.0 * dy * cov_x_yaw + dy * dy * inv_n2 * walk
    lev_y = dx * dx * yaw_var + 2.0 * dx * cov_y_yaw + dx * dx * inv_n2 * walk
    iso = 0.5 * lev2 * yaw_var + 0.5 * walk
    w = min(norm2 / lev2, 1.0) if lev2 > 0.0 else 1.0
    var[0] += dk * trans_var + w * lev_x + (1.0 - w) * iso
    var[1] += dk * trans_var + w * lev_y + (1.0 - w) * iso
    return var
