"""IMU forward propagation and deskew (port of ``fastliosam_tpu/odom/imu.py``).

The JAX package composes the per-interval attitude increments with
``lax.associative_scan``; torch has no counterpart, so the port takes the
prefix product sequentially (the same per-step model in another evaluation
order: equal up to float32 rounding, held to :func:`propagate_sequential`
and to the JAX function within a stated tolerance in the tests). The
24x24 covariance composition keeps the JAX package's pairwise tree and
runs it in full float32.

:func:`propagate` and :func:`deskew` also take B lanes at once (the
batched rollout, ``eval/batch_eval.py``): a batched state, ``(B, M, ...)``
IMU samples with each lane's own mask and ``(B, N)`` points, every
operation covering all lanes; the same model per lane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import so3
from .state import NavState, OdomConfig


class ImuBatch(NamedTuple):
    """Fixed-capacity IMU samples covering one scan interval; ``stamps`` are
    seconds since the previous scan end, ascending, masked lanes last."""

    stamps: torch.Tensor  # (M,)
    gyro: torch.Tensor  # (M, 3) rad/s
    acc: torch.Tensor  # (M, 3) m/s^2 (specific force)
    mask: torch.Tensor  # (M,)


def _interval_dts(imu: ImuBatch, scan_dt):
    # interval of sample i: [t_i, t_{i+1}); the last valid sample integrates
    # up to scan_dt, padded samples contribute dt = 0 (over the last axis)
    next_valid = torch.zeros_like(imu.mask)
    next_valid[..., :-1] = imu.mask[..., 1:]
    t_next = torch.zeros_like(imu.stamps)
    t_next[..., :-1] = imu.stamps[..., 1:]
    t_next = torch.where(next_valid, t_next, scan_dt)
    return torch.where(imu.mask, torch.clamp(t_next - imu.stamps, 0.0, 1.0), 0.0)


def _transition(R, dR, a, dts, cfg: OdomConfig):
    """Per-interval error-state transition F and process noise Q, batched
    over the leading axes of ``dts`` (first order in dt)."""
    lead = tuple(dts.shape)
    dev = dts.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    dt3 = dts[..., None, None]
    F = torch.eye(24, dtype=torch.float32, device=dev).expand(lead + (24, 24)).clone()
    F[..., 0:3, 0:3] = dR.transpose(-1, -2)
    F[..., 0:3, 9:12] = -eye3 * dt3
    F[..., 3:6, 6:9] = eye3 * dt3
    F[..., 6:9, 0:3] = -(R @ so3.hat(a)) * dt3
    F[..., 6:9, 12:15] = -R * dt3
    F[..., 6:9, 15:18] = eye3 * dt3
    Q = torch.zeros(lead + (24, 24), dtype=torch.float32, device=dev)
    dt2 = (dts * dts)[..., None, None]
    Q[..., 0:3, 0:3] = eye3 * cfg.gyr_cov * dt2
    Q[..., 6:9, 6:9] = eye3 * cfg.acc_cov * dt2
    Q[..., 9:12, 9:12] = eye3 * cfg.b_gyr_cov * dt2
    Q[..., 12:15, 12:15] = eye3 * cfg.b_acc_cov * dt2
    return F, Q


def propagate(x: NavState, imu: ImuBatch, cfg: OdomConfig, scan_dt):
    """Propagate state + covariance through the IMU batch up to ``scan_dt``.

    Returns ``(state_at_scan_end, traj)`` with ``traj = (R (M,3,3), p (M,3),
    v (M,3), w (M,3), a_w (M,3), t (M,))``: the states at the start of each
    IMU interval, for deskewing. A batched state takes ``(B, M, ...)``
    samples, each lane with its own mask, and ``traj`` members are ``(B,
    M, ...)``.
    """
    dts = _interval_dts(imu, scan_dt)
    M = dts.shape[-1]
    w = imu.gyro - x.bg[..., None, :]
    a = imu.acc - x.ba[..., None, :]
    dR = so3.exp(w * dts[..., None])

    # attitude: inclusive prefix products dR_0 … dR_k (sequential), then the
    # exclusive prefix R_k = R0 · Π_{i<k} dR_i
    prods = [dR[..., 0, :, :]]
    for k in range(1, M):
        prods.append(prods[-1] @ dR[..., k, :, :])
    R0 = x.R[..., None, :, :]
    R_incl = R0 @ torch.stack(prods, -3)
    R_excl = torch.cat([R0, R_incl[..., :-1, :, :]], -3)

    spec = "mij,mj->mi" if a.dim() == 2 else "bmij,bmj->bmi"
    a_w = torch.einsum(spec, R_excl, a) + x.g[..., None, :]
    dv = a_w * dts[..., None]
    v_incl = x.v[..., None, :] + torch.cumsum(dv, -2)
    v_excl = torch.cat([x.v[..., None, :], v_incl[..., :-1, :]], -2)
    dp = v_excl * dts[..., None] + 0.5 * a_w * dts[..., None] ** 2
    p_incl = x.p[..., None, :] + torch.cumsum(dp, -2)

    # covariance: pairwise tree over (F, Q) transition pairs,
    # (F2,Q2)∘(F1,Q1) = (F2 F1, F2 Q1 F2ᵀ + Q2); only the total is needed
    Fr, Qr = _transition(R_excl, dR, a, dts, cfg)
    eye24 = torch.eye(24, dtype=torch.float32, device=dts.device)
    while Fr.shape[-3] > 1:
        if Fr.shape[-3] % 2:  # pad with the identity element (F=I, Q=0)
            Fr = torch.cat([Fr, eye24.expand(Fr.shape[:-3] + (1, 24, 24))], -3)
            Qr = torch.cat([Qr, torch.zeros_like(Qr[..., :1, :, :])], -3)
        Fa, Qa = Fr[..., 0::2, :, :], Qr[..., 0::2, :, :]  # element 2k happens first
        Fb, Qb = Fr[..., 1::2, :, :], Qr[..., 1::2, :, :]
        Fr, Qr = Fb @ Fa, Fb @ Qa @ Fb.transpose(-1, -2) + Qb
    F_tot, Q_tot = Fr[..., 0, :, :], Qr[..., 0, :, :]
    P_e = F_tot @ x.P @ F_tot.mT + Q_tot

    x_end = x._replace(
        R=so3.normalize_matrix(R_incl[..., -1, :, :]), p=p_incl[..., -1, :],
        v=v_incl[..., -1, :], P=P_e,
    )
    p_excl = torch.cat([x.p[..., None, :], p_incl[..., :-1, :]], -2)
    return x_end, (R_excl, p_excl, v_excl, w, a_w, imu.stamps)


def propagate_sequential(x: NavState, imu: ImuBatch, cfg: OdomConfig, scan_dt):
    """The textbook sequential recursion :func:`propagate` must reproduce
    (kept for tests)."""
    dts = _interval_dts(imu, scan_dt)
    R, p, v, P = x.R, x.p, x.v, x.P
    outs = []
    for k in range(dts.shape[0]):
        dt = dts[k]
        w = imu.gyro[k] - x.bg
        a = imu.acc[k] - x.ba
        a_w = R @ a + x.g
        outs.append((R, p, v, w, a_w))
        dR = so3.exp(w * dt)
        F, Q = _transition(R[None], dR[None], a[None], dt[None], cfg)
        R_n = so3.normalize_matrix(R @ dR)
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        P = F[0] @ P @ F[0].T + Q[0]
        R = R_n
    Rs, ps, vs, ws, aws = (torch.stack(t) for t in zip(*outs))
    return x._replace(R=R, p=p, v=v, P=P), (Rs, ps, vs, ws, aws, imu.stamps)


def deskew(pts_lidar, t_offsets, pt_mask, traj, x_end: NavState, cfg: OdomConfig,
           imu_mask, scan_dt):
    """Motion-compensate LiDAR points into the scan-end body frame, with
    piecewise-constant (w, a) inside each IMU interval. Batched: ``(B, N,
    ...)`` points, the ``(B, M, ...)`` trajectory of :func:`propagate` and
    ``(B, M)`` IMU masks; each point looks up its own lane's intervals."""
    Rs, ps, vs, ws, aws, stamps = traj
    pb = pts_lidar @ x_end.R_ext.mT + x_end.t_ext[..., None, :]
    # interval lookup: the last IMU stamp <= t (masked samples get +inf)
    key_stamps = torch.where(imu_mask, stamps, torch.inf).contiguous()
    idx = torch.clamp(
        torch.searchsorted(key_stamps, t_offsets.contiguous(), right=True) - 1,
        0,
        stamps.shape[-1] - 1,
    )
    if idx.dim() == 1:
        def at(t):
            return t[idx]
    else:
        lane = torch.arange(idx.shape[0], device=idx.device)[:, None]

        def at(t):
            return t[lane, idx]
    dt = torch.clamp(t_offsets - at(stamps), 0.0, 0.5)
    R_t = at(Rs) @ so3.exp(at(ws) * dt[..., None])
    p_t = at(ps) + at(vs) * dt[..., None] + 0.5 * at(aws) * dt[..., None] ** 2
    spec = "nij,nj->ni" if pb.dim() == 2 else "bnij,bnj->bni"
    pw = torch.einsum(spec, R_t, pb) + p_t
    pe = (pw - x_end.p[..., None, :]) @ x_end.R
    return torch.where(pt_mask[..., None], pe, 1.0e6)
