"""Trajectory evaluation: ATE / RPE with optional Umeyama alignment.

The quantitative replacement for the reference's visual-only validation
(SURVEY.md §4); ATE definitions follow the TUM RGB-D benchmark convention.
"""
from __future__ import annotations

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst.

    ``src, dst (N, 3)``. Returns ``(s, R, t)`` with ``dst ≈ s R src + t``.
    (Same math as the reference's Horn 2D fit in
    `post_process/geo_ref_slam_wgs84.py:109-132`, in 3D.)
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_pos: np.ndarray,
    gt_pos: np.ndarray,
    align: bool = False,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE over matched positions (N, 3).

    ``align=True`` removes the best rigid (or similarity, with
    ``with_scale``) transform first, TUM-benchmark style.
    """
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    if align:
        s, R, t = align_umeyama(est, gt, with_scale=with_scale)
        est = est @ (s * R).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over a frame gap: returns (trans_rmse, rot_rmse_rad)."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = len(est) - delta
    terr, rerr = [], []
    for i in range(n):
        e_rel = np.linalg.inv(est[i]) @ est[i + delta]
        g_rel = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(g_rel) @ e_rel
        terr.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(abs(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )
