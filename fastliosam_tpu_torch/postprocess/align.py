"""Trajectory <-> GPS alignment tools (port of
``fastliosam_tpu/postprocess/align.py``).

Capability ports of the reference post-processing:
  * timestamp matching with tolerance — `geo_ref_slam_wgs84.py:79-107`
    (host code, as in the JAX package)
  * 2D similarity (scale+R+t) Horn fit — `geo_ref_slam_wgs84.py:109-132`
    (a float64 SVD on the device)
  * timestamp-free 2D point-to-point ICP with scale —
    `align_slam_gps_icp.py:81-157` (on the device; the nearest neighbour of
    every iteration is the float64 k-NN kernel, ``ops/kneighbors_cuda.py``,
    at k = 1)

Public functions take and return numpy (``Similarity2D`` holds floats) and
run on ``device`` (``None``: ``cuda``, which raises without CUDA).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..ops.kneighbors_cuda import knn
from ..utils.device import resolve_device


def match_by_timestamp(
    stamps_a: np.ndarray, stamps_b: np.ndarray, tol: float = 0.5
):
    """For each entry of a, the nearest entry of b within ``tol`` seconds.
    Returns (idx_a, idx_b) index arrays of the matched pairs."""
    stamps_b = np.asarray(stamps_b)
    order = np.argsort(stamps_b)
    sb = stamps_b[order]
    pos = np.searchsorted(sb, stamps_a)
    idx_a, idx_b = [], []
    for i, (t, p) in enumerate(zip(stamps_a, pos)):
        cands = []
        if p > 0:
            cands.append(p - 1)
        if p < len(sb):
            cands.append(p)
        if not cands:
            continue
        best = min(cands, key=lambda c: abs(sb[c] - t))
        if abs(sb[best] - t) <= tol:
            idx_a.append(i)
            idx_b.append(order[best])
    return np.asarray(idx_a, int), np.asarray(idx_b, int)


@dataclass
class Similarity2D:
    """2D similarity: ``dst ≈ s · R(theta) · src + t`` (+ vertical offset)."""

    scale: float
    theta: float
    tx: float
    ty: float
    tz: float = 0.0

    @property
    def R(self):
        c, s = np.cos(self.theta), np.sin(self.theta)
        return np.array([[c, -s], [s, c]])

    def apply(self, xy: np.ndarray) -> np.ndarray:
        return self.scale * xy @ self.R.T + np.array([self.tx, self.ty])

    def apply_xyz(self, xyz: np.ndarray) -> np.ndarray:
        out = np.asarray(xyz, np.float64).copy()
        out[:, :2] = self.apply(out[:, :2])
        out[:, 2] += self.tz
        return out

    def to_dict(self):
        return asdict(self)

    @staticmethod
    def from_dict(d) -> "Similarity2D":
        return Similarity2D(**d)


def _apply_t(sim: Similarity2D, xy):
    """``sim.apply`` of a float64 tensor, on its device."""
    r = torch.as_tensor(sim.R, device=xy.device)
    t = torch.tensor([sim.tx, sim.ty], dtype=torch.float64, device=xy.device)
    return sim.scale * xy @ r.T + t


def _fit_t(src, dst, with_scale: bool = True) -> Similarity2D:
    """Closed-form (Umeyama/Horn) fit of float64 tensors ``(N, 2)``."""
    n = src.shape[0]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / n
    u, dvals, vt = torch.linalg.svd(cov)
    flip = bool(torch.linalg.det(u) * torch.linalg.det(vt) < 0)
    s = torch.tensor([1.0, -1.0 if flip else 1.0], dtype=torch.float64, device=src.device)
    rot = u @ torch.diag(s) @ vt
    scale = (float((dvals * s).sum() / ((xs**2).sum() / n)) if with_scale else 1.0)
    t = (mu_d - scale * rot @ mu_s).tolist()
    theta = float(torch.atan2(rot[1, 0], rot[0, 0]))
    return Similarity2D(scale=scale, theta=theta, tx=t[0], ty=t[1])


def fit_similarity_2d(
    src_xy: np.ndarray, dst_xy: np.ndarray, with_scale: bool = True, device=None
) -> Similarity2D:
    """Closed-form (Umeyama/Horn) 2D similarity fit on matched pairs."""
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(src_xy, np.float64), device=dev)
    dst = torch.as_tensor(np.asarray(dst_xy, np.float64), device=dev)
    return _fit_t(src, dst, with_scale)


def _pad_z(xy):
    """``(N, 2)`` -> ``(N, 3)`` with z = 0: the k-NN's d2 gains +0.0."""
    return torch.nn.functional.pad(xy, (0, 1)).contiguous()


def icp_2d_with_scale(
    src_xy: np.ndarray,
    dst_xy: np.ndarray,
    iters: int = 50,
    init: Similarity2D | None = None,
    trim_fraction: float = 0.9,
    device=None,
) -> tuple:
    """Timestamp-free 2D ICP with per-iteration similarity (SVD) fit.

    Returns ``(Similarity2D, rms_error)``. Capability port of
    `align_slam_gps_icp.py:81-157` (nearest-neighbor + scale SVD per iter).
    Without an ``init``, starts from centroid alignment (translation only);
    like any ICP it refines a roughly-correct rotation, it does not search
    globally. The nearest neighbour of every iteration is one launch of the
    k-NN kernel at k = 1 (ties to the lowest index, as ``np.argmin``); the
    trim is ``torch.quantile``'s linear interpolation, as ``np.quantile``'s.
    """
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(src_xy, np.float64), device=dev)
    dst = torch.as_tensor(np.asarray(dst_xy, np.float64), device=dev)
    dst3 = _pad_z(dst)
    if init is None:
        d = (dst.mean(0) - src.mean(0)).tolist()
        init = Similarity2D(1.0, 0.0, d[0], d[1])
    sim = init
    rms = np.inf
    for _ in range(iters):
        cur = _apply_t(sim, src)
        d2, nn = knn(_pad_z(cur), dst3, 1)
        dn, nn = d2[:, 0], nn[:, 0]
        if trim_fraction < 1.0:
            keep = dn <= torch.quantile(dn, trim_fraction)
        else:
            keep = torch.ones_like(dn, dtype=torch.bool)
        sim_step = _fit_t(cur[keep], dst[nn][keep])
        # compose: total = step ∘ sim
        R_tot = sim_step.R @ sim.R
        s_tot = sim_step.scale * sim.scale
        t_tot = sim_step.scale * sim_step.R @ np.array([sim.tx, sim.ty]) + np.array(
            [sim_step.tx, sim_step.ty]
        )
        sim = Similarity2D(
            scale=s_tot,
            theta=float(np.arctan2(R_tot[1, 0], R_tot[0, 0])),
            tx=float(t_tot[0]),
            ty=float(t_tot[1]),
        )
        rms = float(torch.sqrt(dn[keep].mean()))
    return sim, rms


def alignment_report(sim: Similarity2D, src_xy, dst_xy):
    """Mean/std residual report (`geo_ref_slam_wgs84.py:422-426` analog)."""
    res = np.linalg.norm(sim.apply(np.asarray(src_xy)) - np.asarray(dst_xy), axis=1)
    return {
        "mean_error_m": float(res.mean()),
        "std_error_m": float(res.std()),
        "max_error_m": float(res.max()),
        "n_pairs": int(len(res)),
    }
