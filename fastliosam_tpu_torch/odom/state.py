"""Navigation state and error-state utilities for the iterated ESKF (port of
``fastliosam_tpu/odom/state.py``).

24-dim error state ``[dθ(0:3), dp(3:6), dv(6:9), dbg(9:12), dba(12:15),
dg(15:18), dθ_ext(18:21), dt_ext(21:24)]``, right-perturbation rotations.
``OdomConfig`` has the JAX package's fields and defaults (see its
docstrings there for the measured reasons behind each default).

A batched state (the batched rollout, ``eval/batch_eval.py``) is a
``NavState`` whose every field has a leading lane dim ``B``
(``init_state(..., lanes=B)``); :func:`boxplus` and :func:`boxminus` take
either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import so3
from ..utils.device import resolve_device

STATE_DIM = 24
GRAVITY = 9.81


class OdomConfig(NamedTuple):
    """Odometry configuration (FAST-LIO parameter surface)."""

    acc_cov: float = 0.1
    gyr_cov: float = 0.1
    b_acc_cov: float = 0.0001
    b_gyr_cov: float = 0.0001
    init_vel_cov: float = 0.01
    max_iteration: int = 3
    point_cov: float = 0.001
    max_residual: float = 1.0
    # "merged" (7-voxel stencil) or "merged3" in this port; "merged2" and
    # "cached" are later slices
    query_mode: str = "merged"
    requery_iters: int = 1
    requery_thresh: float = 0.125
    blind: float = 1.0
    point_filter_num: int = 4
    filter_size_surf: float = 0.5
    det_range: float = 300.0
    extrinsic_T: tuple = (0.0, 0.0, 0.0)
    extrinsic_R: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    extrinsic_est_en: bool = False
    extrinsic_prior_cov: float = 1e-4
    max_imu_per_scan: int = 32
    num_ds_points: int = 8192
    evict_every: int = 50
    init_gravity_samples: int = 10
    cv_rot_cov: float = 0.05
    cv_pos_cov: float = 0.5
    cv_vel_cov: float = 5.0
    cv_max_rate: float = 2.0
    cv_vel_alpha: float = 0.5
    degen_rel_thresh: float = 5e-3
    degen_conf_ratio: float = 1.0

    def ext_R(self, device=None):
        return torch.tensor(self.extrinsic_R, dtype=torch.float32,
                            device=device).reshape(3, 3)

    def ext_T(self, device=None):
        return torch.tensor(self.extrinsic_T, dtype=torch.float32, device=device)


class NavState(NamedTuple):
    R: torch.Tensor  # (3, 3) body(IMU)->world
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    g: torch.Tensor  # (3,) gravity in the world frame
    R_ext: torch.Tensor  # (3, 3) LiDAR -> IMU rotation
    t_ext: torch.Tensor  # (3,) LiDAR -> IMU translation
    P: torch.Tensor  # (24, 24) error covariance


def init_state(g_world=None, cfg: OdomConfig | None = None, device=None,
               lanes: int | None = None) -> NavState:
    """The initial state; with ``lanes``, ``lanes`` copies of it stacked
    along a leading lane dim."""
    if lanes is not None:
        one = init_state(g_world, cfg, device)
        return NavState(*(t.expand((lanes,) + tuple(t.shape)).clone() for t in one))
    dev = resolve_device(device)
    cfg = cfg or OdomConfig()
    if g_world is None:
        g_world = torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float32, device=dev)
    ext_cov = cfg.extrinsic_prior_cov if cfg.extrinsic_est_en else 1e-12
    diag = (
        [1e-4] * 3  # attitude
        + [1e-8] * 3  # position (anchored)
        + [cfg.init_vel_cov] * 3
        + [1e-4] * 3  # bg
        + [1e-3] * 3  # ba
        + [1e-4] * 3  # gravity
        + [ext_cov] * 6  # extrinsic (frozen when disabled)
    )
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    return NavState(
        R=torch.eye(3, dtype=torch.float32, device=dev),
        p=z3.clone(),
        v=z3.clone(),
        bg=z3.clone(),
        ba=z3.clone(),
        g=torch.as_tensor(g_world, dtype=torch.float32).to(dev),
        R_ext=cfg.ext_R(dev),
        t_ext=cfg.ext_T(dev),
        P=torch.diag(torch.tensor(diag, dtype=torch.float32, device=dev)),
    )


def boxplus(x: NavState, dx) -> NavState:
    """Apply a 24-dim error-state increment (``(B, 24)`` to a batched
    state)."""
    return x._replace(
        R=so3.normalize_matrix(x.R @ so3.exp(dx[..., 0:3])),
        p=x.p + dx[..., 3:6],
        v=x.v + dx[..., 6:9],
        bg=x.bg + dx[..., 9:12],
        ba=x.ba + dx[..., 12:15],
        g=x.g + dx[..., 15:18],
        R_ext=so3.normalize_matrix(x.R_ext @ so3.exp(dx[..., 18:21])),
        t_ext=x.t_ext + dx[..., 21:24],
    )


def matvec(M, v):
    """``M v`` for one matrix (``mv``, the unbatched kernel) or for a stack
    of them (a batched product)."""
    return M @ v if M.dim() == 2 else (M @ v[..., None])[..., 0]


def boxminus(a: NavState, b: NavState):
    """24-dim error a ⊟ b (so that b ⊞ (a ⊟ b) == a); ``(B, 24)`` for
    batched states."""
    return torch.cat(
        [
            so3.log(b.R.mT @ a.R),
            a.p - b.p,
            a.v - b.v,
            a.bg - b.bg,
            a.ba - b.ba,
            a.g - b.g,
            so3.log(b.R_ext.mT @ a.R_ext),
            a.t_ext - b.t_ext,
        ],
        dim=-1,
    )
