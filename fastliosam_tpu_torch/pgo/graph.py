"""Factor-graph storage as fixed-capacity structures of tensors (port of
``fastliosam_tpu/pgo/graph.py``).

Keyframe poses and three factor families (prior, between, GPS unary) as
padded tensors with validity masks. The counters ``n_kf``/``n_bt``/
``n_gps`` stay on the device, and the ``add_*`` functions are masked
no-ops at capacity, as in the JAX package, so adding never syncs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device


class PoseGraphConfig(NamedTuple):
    max_keyframes: int = 512
    max_between: int = 1024
    max_gps: int = 256
    lm_iters: int = 6
    pcg_iters: int = 64
    lambda_init: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    linear_solver: str = "auto"  # "auto" = "pcg"; "dense" factorizes
    prior_sqrt_info: float = 1e3
    marginal_pcg_iters: int = 256
    gps_huber_delta: float = 0.0
    loop_huber_delta: float = 0.0
    loop_gnc_barc: float = 0.0
    gnc_stages: int = 6
    gnc_div: float = 0.0
    gnc_hop_trans_var: float = 0.01
    gnc_hop_rot_var: float = 1e-4


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4)
    kf_valid: torch.Tensor  # (K,) bool
    n_kf: torch.Tensor  # int32
    bt_i: torch.Tensor  # (F,) int32
    bt_j: torch.Tensor  # (F,) int32
    bt_rel: torch.Tensor  # (F, 4, 4) measured Z
    bt_sqrt_info: torch.Tensor  # (F, 6) diagonal sqrt information
    bt_valid: torch.Tensor  # (F,) bool
    n_bt: torch.Tensor  # int32
    gps_idx: torch.Tensor  # (G,) int32
    gps_xyz: torch.Tensor  # (G, 3)
    gps_sqrt_info: torch.Tensor  # (G, 3)
    gps_valid: torch.Tensor  # (G,) bool
    n_gps: torch.Tensor  # int32


def make_graph(cfg: PoseGraphConfig, device=None) -> PoseGraph:
    dev = resolve_device(device)
    K, F, G = cfg.max_keyframes, cfg.max_between, cfg.max_gps
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    eye = torch.eye(4, **f32)
    return PoseGraph(
        poses=eye.repeat(K, 1, 1),
        kf_valid=torch.zeros((K,), **b),
        n_kf=torch.zeros((), **i32),
        bt_i=torch.zeros((F,), **i32),
        bt_j=torch.zeros((F,), **i32),
        bt_rel=eye.repeat(F, 1, 1),
        bt_sqrt_info=torch.zeros((F, 6), **f32),
        bt_valid=torch.zeros((F,), **b),
        n_bt=torch.zeros((), **i32),
        gps_idx=torch.zeros((G,), **i32),
        gps_xyz=torch.zeros((G, 3), **f32),
        gps_sqrt_info=torch.zeros((G, 3), **f32),
        gps_valid=torch.zeros((G,), **b),
        n_gps=torch.zeros((), **i32),
    )


def from_arrays(cfg: PoseGraphConfig, poses, bt_i=None, bt_j=None, bt_rel=None,
                bt_sqrt_info=None, gps_idx=None, gps_xyz=None,
                gps_sqrt_info=None, device=None) -> PoseGraph:
    """Bulk-construct a graph from arrays."""
    g = make_graph(cfg, device)
    dev = g.poses.device

    def put(arr, vals, dtype):
        out = arr.clone()
        out[: len(vals)] = torch.as_tensor(np.array(vals), dtype=dtype).to(dev)
        return out

    n = len(poses)
    if n > cfg.max_keyframes:
        raise ValueError("more poses than max_keyframes")
    g = g._replace(
        poses=put(g.poses, poses, torch.float32),
        kf_valid=put(g.kf_valid, [True] * n, torch.bool),
        n_kf=torch.tensor(n, dtype=torch.int32, device=dev),
    )
    if bt_i is not None:
        f = len(bt_i)
        if f > cfg.max_between:
            raise ValueError("more between factors than max_between")
        g = g._replace(
            bt_i=put(g.bt_i, bt_i, torch.int32),
            bt_j=put(g.bt_j, bt_j, torch.int32),
            bt_rel=put(g.bt_rel, bt_rel, torch.float32),
            bt_sqrt_info=put(g.bt_sqrt_info, bt_sqrt_info, torch.float32),
            bt_valid=put(g.bt_valid, [True] * f, torch.bool),
            n_bt=torch.tensor(f, dtype=torch.int32, device=dev),
        )
    if gps_idx is not None:
        q = len(gps_idx)
        if q > cfg.max_gps:
            raise ValueError("more GPS factors than max_gps")
        g = g._replace(
            gps_idx=put(g.gps_idx, gps_idx, torch.int32),
            gps_xyz=put(g.gps_xyz, gps_xyz, torch.float32),
            gps_sqrt_info=put(g.gps_sqrt_info, gps_sqrt_info, torch.float32),
            gps_valid=put(g.gps_valid, [True] * q, torch.bool),
            n_gps=torch.tensor(q, dtype=torch.int32, device=dev),
        )
    return g


def grow(g: PoseGraph, cfg_new: PoseGraphConfig) -> PoseGraph:
    """Re-allocate a graph at larger capacities, preserving all contents."""
    g2 = make_graph(cfg_new, g.poses.device)
    out = {}
    for name in PoseGraph._fields:
        old, new = getattr(g, name), getattr(g2, name)
        if old.dim() == 0:
            out[name] = old
            continue
        if new.shape[0] < old.shape[0]:
            raise ValueError("grow() cannot shrink a graph")
        new = new.clone()
        new[: old.shape[0]] = old
        out[name] = new
    return PoseGraph(**out)


def _append(arr, count, val, when=None):
    """``arr`` with ``val`` written at row ``count`` when it is in capacity
    and ``when`` (a device bool, default true) holds — a masked no-op
    otherwise; returns ``(arr, written)``."""
    cap = arr.shape[0]
    in_cap = count < cap
    if when is not None:
        in_cap = in_cap & when
    # a 1-element index tensor: indexing with a 0-dim one reads it back
    c = torch.clamp(count, 0, cap - 1).to(torch.int64).reshape(1)
    if isinstance(val, torch.Tensor):
        row = val.to(arr.dtype).expand(arr.shape[1:])
    else:  # a Python scalar: a fill on the device, no upload
        row = torch.full(arr.shape[1:], val, dtype=arr.dtype, device=arr.device)
    upd = arr.index_copy(0, c, row[None])
    return torch.where(in_cap, upd, arr), in_cap


def add_keyframe(g: PoseGraph, pose, when=None) -> PoseGraph:
    """Append a keyframe pose (no-op when at capacity or where the device
    bool ``when`` is false)."""
    poses, in_cap = _append(g.poses, g.n_kf, pose, when)
    kf_valid, _ = _append(g.kf_valid, g.n_kf, True, when)
    return g._replace(poses=poses, kf_valid=kf_valid,
                      n_kf=g.n_kf + in_cap.to(torch.int32))


def set_pose(g: PoseGraph, idx, pose) -> PoseGraph:
    poses = g.poses.clone()
    poses[idx] = pose
    return g._replace(poses=poses)


def add_between(g: PoseGraph, i, j, rel, sqrt_info, when=None) -> PoseGraph:
    f = g.n_bt
    bt_i, in_cap = _append(g.bt_i, f, i, when)
    return g._replace(
        bt_i=bt_i,
        bt_j=_append(g.bt_j, f, j, when)[0],
        bt_rel=_append(g.bt_rel, f, rel, when)[0],
        bt_sqrt_info=_append(g.bt_sqrt_info, f, sqrt_info, when)[0],
        bt_valid=_append(g.bt_valid, f, True, when)[0],
        n_bt=f + in_cap.to(torch.int32),
    )


def add_gps(g: PoseGraph, idx, xyz, sqrt_info) -> PoseGraph:
    f = g.n_gps
    gps_idx, in_cap = _append(g.gps_idx, f, idx)
    return g._replace(
        gps_idx=gps_idx,
        gps_xyz=_append(g.gps_xyz, f, xyz)[0],
        gps_sqrt_info=_append(g.gps_sqrt_info, f, sqrt_info)[0],
        gps_valid=_append(g.gps_valid, f, True)[0],
        n_gps=f + in_cap.to(torch.int32),
    )
