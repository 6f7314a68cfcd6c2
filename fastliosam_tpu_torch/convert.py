"""State handoff from the JAX package to the port.

Each function takes the JAX package's state as host arrays — a
NamedTuple or dict of ``np.ndarray`` (``np.asarray`` of each JAX field) —
and returns the port's tensors on ``device``. No JAX is needed: the caller
does the ``np.asarray``. The tests use this to put both implementations
into the same state mid-run.
"""
from __future__ import annotations

import numpy as np
import torch

from .map.voxel_hash import VoxelMap
from .odom.pipeline import OdomState
from .odom.state import NavState
from .pgo.graph import PoseGraph
from .runtime.engine import KeyframeStore
from .utils.device import resolve_device


def _fields(src, names):
    if isinstance(src, dict):
        return {n: src[n] for n in names}
    return {n: getattr(src, n) for n in names}


def _tensors(cls, src, device):
    dev = resolve_device(device)
    return cls(**{
        name: torch.from_numpy(np.array(val, copy=True)).to(dev)
        for name, val in _fields(src, cls._fields).items()
    })


def voxel_map_from_numpy(m, device=None) -> VoxelMap:
    return _tensors(VoxelMap, m, device)


def nav_state_from_numpy(nav, device=None) -> NavState:
    return _tensors(NavState, nav, device)


def odom_state_from_numpy(state, device=None) -> OdomState:
    """``scan_idx`` and ``initialized`` become host values (the port keeps
    them on the host)."""
    f = _fields(state, OdomState._fields)
    dev = resolve_device(device)
    return OdomState(
        nav=nav_state_from_numpy(f["nav"], dev),
        vmap=voxel_map_from_numpy(f["vmap"], dev),
        scan_idx=int(np.asarray(f["scan_idx"])),
        initialized=bool(np.asarray(f["initialized"])),
        w_cv=torch.from_numpy(np.array(f["w_cv"], np.float32, copy=True)).to(dev),
    )


def pose_graph_from_numpy(g, device=None) -> PoseGraph:
    return _tensors(PoseGraph, g, device)


def keyframes_from_numpy(kf, device=None) -> KeyframeStore:
    """A KeyframeStore from ``clouds``, ``masks``, ``raw_poses``,
    ``stamps`` and the host count ``n``."""
    f = _fields(kf, ("clouds", "masks", "raw_poses", "stamps", "n"))
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(f[name], copy=True)).to(dev)

    return KeyframeStore(clouds=t("clouds"), masks=t("masks"),
                         raw_poses=t("raw_poses"), stamps=t("stamps"), n=int(f["n"]))
