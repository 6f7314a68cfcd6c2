"""State handoff from the JAX package to the port.

Each function takes the JAX package's state as host arrays — a
NamedTuple or dict of ``np.ndarray`` (``np.asarray`` of each JAX field) —
and returns the port's tensors on ``device``. No JAX is needed: the caller
does the ``np.asarray``. The tests use this to put both implementations
into the same state mid-run. :func:`odom_state_to_numpy` goes back, so a
state can return to the JAX package (``OdomState(nav=NavState(**d["nav"]),
vmap=VoxelMap(**d["vmap"]), ...)`` there). In mesh mode
:func:`voxel_map_shard_from_numpy` and :func:`pose_graph_shard_from_numpy`
cut a rank's shard from a whole JAX map or graph, and :func:`gather_map`
puts a slot-sharded map back together.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.geodesy import LocalCartesian
from .map.voxel_hash import VoxelMap
from .odom.pipeline import OdomState
from .odom.state import NavState
from .pgo.graph import PoseGraph
from .runtime.engine import KeyframeStore, SlamEngine
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
    them on the host). A batched state, the JAX package's stacked pytree
    (``eval/batch_eval.py: stack_states``, its leaves with a leading lane
    dim B: ``scan_idx`` and ``initialized`` of shape ``(B,)``), becomes the
    port's batched state: every leaf a tensor with that lane dim,
    ``scan_idx`` int32 and ``initialized`` bool on ``device``."""
    f = _fields(state, OdomState._fields)
    dev = resolve_device(device)
    scan_idx, initialized = np.asarray(f["scan_idx"]), np.asarray(f["initialized"])
    if scan_idx.ndim == 1:
        scan_idx = torch.from_numpy(scan_idx.astype(np.int32)).to(dev)
        initialized = torch.from_numpy(initialized.astype(bool)).to(dev)
    else:
        scan_idx, initialized = int(scan_idx), bool(initialized)
    return OdomState(
        nav=nav_state_from_numpy(f["nav"], dev),
        vmap=voxel_map_from_numpy(f["vmap"], dev),
        scan_idx=scan_idx,
        initialized=initialized,
        w_cv=torch.from_numpy(np.array(f["w_cv"], np.float32, copy=True)).to(dev),
    )


def odom_state_to_numpy(state: OdomState) -> dict:
    """The port's state (unbatched or batched) as the JAX package's leaves
    in numpy: a dict of ``nav`` and ``vmap`` (dicts of arrays by field),
    ``scan_idx`` (int32), ``initialized`` (bool) and ``w_cv``; host values
    become 0-dim arrays. :func:`odom_state_from_numpy` inverts it exactly."""
    def arr(t, dtype=None):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, dtype=dtype)

    return {
        "nav": {k: arr(v) for k, v in state.nav._asdict().items()},
        "vmap": {k: arr(v) for k, v in state.vmap._asdict().items()},
        "scan_idx": arr(state.scan_idx, np.int32),
        "initialized": arr(state.initialized, bool),
        "w_cv": arr(state.w_cv),
    }


def pose_graph_from_numpy(g, device=None) -> PoseGraph:
    return _tensors(PoseGraph, g, device)


def voxel_map_shard_from_numpy(m, mesh) -> VoxelMap:
    """This rank's slot range of a whole JAX ``VoxelMap`` given as numpy,
    on the rank's device (``parallel/sharded_map.py``'s layout: rank d holds
    slots ``[d·C/n, (d+1)·C/n)``)."""
    from .parallel.sharded_odom import shard_map_arrays

    return shard_map_arrays(voxel_map_from_numpy(m, "cpu"), mesh)


def pose_graph_shard_from_numpy(g, mesh) -> PoseGraph:
    """This rank's factor rows of a whole JAX ``PoseGraph`` given as numpy
    (padded to a multiple of the mesh, as ``solve_sharded`` pads them), the
    poses whole, on the rank's device."""
    from .parallel.sharded_pgo import shard_factors

    return shard_factors(pose_graph_from_numpy(g, "cpu"), mesh)


def gather_map(m_shard: VoxelMap, mesh) -> dict:
    """The whole slot-sharded map as numpy, a dict of arrays by field (the
    JAX package's ``VoxelMap`` leaves), on every rank: one all-gather a
    field. Every rank must call it."""
    return {k: mesh.all_gather(v).reshape((-1,) + tuple(v.shape[1:])).cpu().numpy()
            for k, v in m_shard._asdict().items()}


def keyframes_from_numpy(kf, device=None) -> KeyframeStore:
    """A KeyframeStore from ``clouds``, ``masks``, ``raw_poses``,
    ``stamps`` and the host count ``n``."""
    f = _fields(kf, ("clouds", "masks", "raw_poses", "stamps", "n"))
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(f[name], copy=True)).to(dev)

    return KeyframeStore(clouds=t("clouds"), masks=t("masks"),
                         raw_poses=t("raw_poses"), stamps=t("stamps"), n=int(f["n"]))


def local_cartesian_from_numpy(lc, device=None) -> LocalCartesian:
    """A LocalCartesian from ``origin_ecef`` and ``rot`` (float32)."""
    return _tensors(LocalCartesian, lc, device)


_GPS_HOST_FIELDS = ("gps_slam_offset", "last_gps_factor_pos", "traj_len", "_n_gps_host",
                    "_cov6", "_cov_solved_kf", "_cov_solved_p", "_cov_solved_trajlen")


def copy_gps_state(src, engine: SlamEngine) -> SlamEngine:
    """Put the GPS state of ``src`` (a JAX engine, or anything with the same
    attributes, arrays as numpy) into the port's ``engine``: the ENU
    anchor, the warmup buffer, the fusion queue, the last factor position,
    the path length and the pose-covariance gate's solve record. Returns
    ``engine``."""
    anchor = src.gps_anchor
    engine.gps_anchor = None if anchor is None else local_cartesian_from_numpy(
        {"origin_ecef": np.asarray(anchor.origin_ecef), "rot": np.asarray(anchor.rot)},
        device="cpu")
    engine._gps_warmup = None if src._gps_warmup is None else [
        (ts, np.asarray(enu), np.asarray(noise)) for ts, enu, noise in src._gps_warmup]
    engine.gps_queue = [(ts, np.asarray(enu), np.asarray(noise))
                        for ts, enu, noise in src.gps_queue]
    for name in _GPS_HOST_FIELDS:
        val = getattr(src, name)
        setattr(engine, name, None if val is None else (
            np.array(val) if isinstance(val, np.ndarray) or hasattr(val, "shape") else val))
    return engine
