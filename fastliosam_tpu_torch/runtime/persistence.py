"""Result export and checkpoint/resume (port of
``fastliosam_tpu/runtime/persistence.py``).

Export parity with the reference's ``saveFlagCallback``
(`fast_lio_sam.cpp:805-939`): KITTI pose file, TUM trajectory, full
corrected map as binary PCD, and a per-keyframe bundle (the "map
checkpoint" consumed by the localizer, `config.yaml:21`, as an .npz).

The checkpoint round-trips the full engine state (nav state, voxel map,
keyframe store, factor graph, realtime-correction anchors) through one
compressed .npz. Keys, shapes and dtypes are the JAX package's, so a
checkpoint or keyframe bundle written by either package loads into the
other; the port's host-side odometry counters (``scan_idx``,
``initialized``) are written as the JAX package's int32 and bool scalars.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..io.pcd import write_pcd
from ..io.poses import write_kitti_poses, write_tum_trajectory
from ..utils.sync import host_read
from .engine import SlamEngine

# host values of the port's odometry state, as the JAX package stores them
_HOST_SCALARS = {"odom.scan_idx": np.int32, "odom.initialized": np.bool_}


def _np(val):
    """A device tensor or host value as a numpy array (tensors: one read)."""
    return host_read(val) if isinstance(val, torch.Tensor) else np.asarray(val)


def save_results(engine: SlamEngine, out_dir: str, seq_name: str = "seq",
                 map_voxel: float = 0.3) -> dict:
    """Write KITTI + TUM trajectories, the corrected global map PCD, the
    viewer and the keyframe bundle. Returns the written paths."""
    from ..postprocess.viewer3d import write_map_viewer

    os.makedirs(out_dir, exist_ok=True)
    engine.finish()
    paths = {}
    n = engine.kf.n
    kf_poses = engine.keyframe_poses()
    kf_stamps = engine.keyframe_stamps()

    p = os.path.join(out_dir, f"{seq_name}_kitti.txt")
    write_kitti_poses(p, kf_poses)
    paths["kitti"] = p

    p = os.path.join(out_dir, f"{seq_name}_tum.txt")
    write_tum_trajectory(p, kf_stamps, kf_poses)
    paths["tum"] = p

    p = os.path.join(out_dir, f"{seq_name}_scans_tum.txt")
    write_tum_trajectory(p, engine.scan_stamps, np.stack(engine.realtime_traj))
    paths["tum_scans"] = p

    pts = engine.assemble_map(voxel=map_voxel)
    p = os.path.join(out_dir, f"{seq_name}_map.pcd")
    write_pcd(p, pts.astype(np.float32))
    paths["map_pcd"] = p

    p = os.path.join(out_dir, f"{seq_name}_viewer.html")
    write_map_viewer(p, pts, trajectory=kf_poses[:, :3, 3], loop_pairs=engine.loop_pairs,
                     title=seq_name)
    paths["viewer"] = p

    # keyframe bundle (the rosbag-of-keyframes analog, for relocalization)
    p = os.path.join(out_dir, f"{seq_name}_keyframes.npz")
    np.savez_compressed(p, poses=kf_poses, stamps=kf_stamps,
                        clouds=_np(engine.kf.clouds[:n]), masks=_np(engine.kf.masks[:n]))
    paths["keyframes"] = p

    meta = {
        "n_keyframes": int(n),
        "n_scans": engine.scan_count,
        "n_loops": len(engine.loop_pairs),
        "n_gps_factors": int(_np(engine.graph.n_gps)),
        "loop_pairs": engine.loop_pairs,
    }
    p = os.path.join(out_dir, f"{seq_name}_meta.json")
    with open(p, "w") as f:
        json.dump(meta, f, indent=2)
    paths["meta"] = p
    return paths


def _tree_to_dict(prefix: str, tree) -> dict:
    out = {}
    for name, val in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(val, "_asdict"):
            out.update(_tree_to_dict(key, val))
        elif key in _HOST_SCALARS:
            out[key] = np.asarray(val, _HOST_SCALARS[key])
        else:
            out[key] = _np(val)
    return out


def save_checkpoint(engine: SlamEngine, path: str) -> None:
    """Snapshot the complete engine state into one compressed npz. Resolve
    the chunks in flight first (``engine.finish()``): their scans are not
    in the engine's host state yet."""
    if engine._pending_chunks:
        raise RuntimeError("chunks are still in flight: call engine.finish() first")
    blob = {}
    blob.update(_tree_to_dict("odom", engine.odom))
    blob.update(_tree_to_dict("graph", engine.graph))
    for name in ("clouds", "masks", "raw_poses", "stamps"):
        blob[f"kf.{name}"] = _np(getattr(engine.kf, name))
    blob["kf.n"] = np.asarray(engine.kf.n)
    blob["rt.last_kf_raw"] = _np(engine.last_kf_raw)
    blob["rt.last_kf_corrected"] = _np(engine.last_kf_corrected)
    blob["rt.scan_count"] = np.asarray(engine.scan_count)
    blob["rt.traj_len"] = np.asarray(engine.traj_len)
    blob["rt.loop_pairs"] = np.asarray(engine.loop_pairs or np.zeros((0, 2), int))
    blob["rt.raw_traj"] = np.asarray(engine.raw_traj)
    blob["rt.realtime_traj"] = np.asarray(engine.realtime_traj)
    blob["rt.scan_stamps"] = np.asarray(engine.scan_stamps)
    blob["rt.solve_count"] = np.asarray(engine.solve_count)
    np.savez_compressed(path, **blob)


def _fill_tree(tree, blob, prefix, device):
    kwargs = {}
    for name, val in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(val, "_asdict"):
            kwargs[name] = _fill_tree(val, blob, key, device)
        elif isinstance(val, torch.Tensor):
            kwargs[name] = torch.from_numpy(np.array(blob[key], copy=True)).to(device)
        else:  # a host value of the port (scan_idx, initialized)
            kwargs[name] = type(val)(blob[key])
    return type(tree)(**kwargs)


def load_checkpoint(engine: SlamEngine, path: str) -> SlamEngine:
    """Restore a checkpoint into an engine of the same configs (tensors on
    the engine's device). Returns the engine for chaining.

    Besides the saved state, it resets what is derived from it, as the JAX
    package does (the factor counters of the capacity policy, the loop
    dedup watermark, the capacities that may have grown before the save,
    the step-distance origin), and the port's own state: the device
    keyframe counter, the chunks and loop verifications in flight, a
    pending solve and the per-scan match counts. Segment plans
    (``core/segment.py``) are made per call, and the host-read and launch
    counters are process-wide diagnostics, so neither holds engine state."""
    dev = engine.device
    blob = np.load(path)

    def t(key):
        return torch.from_numpy(np.array(blob[key], copy=True)).to(dev)

    engine.odom = _fill_tree(engine.odom, blob, "odom", dev)
    engine.graph = _fill_tree(engine.graph, blob, "graph", dev)
    engine.kf.clouds, engine.kf.masks = t("kf.clouds"), t("kf.masks")
    engine.kf.raw_poses, engine.kf.stamps = t("kf.raw_poses"), t("kf.stamps")
    engine.kf.n = int(blob["kf.n"])
    engine.last_kf_raw = np.asarray(blob["rt.last_kf_raw"], np.float32)
    engine.last_kf_corrected = np.asarray(blob["rt.last_kf_corrected"], np.float32)
    engine.scan_count = int(blob["rt.scan_count"])
    engine.traj_len = float(blob["rt.traj_len"])
    engine.loop_pairs = [tuple(int(v) for v in p) for p in blob["rt.loop_pairs"]]
    engine.raw_traj = list(blob["rt.raw_traj"])
    engine.realtime_traj = list(blob["rt.realtime_traj"])
    engine.scan_stamps = [float(s) for s in blob["rt.scan_stamps"]]
    engine.solve_count = int(blob["rt.solve_count"])
    # process() measures step distance in the raw odometry frame
    engine._last_p = np.asarray(engine.raw_traj[-1])[:3, 3] if engine.raw_traj else None
    # derived host state: factor counters, loop dedup watermark, capacities
    engine._n_bt_host = int(blob["graph.n_bt"])
    engine._n_gps_host = int(blob["graph.n_gps"])
    engine._loop_processed_kf = max(engine.kf.n - 1, 0)
    engine.pgo_cfg = engine.pgo_cfg._replace(
        max_keyframes=int(engine.graph.poses.shape[0]),
        max_between=int(engine.graph.bt_i.shape[0]),
        max_gps=int(engine.graph.gps_idx.shape[0]),
    )
    # the port's own state: the host counter is authoritative after a
    # restore, and nothing is in flight
    engine._kf_n_dev = None
    engine._pending_chunks = []
    engine._pending_loops = []
    engine._needs_solve = False
    engine.match_counts = []
    return engine
