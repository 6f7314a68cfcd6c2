"""The comparison that decides a run's ``correct``.

The reference (``slam_bench/reference``: plain PyTorch, importing nothing
of the program) follows the program one step from the program's own
state. After the window the harness takes one more step of the timed path
and keeps every lane's state as the step takes it; once the program's
state is freed, the reference takes the same step of each lane from that
state, on the inputs the harness gave the program, and its answers are
compared with the program's, the largest over the lanes, each judged
against its limit in ``limits/<workload>.json`` where that file names it:

- ``step_pose_gap_m``: the distance between the two positions after the
  step; ``step_rot_gap_rad``: the angle between the two attitudes;
- ``step_map_count_gap``: the points that the two maps after the step hold
  in different voxels, as a share of the reference's points
  (``Σ |count_prog - count_ref| / Σ count_ref`` over the union of the
  occupied voxels);

Of the state it takes from the program, the reference works out again
what the program derived from the rest: in the cached association mode it
refits every occupied voxel's plane from the voxel's moments before it
steps, so a plane the program refreshed wrong shows in the step's gaps.

Besides, every lane that began a clip at that step is checked word for
word against the fresh state the reference makes from the clip's start
(``reset_gap``, exact). Numbers a limits file does not name are printed on
an earlier line. A replay of a whole clip (:func:`replay`) is no such
number: rounding grows into drift on some clips (``PERF.md``).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import odometry as ro
from .reference import voxel_map as rvm

NUMBERS = ("step_pose_gap_m", "step_rot_gap_rad", "step_map_count_gap", "reset_gap")


def reference_configs(config: dict):
    """The reference's own configuration objects from a configuration file."""
    odom = {k: tuple(v) if isinstance(v, list) else v for k, v in config["odom"].items()}
    return ro.OdomConfig(**odom), rvm.VoxelMapConfig(**config["map"])


class precision:
    """Matmuls in full float32 (``tf32=False``), or in TF32: the control."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec = self.saved
        torch.set_float32_matmul_precision(prec)
        return False


def replay(feed: dict, start_scan: int, steps: int, p0, config: dict, tf32: bool = False):
    """The reference's lane from ``start_scan`` (true attitude and velocity,
    position ``p0``) over ``steps`` scans of the staged ``feed``. Returns
    ``{"R": (steps, 3, 3), "p": (steps, 3), "coords": the occupied voxels
    (k, 3), "counts": their points (k,)}``, numpy."""
    cfg, map_cfg = reference_configs(config)
    dev = feed["xyz"].device
    dt = float(feed["scan_dt"])
    Rs, ps = [], []
    with precision(tf32), torch.no_grad():
        st = ro.init_odom(map_cfg, cfg, dev, feed["R0"][start_scan].clone(),
                          torch.as_tensor(p0, dtype=torch.float32, device=dev),
                          feed["v0"][start_scan].clone())
        for k in range(start_scan, start_scan + steps):
            imu = ro.ImuBatch(feed["imu_t"][k], feed["imu_g"][k], feed["imu_a"][k],
                              feed["imu_m"][k])
            st, (R, p) = ro.odom_step(st, feed["xyz"][k], feed["toff"][k], feed["mask"][k],
                                      imu, dt, cfg, map_cfg)
            Rs.append(R)
            ps.append(p)
        occ = st.vmap.fp != 0
        return {"R": torch.stack(Rs).cpu().numpy(), "p": torch.stack(ps).cpu().numpy(),
                "coords": st.vmap.coords[occ].cpu().numpy(),
                "counts": st.vmap.moments[occ, 0].cpu().numpy()}


def _keys(coords: np.ndarray) -> np.ndarray:
    c = coords.astype(np.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def count_gap(coords_a, counts_a, coords_b, counts_b) -> float:
    """``Σ |count_a - count_b| / Σ count_b`` over the union of the voxels."""
    ka, kb = _keys(coords_a), _keys(coords_b)
    keys = np.union1d(ka, kb)
    ca = np.zeros(len(keys))
    cb = np.zeros(len(keys))
    ca[np.searchsorted(keys, ka)] = counts_a
    cb[np.searchsorted(keys, kb)] = counts_b
    return float(np.abs(ca - cb).sum() / max(cb.sum(), 1.0))


def rot_gap(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angles (rad) between rotation stacks, from the chord: robust near 0."""
    chord = np.linalg.norm((Ra.astype(np.float64) - Rb.astype(np.float64)).reshape(
        len(Ra), -1), axis=-1)
    return 2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def step_from(feed: dict, scan: int, lane_state: list, config: dict, tf32: bool = False):
    """One reference step of scan ``scan`` from a lane's state as the
    program held it (its words in ``Fleet.lane_state``'s order): ``{"R",
    "p", "coords", "counts"}`` after the step, numpy."""
    cfg, map_cfg = reference_configs(config)
    nav = ro.NavState(*lane_state[:9])
    vmap = rvm.VoxelMap(*lane_state[9:15])
    scan_idx, initialized, w_cv = lane_state[15:]
    with precision(tf32), torch.no_grad():
        if cfg.query_mode == "cached":
            vmap = rvm.refit_planes(vmap, map_cfg)
        st = ro.OdomState(nav, vmap, int(scan_idx), bool(initialized), w_cv)
        imu = ro.ImuBatch(feed["imu_t"][scan], feed["imu_g"][scan], feed["imu_a"][scan],
                          feed["imu_m"][scan])
        st, (R, p) = ro.odom_step(st, feed["xyz"][scan], feed["toff"][scan], feed["mask"][scan],
                                  imu, float(feed["scan_dt"]), cfg, map_cfg)
        occ = st.vmap.fp != 0
        return {"R": R.cpu().numpy(), "p": p.cpu().numpy(),
                "coords": st.vmap.coords[occ].cpu().numpy(),
                "counts": st.vmap.moments[occ, 0].cpu().numpy()}


def fresh_gap(feed: dict, start_scan: int, p0, lane_state: list, config: dict) -> float:
    """The largest difference between a lane's state as the program took its
    first step of a clip (``Fleet.lane_state``'s words) and the fresh state
    the reference makes for that clip: 0 where every word is equal."""
    cfg, map_cfg = reference_configs(config)
    dev = feed["xyz"].device
    ref = ro.init_odom(map_cfg, cfg, dev, feed["R0"][start_scan],
                       torch.as_tensor(p0, dtype=torch.float32, device=dev),
                       feed["v0"][start_scan])
    want = [*ref.nav, *ref.vmap, torch.tensor(ref.scan_idx), torch.tensor(ref.initialized),
            ref.w_cv]
    return max(float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())))
               if a.numel() else 0.0 for a, b in zip(lane_state, want))


def compare_step(program: dict, reference: dict) -> dict:
    """The numbers of one step taken from the program's own lane state."""
    return {
        "step_pose_gap_m": float(np.linalg.norm(
            program["p"].astype(np.float64) - reference["p"])),
        "step_rot_gap_rad": float(rot_gap(program["R"][None], reference["R"][None])[0]),
        "step_map_count_gap": count_gap(program["coords"], program["counts"],
                                        reference["coords"], reference["counts"]),
    }
