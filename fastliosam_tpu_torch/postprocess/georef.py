"""Georeferencing: apply fitted alignments to trajectories and PCD maps
(port of ``fastliosam_tpu/postprocess/georef.py``).

Capability ports of `geo_ref_slam_wgs84.py:360-427` (trajectory -> WGS84)
and `georeference_pcd.py` (apply saved similarity params to a full PCD,
preserving all fields). The geodesy is the port's float32
``LocalCartesian`` on the device, as the JAX package runs its own in
float32.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..core.geodesy import LocalCartesian
from ..io.pcd import read_pcd, with_xyz, write_pcd, xyz_of
from ..utils.device import resolve_device
from .align import Similarity2D, fit_similarity_2d, match_by_timestamp


def save_alignment_params(path: str, sim: Similarity2D, extra: dict | None = None):
    d = sim.to_dict()
    if extra:
        d.update(extra)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def load_alignment_params(path: str) -> Similarity2D:
    with open(path) as f:
        d = json.load(f)
    keys = {"scale", "theta", "tx", "ty", "tz"}
    return Similarity2D(**{k: v for k, v in d.items() if k in keys})


def georeference_trajectory(
    slam_stamps,
    slam_positions,  # (N, 3) SLAM frame
    gps_stamps,
    gps_lat,
    gps_lon,
    gps_alt=None,
    tol: float = 0.5,
    device=None,
):
    """Fit the SLAM->ENU similarity from timestamp-matched pairs, then emit
    WGS84 lat/lon for every SLAM position.

    Returns ``(lat, lon, Similarity2D, report)``; the primary
    georeferencing pipeline (`geo_ref_slam_wgs84.py` main_pipeline).
    """
    dev = resolve_device(device)
    gps_alt = np.zeros_like(gps_lat) if gps_alt is None else np.asarray(gps_alt)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    anchor = LocalCartesian.from_origin(f32(gps_lat[0]), f32(gps_lon[0]), f32(gps_alt[0]))
    enu = anchor.forward(f32(gps_lat), f32(gps_lon), f32(gps_alt)).cpu().numpy()
    ia, ib = match_by_timestamp(np.asarray(slam_stamps), np.asarray(gps_stamps), tol)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} timestamp matches (need >= 3)")
    pos = np.asarray(slam_positions)
    sim = fit_similarity_2d(pos[ia, :2], enu[ib, :2], device=dev)
    res = np.linalg.norm(sim.apply(pos[ia, :2]) - enu[ib, :2], axis=1)
    report = {
        "mean_error_m": float(res.mean()),
        "std_error_m": float(res.std()),
        "n_pairs": int(len(ia)),
    }
    enu_full = np.column_stack([sim.apply(pos[:, :2]), pos[:, 2]])
    lat, lon, _ = anchor.reverse(f32(enu_full))
    return lat.cpu().numpy(), lon.cpu().numpy(), sim, report


def georeference_pcd(in_path: str, out_path: str, sim: Similarity2D):
    """Apply a fitted 2D similarity to a whole PCD map, preserving all
    fields (`georeference_pcd.py` capability)."""
    cloud = read_pcd(in_path)
    xyz = xyz_of(cloud)
    write_pcd(out_path, with_xyz(cloud, sim.apply_xyz(xyz)))
