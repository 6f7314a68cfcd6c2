"""The synthetic LiDAR-inertial feed that every lane of a fleet replays.

A spinning multi-beam sensor (or a Livox-like rosette) ray-cast against a
room of rectangles from its pose at each point's own capture time, so
motion distortion is real and the deskew has work; IMU samples with bias
and noise from the analytic path; GPS draws kept, since they share the
noise generator and so decide the IMU noise that follows them. A copy of
the program's ``sim/world.py`` and of ``eval/feeds.py:
build_fig8_sequence`` (numpy, float64 until the float32 arrays are
packed), so the benchmark's inputs do not move with the program.

The traffic file's ``feed`` object names the world, the path and the
sensor of one recording, and ``recordings`` what each recording of the
fleet changes in it; :func:`load` builds a recording once into
``build/slam_bench/`` of the checkout and reads it from there after, and
:func:`load_recordings` stacks the recordings scan after scan.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / "slam_bench"


def room(size: float, height: float, n_boxes: int, seed: int):
    """``(centers, us, vs)`` of a closed room's floor, ceiling, four walls and
    random interior boxes (rectangles by centre and two half-axes)."""
    rng = np.random.default_rng(seed)
    s, h = size / 2.0, height
    C, U, V = [], [], []

    def rect(center, u, v):
        C.append(center)
        U.append(u)
        V.append(v)

    rect([0, 0, 0], [s, 0, 0], [0, s, 0])
    rect([0, 0, h], [s, 0, 0], [0, -s, 0])
    rect([s, 0, h / 2], [0, s, 0], [0, 0, h / 2])
    rect([-s, 0, h / 2], [0, -s, 0], [0, 0, h / 2])
    rect([0, s, h / 2], [-s, 0, 0], [0, 0, h / 2])
    rect([0, -s, h / 2], [s, 0, 0], [0, 0, h / 2])
    for _ in range(n_boxes):
        bx, by = rng.uniform(-s * 0.7, s * 0.7, size=2)
        if 4.5 < np.hypot(bx, by) < 11.5:  # an annular corridor kept free
            continue
        w, d, bh = rng.uniform(0.8, 2.5, size=3)
        bh = min(bh + 0.5, h - 1)
        yaw = rng.uniform(0, np.pi)
        ca, sa = np.cos(yaw), np.sin(yaw)
        ux = np.array([ca, sa, 0.0])
        uy = np.array([-sa, ca, 0.0])
        rect([bx + ux[0] * w, by + ux[1] * w, bh / 2], uy * d, [0, 0, bh / 2])
        rect([bx - ux[0] * w, by - ux[1] * w, bh / 2], -uy * d, [0, 0, bh / 2])
        rect([bx + uy[0] * d, by + uy[1] * d, bh / 2], -ux * w, [0, 0, bh / 2])
        rect([bx - uy[0] * d, by - uy[1] * d, bh / 2], ux * w, [0, 0, bh / 2])
        rect([bx, by, bh], ux * w, uy * d)
    return tuple(np.asarray(a, np.float64) for a in (C, U, V))


def _reachable(world, origins, dirs, margin=1e-3):
    """Indices of the rectangles a ray of ``dirs`` from the one shared
    origin may hit (every other one gives every ray t = inf), or None."""
    centers, us, vs = world
    o = origins[0]
    if not np.array_equal(origins, np.broadcast_to(o, origins.shape)):
        return None
    s = dirs.sum(axis=0)
    s_norm = np.linalg.norm(s)
    if s_norm == 0.0:
        return None
    a = s / s_norm
    theta = np.arccos(np.clip(((dirs @ a) / np.linalg.norm(dirs, axis=-1)).min(), -1.0, 1.0))
    w = centers - o
    dist = np.linalg.norm(w, axis=-1)
    ul = np.linalg.norm(us, axis=-1)
    vl = np.linalg.norm(vs, axis=-1)
    r = ul + vl
    perp = np.abs(np.sum(us * vs, axis=-1)) <= 1e-9 * ul * vl
    far = dist > r * 1.001 + 1e-6
    safe = np.maximum(dist, 1e-300)
    off_axis = np.arccos(np.clip((w @ a) / safe, -1.0, 1.0))
    half = np.arcsin(np.clip(r / safe, 0.0, 1.0))
    return np.flatnonzero(~(perp & far & (off_axis > theta + half + margin)))


def raycast(world, origins, dirs, max_range):
    """``(points (N, 3), hit (N,))`` of the nearest rectangle along each ray."""
    centers, us, vs = world
    n = np.cross(us, vs)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    c = centers
    keep = _reachable(world, origins, dirs)
    if keep is not None:
        n, c, us, vs = n[keep], c[keep], us[keep], vs[keep]
    if len(c) == 0:
        tmin = np.full(len(dirs), np.inf)
    else:
        denom = dirs @ n.T
        num = np.einsum("kj,nkj->nk", n, c[None] - origins[:, None])
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        t = np.where(np.abs(denom) > 1e-9, t, np.inf)
        t = np.where(t > 1e-6, t, np.inf)
        t_safe = np.where(np.isfinite(t), t, 0.0)
        rel = origins[:, None] + t_safe[..., None] * dirs[:, None] - c[None]
        uu = np.einsum("nkj,kj->nk", rel, us) / np.sum(us * us, axis=-1)
        vv = np.einsum("nkj,kj->nk", rel, vs) / np.sum(vs * vs, axis=-1)
        t = np.where((np.abs(uu) <= 1.0) & (np.abs(vv) <= 1.0), t, np.inf)
        tmin = t.min(axis=1)
    hit = np.isfinite(tmin) & (tmin < max_range)
    return origins + np.where(hit, tmin, 0.0)[:, None] * dirs, hit


def _yaw(yaw):
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])


def path(spec: dict):
    """``t -> (R, p)`` of the named analytic path."""
    kind = spec["kind"]
    w = 2 * np.pi / spec["period"]
    if kind == "figure8":  # a lemniscate of Gerono, heading along its tangent
        scale, z_amp = spec["scale"], spec["z_amp"]

        def pose(t):
            a = w * t
            p = np.array([scale * np.sin(a), 0.5 * scale * np.sin(2 * a),
                          1.5 + z_amp * np.sin(3 * a)])
            return _yaw(np.arctan2(scale * w * np.cos(2 * a), scale * w * np.cos(a))), p
    elif kind == "circle":
        radius, z_amp, pitch_amp = spec["radius"], spec["z_amp"], spec["pitch_amp"]

        def pose(t):
            a = w * t
            p = np.array([radius * np.cos(a), radius * np.sin(a), 1.5 + z_amp * np.sin(2 * a)])
            pitch = pitch_amp * np.sin(3 * a)
            cp, sp = np.cos(pitch), np.sin(pitch)
            return _yaw(a + np.pi / 2) @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]]), p
    else:
        raise ValueError(f"unknown path kind {kind!r}")
    return pose


def _velocity(pose, t, eps=1e-4):
    return (pose(t + eps)[1] - pose(t - eps)[1]) / (2 * eps)


def _acceleration(pose, t, eps=1e-3):
    return (pose(t + eps)[1] - 2 * pose(t)[1] + pose(t - eps)[1]) / (eps * eps)


def _angular_velocity(pose, t, eps=1e-4):
    dR = (pose(t + eps)[0] - pose(t - eps)[0]) / (2 * eps)
    W = pose(t)[0].T @ dR
    return np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]]) * 0.5


def ray_dirs(sensor: dict):
    """``(directions (N, 3), capture-time fraction of the sweep (N,))``."""
    if sensor["pattern"] == "livox":  # a non-repetitive rosette in a forward cone
        n = sensor["n_points"]
        i = np.arange(n)
        t_frac = i / n
        half = sensor["fov"] / 2.0
        a1 = 2 * np.pi * 1817.0 * t_frac
        a2 = 2 * np.pi * 2017.0 * t_frac + 2.39996 * i / n
        u = half * np.cos(a1) * np.abs(np.sin(a2)) ** 0.5
        v = half * np.sin(a1) * np.abs(np.cos(a2)) ** 0.5
        return np.stack([np.cos(u) * np.cos(v), np.sin(u) * np.cos(v), np.sin(v)], -1), t_frac
    az = np.linspace(0, 2 * np.pi, sensor["n_azimuth"], endpoint=False)
    el = np.linspace(sensor["elev_fov"][0], sensor["elev_fov"][1], sensor["n_elev"])
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg), np.sin(elg)],
                 axis=-1).reshape(-1, 3)
    # clockwise from -x, as a Velodyne sweeps
    return d, ((np.pi - azg) % (2 * np.pi) / (2 * np.pi)).reshape(-1)


def build(spec: dict) -> dict:
    """The feed of ``spec`` (the traffic file's ``feed``): per scan the points
    in the sensor frame, their time offsets and hit mask; the IMU samples
    of the scan's interval padded to ``imu_cap``; and the true pose and
    velocity at each scan's start (the state a lane starts a clip from)."""
    sensor = spec["sensor"]
    rng = np.random.default_rng(spec["seed"])
    world = room(**spec["room"])
    pose = path(spec["path"])
    dirs, t_frac = ray_dirs(sensor)
    scan_T = 1.0 / sensor["scan_rate"]
    imu_dt = 1.0 / spec["imu"]["rate"]
    g_world = np.array([0.0, 0.0, -9.81])
    bg = np.asarray(spec["imu"]["gyro_bias"])
    ba = np.asarray(spec["imu"]["acc_bias"])
    gps_period = 1.0 / spec["gps"]["rate"] if spec["gps"]["rate"] > 0 else None
    n_rays, cap = dirs.shape[0], spec["imu_cap"]
    n = spec["n_scans"]
    out = {"xyz": np.zeros((n, n_rays, 3), np.float32), "toff": np.zeros((n, n_rays), np.float32),
           "mask": np.zeros((n, n_rays), bool), "imu_t": np.full((n, cap), 1e9, np.float32),
           "imu_g": np.zeros((n, cap, 3), np.float32), "imu_a": np.zeros((n, cap, 3), np.float32),
           "imu_m": np.zeros((n, cap), bool), "R0": np.zeros((n, 3, 3), np.float32),
           "p0": np.zeros((n, 3), np.float32), "v0": np.zeros((n, 3), np.float32)}
    for k in range(n):
        t_end = (k + 1) * scan_T
        t_start = t_end - scan_T
        frac = np.floor(t_frac * sensor["time_groups"]) / sensor["time_groups"]
        pt_times = t_start + frac * scan_T
        pts = np.zeros((n_rays, 3))
        hits = np.zeros((n_rays,), bool)
        uniq, inv = np.unique(pt_times, return_inverse=True)
        for ui, tu in enumerate(uniq):
            sel = inv == ui
            R, p = pose(tu)
            d_world = dirs[sel] @ R.T
            pw, h = raycast(world, np.broadcast_to(p, d_world.shape), d_world,
                            sensor["max_range"])
            pts[sel] = (pw - p) @ R
            hits[sel] = h
        out["xyz"][k], out["toff"][k], out["mask"][k] = pts, pt_times - t_start, hits
        n_imu = int(round(scan_T / imu_dt))
        ts = t_start + np.arange(n_imu) * imu_dt
        gyro = np.stack([_angular_velocity(pose, t) for t in ts])
        acc_w = np.stack([_acceleration(pose, t) for t in ts])
        Rs = [pose(t)[0] for t in ts]
        acc_b = np.stack([Rs[i].T @ (acc_w[i] - g_world) for i in range(n_imu)])
        gyro = gyro + bg + rng.normal(size=gyro.shape) * spec["imu"]["gyro_noise"]
        acc_b = acc_b + ba + rng.normal(size=acc_b.shape) * spec["imu"]["acc_noise"]
        out["imu_t"][k, :n_imu] = ts - t_start
        out["imu_g"][k, :n_imu] = gyro
        out["imu_a"][k, :n_imu] = acc_b
        out["imu_m"][k, :n_imu] = True
        R0, p0 = pose(t_start)
        out["R0"][k], out["p0"][k], out["v0"][k] = R0, p0, _velocity(pose, t_start)
        if gps_period is not None and int(t_end / gps_period) > int(t_start / gps_period):
            rng.normal(size=3)  # the GPS fix's noise: drawn to keep the IMU noise's sequence
    out["scan_dt"] = np.float32(scan_T)
    return out


def load(spec: dict) -> dict:
    """:func:`build`, cached at a fixed path of the checkout named by the
    spec's hash (written through a temporary file, so that two processes
    never read half of one)."""
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"feed-{key}.npz"
    if path.exists():
        with np.load(path) as f:
            return dict(f)
    data = build(spec)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **data)
    tmp.replace(path)
    return data


def recording_specs(spec: dict, recordings: list) -> list:
    """``spec`` with each recording's changes (nested objects merged key by
    key)."""
    def merged(base, change):
        out = dict(base)
        for k, v in change.items():
            out[k] = merged(base[k], v) if isinstance(v, dict) else v
        return out

    return [merged(spec, change) for change in recordings]


def load_recordings(spec: dict, recordings: list) -> dict:
    """The recordings' feeds, one after the other along the scan axis:
    recording ``r``'s scan ``k`` is scan ``r * spec["n_scans"] + k``."""
    parts = [load(s) for s in recording_specs(spec, recordings)]
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0] if k != "scan_dt"}
    out["scan_dt"] = parts[0]["scan_dt"]
    return out
