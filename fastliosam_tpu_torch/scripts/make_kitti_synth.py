"""Generate a KITTI-odometry-format synthetic sequence from the urban-canyon
simulator: a multi-loop circuit with a featureless canyon segment and
corner yaw-rate spikes, written as real .bin files, so the KITTI reader,
the native decoder and the engine run end to end. Port of
``scripts/make_kitti_synth.py`` on the port's own ``sim/world.py``: the
same arguments write the same bytes.

Layout written (KITTI odometry contract, ``io/kitti.py``):
    <out>/sequences/<seq>/velodyne/%06d.bin   (x, y, z, intensity) f32
    <out>/sequences/<seq>/times.txt
    <out>/sequences/<seq>/calib.txt           (Tr = identity)
    <out>/poses/<seq>.txt                     ground truth 3x4 rows

Usage:
    python -m fastliosam_tpu_torch.scripts.make_kitti_synth --out out/kitti_synth \
        [--n-scans 1160] [--workers 4]

Each 50-scan block is simulated on its own (the scans carry no noise), so
``--workers`` processes generate blocks in parallel and write the same
files as one.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from contextlib import nullcontext
from functools import partial

import numpy as np

BLOCK = 50  # scans per simulate_sequence call


def _scenario(n_azimuth, n_elev, max_range, seed, rich):
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory

    world = PlaneWorld.city(a=60.0, b=60.0, street_w=12.0, wall_h=8.0,
                            n_clutter=96 if rich else 24, seed=seed, rich=rich)
    # start from rest on the textured bottom street; the featureless +x
    # canyon is entered mid-run at speed, once the LiDAR-only filter has
    # locked its velocity
    r = 10.0
    Ly, Lx, Q = 2 * (60.0 - r), 2 * (60.0 - r), np.pi * r / 2.0
    s_bottom = Ly + Q + Lx + Q + Ly + Q
    traj = Trajectory.circuit(a=60.0, b=60.0, corner_r=10.0, speed=8.0, ramp_t=4.0,
                              s_start=s_bottom)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=n_azimuth, n_elev=n_elev, max_range=max_range,
                    gyro_noise=0.001, acc_noise=0.01, seed=seed, time_groups=32)
    return world, traj, cfg


def _write_block(velo, k0, n, scenario):
    """Simulate scans [k0, k0 + n), write their .bin files; returns their
    stamps and ground-truth rows."""
    from fastliosam_tpu_torch.sim import simulate_sequence

    world, traj, cfg = _scenario(*scenario)
    data = simulate_sequence(world, traj, cfg, n_scans=n, t0=k0 / cfg.scan_rate)
    times, rows = [], []
    for i in range(n):
        pts, _, mask = data["scans"][i]
        p = pts[mask]
        rec = np.zeros((len(p), 4), np.float32)
        rec[:, :3] = p
        rec[:, 3] = 0.5  # constant intensity (the sim has no reflectivity)
        rec.tofile(os.path.join(velo, f"{k0 + i:06d}.bin"))
        times.append(data["stamps"][i])
        R, t = data["gt"][i]
        rows.append(" ".join(f"{v:.9e}" for v in np.hstack([R, t[:, None]]).reshape(-1)))
    return times, rows


def generate(out_root, seq="00", n_scans=1160, n_azimuth=2048, n_elev=16, max_range=50.0,
             seed=0, progress=True, rich=False, workers=1):
    """Write the sequence under ``out_root``; returns ``out_root``."""
    seq_dir = os.path.join(out_root, "sequences", seq)
    velo = os.path.join(seq_dir, "velodyne")
    os.makedirs(velo, exist_ok=True)
    os.makedirs(os.path.join(out_root, "poses"), exist_ok=True)
    block = partial(_write_block, velo, scenario=(n_azimuth, n_elev, max_range, seed, rich))
    starts = range(0, n_scans, BLOCK)
    sizes = [min(BLOCK, n_scans - k0) for k0 in starts]

    times, pose_rows = [], []
    with (ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
          if workers > 1 else nullcontext()) as pool:
        for k0, n, (t, r) in zip(starts, sizes, (pool.map if pool else map)(block, starts, sizes)):
            times += t
            pose_rows += r
            if progress:
                print(f"  {k0 + n}/{n_scans} scans", flush=True)

    np.savetxt(os.path.join(seq_dir, "times.txt"), np.asarray(times), fmt="%.6f")
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        eye = "1 0 0 0 0 1 0 0 0 0 1 0"
        for k in ("P0", "P1", "P2", "P3", "Tr"):
            f.write(f"{k}: {eye}\n")
    with open(os.path.join(out_root, "poses", f"{seq}.txt"), "w") as f:
        f.write("\n".join(pose_rows) + "\n")
    return out_root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="out/kitti_synth")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--n-scans", type=int, default=1160)
    ap.add_argument("--n-azimuth", type=int, default=2048)
    ap.add_argument("--max-range", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rich", action="store_true",
                    help="feature-rich world (no featureless canyon)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes generating 50-scan blocks in parallel")
    a = ap.parse_args(argv)
    generate(a.out, a.seq, a.n_scans, a.n_azimuth, max_range=a.max_range, seed=a.seed,
             rich=a.rich, workers=a.workers)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
