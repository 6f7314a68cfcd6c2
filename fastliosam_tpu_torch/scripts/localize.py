"""Relocalize a sensor stream against a saved keyframe map (port of
``scripts/localize.py``, the FAST-LIO-Localization-QN consumer workflow,
`config.yaml:21`).

    python -m fastliosam_tpu_torch.scripts.localize --map out/run/seq_keyframes.npz \
        --dataset generic --root /data/recording --out out/loc \
        [--init-x 0 --init-y 0 --init-z 0 --init-yaw 0] [--device cpu]

KITTI sequences carry no IMU: their steps get an empty IMU batch, as in the
JAX script.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--map", required=True, help="keyframe bundle .npz")
    ap.add_argument("--dataset", choices=["generic", "kitti"], default="generic")
    ap.add_argument("--root", required=True)
    ap.add_argument("--seq", default="07")
    ap.add_argument("--out", default="out/localize")
    ap.add_argument("--scan-capacity", type=int, default=131072)
    ap.add_argument("--num-ds-points", type=int, default=8192)
    ap.add_argument("--map-capacity-log2", type=int, default=19)
    ap.add_argument("--init-x", type=float, default=0.0)
    ap.add_argument("--init-y", type=float, default=0.0)
    ap.add_argument("--init-z", type=float, default=0.0)
    ap.add_argument("--init-yaw", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from fastliosam_tpu_torch.io import GenericSequence, KittiSequence
    from fastliosam_tpu_torch.io.poses import write_tum_trajectory
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import ImuBatch, OdomConfig
    from fastliosam_tpu_torch.runtime import MapLocalizer
    from fastliosam_tpu_torch.scripts.run_slam import imu_batch, padded_scan

    args = parse_args(argv)
    loc = MapLocalizer(args.map, map_cfg=VoxelMapConfig(capacity=1 << args.map_capacity_log2),
                       odom_cfg=OdomConfig(num_ds_points=args.num_ds_points),
                       device=args.device)
    dev = loc.device
    guess = np.eye(4, dtype=np.float32)
    cy, sy = np.cos(args.init_yaw), np.sin(args.init_yaw)
    guess[:2, :2] = [[cy, -sy], [sy, cy]]
    guess[:3, 3] = (args.init_x, args.init_y, args.init_z)

    if args.dataset == "kitti":
        seq = KittiSequence(args.root, args.seq)
        stamps = seq.times

        def get(i):
            xyz, _, toff = seq.scan(i)
            return xyz, toff
    else:
        seq = GenericSequence(args.root)
        stamps = seq.stamps

        def get(i):
            xyz, _ = seq.scan(i)
            return xyz, np.zeros(len(xyz), np.float32)

    no_imu = ImuBatch(stamps=torch.full((8,), 1e9, dtype=torch.float32, device=dev),
                      gyro=torch.zeros((8, 3), device=dev), acc=torch.zeros((8, 3), device=dev),
                      mask=torch.zeros((8,), dtype=torch.bool, device=dev))
    poses, out_stamps = [], []
    t_prev = float(stamps[0]) - 0.1
    for i in range(len(seq)):
        scan = padded_scan(*get(i), args.scan_capacity, dev)
        stamp = float(stamps[i])
        if i == 0:
            print(f"global init fitness: {loc.global_init(scan, guess):.3f}")
        if args.dataset == "generic" and seq.imu is not None:
            ts, gy, ac = seq.imu_between(t_prev, stamp)
            imu = imu_batch(np.asarray(ts) - t_prev, gy, ac, 64, dev)
        else:
            imu = no_imu
        T, n_matched = loc.process(scan, imu, max(stamp - t_prev, 0.05))
        poses.append(T)
        out_stamps.append(stamp)
        t_prev = stamp
        if i % 50 == 0:
            print(f"  scan {i}/{len(seq)} matched={n_matched}")

    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "localized_tum.txt")
    write_tum_trajectory(out, out_stamps, np.stack(poses))
    print("saved:", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
