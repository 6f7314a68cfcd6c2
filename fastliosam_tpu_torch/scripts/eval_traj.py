"""Trajectory evaluation CLI (evo-style; port of ``scripts/eval_traj.py``):
ATE / RPE of an estimated trajectory vs ground truth, with optional
alignment, plots, and a JSON report.

  python -m fastliosam_tpu_torch.scripts.eval_traj --est out/kitti07/07_kitti.txt \
      --gt /data/kitti/poses/07.txt --format kitti --align --plot out/ate.png
  python -m fastliosam_tpu_torch.scripts.eval_traj --est run_tum.txt --gt gt_tum.txt --format tum

Everything here is host arithmetic over a few thousand poses (the port's
``eval/metrics.py`` is numpy, as the JAX package's is), so the script has
no ``--device``: it runs where no card is.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load(path, fmt):
    from fastliosam_tpu_torch.io import read_kitti_poses, read_tum_trajectory

    if fmt == "kitti":
        poses = read_kitti_poses(path)
        stamps = np.arange(len(poses), dtype=float)
    else:
        stamps, poses = read_tum_trajectory(path)
    return stamps, poses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--est", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--format", choices=["kitti", "tum"], default="tum")
    ap.add_argument("--gt-format", choices=["kitti", "tum"], default=None)
    ap.add_argument("--align", action="store_true")
    ap.add_argument("--align-scale", action="store_true")
    ap.add_argument("--rpe-delta", type=int, default=10)
    ap.add_argument("--stamp-tol", type=float, default=0.05)
    ap.add_argument("--plot", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from fastliosam_tpu_torch.eval.metrics import ate_rmse, rpe
    from fastliosam_tpu_torch.postprocess.align import match_by_timestamp

    est_stamps, est = load(args.est, args.format)
    gt_stamps, gt = load(args.gt, args.gt_format or args.format)

    if args.format == "tum":
        ia, ib = match_by_timestamp(est_stamps, gt_stamps, args.stamp_tol)
        est, gt = est[ia], gt[ib]
    else:
        n = min(len(est), len(gt))
        est, gt = est[:n], gt[:n]
    if len(est) < 2:
        print("ERROR: <2 matched poses", file=sys.stderr)
        return 1

    ate = ate_rmse(
        est[:, :3, 3], gt[:, :3, 3],
        align=args.align or args.align_scale,
        with_scale=args.align_scale,
    )
    rpe_t, rpe_r = rpe(est, gt, delta=min(args.rpe_delta, len(est) - 1))
    report = {
        "n_poses": int(len(est)),
        "ate_rmse_m": round(ate, 4),
        f"rpe_trans_m_d{args.rpe_delta}": round(rpe_t, 4),
        f"rpe_rot_rad_d{args.rpe_delta}": round(rpe_r, 5),
        "aligned": bool(args.align or args.align_scale),
    }
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if args.plot:
        from fastliosam_tpu_torch.postprocess.plots import plot_trajectory

        plot_trajectory(
            est[:, :3, 3], args.plot,
            title=f"ATE {ate:.3f} m", gps_positions=gt[:, :3, 3][::5],
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
