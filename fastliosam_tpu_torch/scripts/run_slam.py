"""Run the full SLAM pipeline over a dataset directory and export the
results (port of ``scripts/run_slam.py``, the ``run.launch`` analog).

    python -m fastliosam_tpu_torch.scripts.run_slam --dataset kitti \
        --root /data/kitti --seq 07 --out out/kitti07
    python -m fastliosam_tpu_torch.scripts.run_slam --dataset sim --out out/sim --n-scans 200
    python -m fastliosam_tpu_torch.scripts.run_slam --dataset generic \
        --root /data/recording --use-gps --out out/rec

Datasets ``sim``, ``kitti`` and ``generic`` with the JAX script's flags and
defaults for them, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain versions of the kernels). The JAX script's ``mulran``,
``newer-college`` and ``bag`` datasets, and the ``--preset`` and
``--gt-csv`` flags that only they read, are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_engine(args):
    from fastliosam_tpu_torch.loop import LoopConfig
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import OdomConfig
    from fastliosam_tpu_torch.pgo import PoseGraphConfig
    from fastliosam_tpu_torch.runtime import EngineConfig, SlamEngine

    return SlamEngine(
        odom_cfg=OdomConfig(
            point_filter_num=args.point_filter_num,
            blind=args.blind,
            filter_size_surf=args.filter_size_surf,
            num_ds_points=args.num_ds_points,
            det_range=args.det_range,
            max_iteration=args.max_iteration,
            query_mode=args.query_mode,
        ),
        map_cfg=VoxelMapConfig(capacity=1 << args.map_capacity_log2,
                               voxel_size=args.filter_size_map),
        loop_cfg=LoopConfig(radius=args.loop_radius, time_gap=args.loop_time_gap,
                            icp_score_threshold=args.icp_score_threshold),
        pgo_cfg=PoseGraphConfig(max_keyframes=args.max_keyframes,
                                max_between=args.max_keyframes * 2),
        cfg=EngineConfig(keyframe_threshold=args.keyframe_threshold, use_gps=args.use_gps),
        device=args.device,
    )


def imu_batch(ts, gy, ac, cap, dev):
    """Pad an IMU run to ``cap`` samples (stamps 1e9 past the end)."""
    from fastliosam_tpu_torch.odom import ImuBatch

    m = min(len(ts), cap)
    return ImuBatch(
        stamps=torch.from_numpy(np.pad(np.asarray(ts[:m], np.float32), (0, cap - m),
                                       constant_values=1e9)).to(dev),
        gyro=torch.from_numpy(np.pad(np.asarray(gy[:m], np.float32).reshape(m, 3),
                                     ((0, cap - m), (0, 0)))).to(dev),
        acc=torch.from_numpy(np.pad(np.asarray(ac[:m], np.float32).reshape(m, 3),
                                    ((0, cap - m), (0, 0)))).to(dev),
        mask=torch.from_numpy(np.arange(cap) < m).to(dev),
    )


def padded_scan(xyz, toff, cap, dev):
    """The first ``cap`` points, padded with 1e6 and masked."""
    from fastliosam_tpu_torch.odom import Scan

    n = min(len(xyz), cap)
    pad = cap - n
    return Scan(
        xyz=torch.from_numpy(np.pad(np.asarray(xyz[:n], np.float32), ((0, pad), (0, 0)),
                                    constant_values=1e6)).to(dev),
        t_offset=torch.from_numpy(np.pad(np.asarray(toff[:n], np.float32), (0, pad))).to(dev),
        mask=torch.from_numpy(np.arange(cap) < n).to(dev),
    )


def run_sim(args, engine):
    from fastliosam_tpu_torch.eval import ate_rmse
    from fastliosam_tpu_torch.odom import ImuBatch, Scan
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    dev = engine.device
    args.n_scans = args.n_scans or 200  # 0 sentinel = sim default
    world = PlaneWorld.room(size=50.0, height=8.0, n_boxes=20, seed=1)
    traj = Trajectory.circle(radius=8.0, period=40.0)
    sim_cfg = SimConfig(n_azimuth=1024, n_elev=16, time_groups=32, seed=1)
    data = simulate_sequence(world, traj, sim_cfg, n_scans=args.n_scans)

    def scan(k):
        return Scan(*(torch.from_numpy(a).to(dev) for a in data["scans"][k]))

    def imu(k):
        return imu_batch(*data["imu"][k], 64, dev)

    t0 = time.perf_counter()
    chunk = max(1, args.chunk)
    if chunk > 1:
        # chunked path: S scans per call, keyframe decisions on the device
        # (one host read per chunk)
        for c in range(0, args.n_scans, chunk):
            ks = range(c, min(c + chunk, args.n_scans))
            scans, imus = [scan(k) for k in ks], [imu(k) for k in ks]
            engine.process_chunk(Scan(*(torch.stack([s[i] for s in scans]) for i in range(3))),
                                 ImuBatch(*(torch.stack([b[i] for b in imus]) for i in range(4))),
                                 [data["stamps"][k] for k in ks], data["scan_dt"])
    else:
        for k in range(args.n_scans):
            engine.process(scan(k), imu(k), data["stamps"][k], data["scan_dt"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gt = np.stack([g[1] for g in data["gt"]])
    est = np.stack(engine.realtime_traj)[:, :3, 3]
    print(f"{args.n_scans} scans in {dt:.1f}s ({args.n_scans / dt:.1f} scans/s)")
    print(f"ATE (aligned): {ate_rmse(est, gt, align=True):.4f} m")


def run_kitti(args, engine):
    from fastliosam_tpu_torch.runtime.drivers import drive_kitti

    out = drive_kitti(engine, args.root, args.seq, scan_capacity=args.scan_capacity,
                      n_scans=args.n_scans if args.n_scans > 0 else None)
    print(f"KITTI {args.seq}: {out['n_scans']} scans at {out['scans_per_sec']} scans/s, "
          f"{out['n_keyframes']} keyframes, {out['n_loops']} loops")
    if "ate_m" in out:
        print(f"ATE: {out['ate_m']} m  RPE(1s): {out['rpe_1s_m']} m")


def run_generic(args, engine):
    from fastliosam_tpu_torch.io import GenericSequence
    from fastliosam_tpu_torch.runtime import GpsFix

    dev = engine.device
    seq = GenericSequence(args.root)
    cap = args.scan_capacity
    t_prev = float(seq.stamps[0]) - 0.1
    for i in range(len(seq)):
        xyz, _ = seq.scan(i)
        stamp = float(seq.stamps[i])
        ts, gy, ac = seq.imu_between(t_prev, stamp)
        imu = imu_batch(np.asarray(ts) - t_prev, gy, ac, 64, dev)
        scan = padded_scan(xyz, np.zeros(len(xyz), np.float32), cap, dev)
        fixes = [
            GpsFix(stamp=r[0], lat=r[1], lon=r[2], alt=r[3],
                   cov_xyz=tuple(r[4:7]) if len(r) >= 7 else (1.0, 1.0, 4.0))
            for r in seq.gnss_between(t_prev, stamp)
        ]
        engine.process(scan, imu, stamp, stamp - t_prev, gps=fixes)
        t_prev = stamp


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", choices=["kitti", "generic", "sim"], default="sim")
    ap.add_argument("--root", default=None)
    ap.add_argument("--seq", default="07")
    ap.add_argument("--out", default="out/run")
    ap.add_argument("--n-scans", type=int, default=0,
                    help="0 = dataset default (sim: 200, file datasets: all)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="scans per call (sim dataset): >1 uses the chunked engine path "
                    "with on-device keyframe decisions")
    ap.add_argument("--scan-capacity", type=int, default=131072)
    ap.add_argument("--use-gps", action="store_true")
    # FAST-LIO parameter surface (kitti.launch / config.yaml names)
    ap.add_argument("--point-filter-num", type=int, default=4)
    ap.add_argument("--blind", type=float, default=1.0)
    ap.add_argument("--filter-size-surf", type=float, default=0.5)
    ap.add_argument("--filter-size-map", type=float, default=0.5)
    ap.add_argument("--max-iteration", type=int, default=3)
    ap.add_argument("--query-mode", choices=["merged", "merged2", "merged3", "cached"],
                    default="merged",
                    help="plane association: merged=7-voxel stencil (robust), "
                    "merged3=adaptive 3-voxel (faster on dense scans); merged2 and cached "
                    "are not ported yet (the engine raises NotImplementedError)")
    ap.add_argument("--det-range", type=float, default=300.0)
    ap.add_argument("--num-ds-points", type=int, default=8192)
    ap.add_argument("--map-capacity-log2", type=int, default=19)
    ap.add_argument("--keyframe-threshold", type=float, default=1.0)
    ap.add_argument("--loop-radius", type=float, default=35.0)
    ap.add_argument("--loop-time-gap", type=float, default=30.0)
    ap.add_argument("--icp-score-threshold", type=float, default=1.5)
    ap.add_argument("--max-keyframes", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from fastliosam_tpu_torch.runtime import save_results

    args = parse_args(argv)
    engine = build_engine(args)
    if args.dataset == "sim":
        run_sim(args, engine)
    elif args.dataset == "kitti":
        run_kitti(args, engine)
    else:
        run_generic(args, engine)
    paths = save_results(engine, args.out, args.seq if args.dataset == "kitti" else args.dataset)
    print("saved:", paths)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
