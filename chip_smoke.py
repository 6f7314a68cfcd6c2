#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastliosam_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds and runs there.

    python3 chip_smoke.py [--scans 150] [--out results.json] [--profile-scans N]

Phases, each of which fails the script (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from ``fastliosam_tpu_torch/csrc``
     (one nvcc per source, all started together) into ``build/kernels/``;
  3. kernel phase: each kernel against its plain PyTorch version on the card
     at the main path's shapes plus ragged and all-masked ones, then timed
     with CUDA events beside the plain version and a one-call PyTorch
     yardstick that the port never calls;
  4. slice phase: ``SlamEngine.process`` over the figure-8 loop feed at the
     full width of the bench's loop-closing configuration (2048 x 16 rays =
     32,768 points per scan, 8192 iEKF points, a 2^19-slot map, 16,384-point
     loop submaps), with every kernel's launch count reset just before and
     read just after, and the result held to ground truth (ATE < 0.10 m).
With ``--profile-scans N`` a second engine run traces its last N scans with
``torch.profiler`` (device time by kernel, the device's busy share); that
run does not touch the launch counts. The line before the last is a JSON
object describing every kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def check_nn(dev, seed: int):
    """The NN kernel against its plain version: 16,384 x 16,384 with ~10%
    of destinations masked (the loop-verification shape), a ragged
    1000 x 3001 and an all-masked 64 x 256. Returns the record of the main
    shape."""
    import torch

    from fastliosam_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(seed)
    main = None
    for n, m, masked in ((16384, 16384, 0.1), (1000, 3001, 0.1), (64, 256, 1.0)):
        src = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 5).to(dev)
        dst = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32) * 5).to(dev)
        mask = torch.from_numpy(rng.uniform(size=m) >= masked).to(dev)
        k_idx, k_d2 = nn_cuda.nearest_neighbors_cuda(src, dst, mask)
        r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(src, dst, mask)
        torch.cuda.synchronize()
        # d2 within rtol 1e-5 / atol 1e-4; idx equal except at ties whose two
        # candidates' d2 agree within 1e-5 relative
        d2_ok = torch.isclose(k_d2, r_d2, rtol=1e-5, atol=1e-4)
        if not bool(d2_ok.all()):
            raise AssertionError(f"nn d2 mismatch at {n}x{m}: "
                                 f"{int((~d2_ok).sum())} points")
        diff = k_idx != r_idx
        if bool(diff.any()):
            s = src[diff]
            dk = ((s - dst[k_idx[diff].long()]) ** 2).sum(-1)
            dr = ((s - dst[r_idx[diff].long()]) ** 2).sum(-1)
            if not bool(torch.isclose(dk, dr, rtol=1e-5, atol=1e-6).all()):
                raise AssertionError(f"nn index mismatch (not a tie) at {n}x{m}")
        if masked == 1.0 and not (bool((k_idx == 0).all()) and bool((k_d2 == 1e12).all())):
            raise AssertionError("nn all-masked case must give idx 0, d2 1e12")
        err = float((k_d2 - r_d2).abs().max())
        print(f"  nn {n}x{m} masked~{masked:.0%}: ok, max |d2 err| {err:.3g}, "
              f"{int(diff.sum())} tie(s)")
        if main is None:
            main = (src, dst, mask, err)

    src, dst, mask, err = main
    n, m = src.shape[0], dst.shape[0]
    ms = cuda_ms(lambda: nn_cuda.nearest_neighbors_cuda(src, dst, mask), reps=20)
    plain_ms = cuda_ms(lambda: nn_cuda.nearest_neighbors_ref(src, dst, mask), reps=5)

    def library():  # one cdist + masked min: the yardstick, unused by the port
        d = torch.cdist(src, dst)
        return d.masked_fill_(~mask[None, :], float("inf")).min(dim=1)

    library_ms = cuda_ms(library, reps=5)
    # least time: 8 float32 operations per (source, valid destination) pair
    # against the float32 rate; each input read once, each output written once
    ops = 8.0 * n * int(mask.sum())
    nbytes = n * 12 + m * 12 + m + n * 8
    t_ops, t_bytes = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    print(f"  nn {n}x{m}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+min {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms")
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------
def figure8_feed(n_scans: int, seed: int = 11) -> dict:
    """The bench's loop-closing feed: a lemniscate through a 60 m room, 2048
    azimuths x 16 rings at 10 Hz, IMU at 200 Hz. Generation takes ~0.6 s a
    scan on the host, so it is cached under build/."""
    cache = ROOT / "build" / f"chip_smoke_fig8_{n_scans}_{seed}.npz"
    if cache.exists():
        return dict(np.load(cache))
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=seed)
    traj = Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0,
                    gyro_noise=0.001, acc_noise=0.01, seed=seed, time_groups=32)
    data = simulate_sequence(world, traj, cfg, n_scans=n_scans)
    cap = max(32, max(len(b[0]) for b in data["imu"]))

    def pad(b, i, fill=0.0):
        a = b[i]
        return np.pad(a, ((0, cap - len(a)),) + ((0, 0),) * (a.ndim - 1),
                      constant_values=fill)

    R0, p0 = traj.pose(0.0)
    feed = {
        "xyz": np.stack([s[0] for s in data["scans"]]).astype(np.float32),
        "toff": np.stack([s[1] for s in data["scans"]]).astype(np.float32),
        "mask": np.stack([s[2] for s in data["scans"]]),
        "imu_t": np.stack([pad(b, 0, 1e9) for b in data["imu"]]).astype(np.float32),
        "imu_g": np.stack([pad(b, 1) for b in data["imu"]]).astype(np.float32),
        "imu_a": np.stack([pad(b, 2) for b in data["imu"]]).astype(np.float32),
        "imu_m": np.stack([np.arange(cap) < len(b[0]) for b in data["imu"]]),
        "gt_p": np.stack([g[1] for g in data["gt"]]).astype(np.float32),
        "stamps": np.asarray(data["stamps"], np.float64),
        "scan_dt": np.float32(data["scan_dt"]),
        "R0": R0.astype(np.float32), "p0": p0.astype(np.float32),
        "v0": traj.velocity(0.0).astype(np.float32),
    }
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, **feed)
    return feed


def make_engine(dev):
    """The bench's loop-closing pipeline configuration (bench.py
    make_engine_for, chunk 5, 128 keyframes, 256 between-factors)."""
    from fastliosam_tpu_torch.loop import LoopConfig
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import OdomConfig
    from fastliosam_tpu_torch.pgo import PoseGraphConfig
    from fastliosam_tpu_torch.runtime import EngineConfig, SlamEngine

    return SlamEngine(
        odom_cfg=OdomConfig(point_filter_num=1, blind=1.0, filter_size_surf=0.5,
                            num_ds_points=8192, det_range=150.0, evict_every=10_000,
                            query_mode="merged3"),
        map_cfg=VoxelMapConfig(capacity=1 << 19, voxel_size=0.5, min_points=5,
                               query_probes=2, insert_probes=2, claim_probes=2),
        loop_cfg=LoopConfig(radius=10.0, time_gap=4.0, num_submap_keyframes=5,
                            voxel_res=0.3, submap_points=16384),
        pgo_cfg=PoseGraphConfig(max_keyframes=128, max_between=256, max_gps=64),
        cfg=EngineConfig(keyframe_threshold=1.0, loop_check_every=5,
                         kf_cloud_points=4096, kf_cloud_voxel=0.3),
        device=dev,
    )


def run_engine(engine, feed, dev, n_scans: int, profile_from=None):
    """Drive ``engine.process`` over the feed (staged on the card first, as
    the bench stages its chunks). Returns per-phase host times and the
    per-verification host-sync counts; with ``profile_from`` the scans from
    that index on run under ``torch.profiler`` (returned as ``"prof"``)."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan
    from fastliosam_tpu_torch.utils import host_reads

    engine.reset()
    engine.odom = engine.odom._replace(nav=engine.odom.nav._replace(
        R=torch.from_numpy(feed["R0"]).to(dev), p=torch.from_numpy(feed["p0"]).to(dev),
        v=torch.from_numpy(feed["v0"]).to(dev)))
    g = {k: torch.from_numpy(np.asarray(feed[k])).to(dev)
         for k in ("xyz", "toff", "mask", "imu_t", "imu_g", "imu_a", "imu_m")}
    timing = {"verify_s": 0.0, "solve_s": 0.0, "verify_syncs": [], "verify_nn": []}
    launch_verify, solve = engine._launch_verify, engine._solve

    def timed_verify(query, cand):
        from fastliosam_tpu_torch.ops import nn_cuda

        t0, s0, l0 = time.perf_counter(), host_reads(), nn_cuda.launches
        launch_verify(query, cand)
        timing["verify_s"] += time.perf_counter() - t0
        timing["verify_syncs"].append(host_reads() - s0)
        timing["verify_nn"].append(nn_cuda.launches - l0)

    def timed_solve():
        t0 = time.perf_counter()
        solve()
        timing["solve_s"] += time.perf_counter() - t0

    engine._launch_verify, engine._solve = timed_verify, timed_solve
    prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n_scans):
        if k == profile_from:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        scan = Scan(g["xyz"][k], g["toff"][k], g["mask"][k])
        imu = ImuBatch(g["imu_t"][k], g["imu_g"][k], g["imu_a"][k], g["imu_m"][k])
        engine.process(scan, imu, float(feed["stamps"][k]), float(feed["scan_dt"]))
    engine.finish()
    torch.cuda.synchronize()
    timing["total_s"] = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        timing["prof"], timing["prof_wall_s"] = prof, time.perf_counter() - t_prof
    engine._launch_verify, engine._solve = launch_verify, solve
    return timing


def profile_summary(prof, wall_s: float, n_scans: int, top: int = 12) -> dict:
    """Device time by kernel over the traced window, and the device's busy
    share of the window's wall time (the port runs on one stream, so the
    kernels' times add up to the busy time)."""
    rows = []
    for ev in prof.key_averages():
        # device-side rows only (kernels, copies, sets); the CPU op rows
        # that launched them would count the same time again
        if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) * 1e-6
    launches = sum(r[1] for r in rows)
    out = {
        "window_scans": n_scans, "wall_s": wall_s, "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "device_ops_per_scan": launches / n_scans,
        "top": [{"op": k[:80], "device_ms": us / 1e3, "count": c} for us, c, k in rows[:top]],
    }
    print(f"  profile over {n_scans} scans: wall {wall_s:.3f} s, device busy "
          f"{busy_s:.3f} s (idle {out['device_idle_share']:.1%}), "
          f"{out['device_ops_per_scan']:.0f} device ops/scan")
    for r in out["top"]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:6d}  {r['op']}")
    return out


def slice_phase(dev, n_scans: int, profile_scans: int = 0):
    import torch

    from fastliosam_tpu_torch.ops import KERNEL_MODULES
    from fastliosam_tpu_torch.utils import host_read, host_reads, reset_host_reads

    t0 = time.perf_counter()
    feed = figure8_feed(n_scans)
    print(f"  feed: {n_scans} scans x {feed['xyz'].shape[1]} points "
          f"({time.perf_counter() - t0:.1f} s to make or load)")
    engine = make_engine(dev)
    run_engine(engine, feed, dev, min(12, n_scans))  # warm-up: allocator, cuBLAS
    # the main path's run: every launch count starts at 0 here
    for mod in KERNEL_MODULES:
        mod.reset_launches()
    reset_host_reads()
    timing = run_engine(engine, feed, dev, n_scans)
    syncs = host_reads()
    launches = {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}

    rt = np.stack(engine.realtime_traj)[:, :3, 3]
    ate = float(np.sqrt(np.mean(np.sum((rt - feed["gt_p"][:n_scans]) ** 2, axis=1))))
    matched = host_read(torch.stack(engine.match_counts))
    n_verify = len(engine.loop_attempts)
    result = {
        "scans": n_scans,
        "scans_per_s": n_scans / timing["total_s"],
        "keyframes": engine.kf.n,
        "loops": len(engine.loop_pairs),
        "verifications": n_verify,
        "solves": engine.solve_count,
        "launches": launches,
        "host_syncs_per_scan": syncs / n_scans,
        "host_syncs_per_verification": (float(np.mean(timing["verify_syncs"]))
                                        if timing["verify_syncs"] else None),
        "nn_launches_per_verification": (float(np.mean(timing["verify_nn"]))
                                         if timing["verify_nn"] else None),
        "verify_ms_each": (1e3 * timing["verify_s"] / len(timing["verify_syncs"])
                           if timing["verify_syncs"] else None),
        "solve_ms_each": (1e3 * timing["solve_s"] / engine.solve_count
                          if engine.solve_count else None),
        "host_s": {k: timing[k] for k in ("total_s", "verify_s", "solve_s")},
        "ate_m": ate,
        "min_matched_after_scan2": int(matched[2:].min()),
    }
    print("  " + json.dumps(result))
    poses = np.stack(engine.realtime_traj)
    checks = {
        "every pose finite": bool(np.all(np.isfinite(poses)))
        and bool(np.all(np.isfinite(engine.keyframe_poses()))),
        "n_matched > 500 after scan 2": result["min_matched_after_scan2"] > 500,
        "at least one verification": n_verify >= 1,
        "every kernel launched on the main path": all(v > 0 for v in launches.values()),
        "ATE < 0.10 m": ate < 0.10,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("slice phase failed: " + ", ".join(failed))
    if profile_scans > 0:  # a separate run: the main path's counts stay as read
        start = max(0, n_scans - profile_scans)
        prof_run = run_engine(engine, feed, dev, n_scans, profile_from=start)
        result["profile"] = profile_summary(
            prof_run["prof"], prof_run["prof_wall_s"], n_scans - start)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=150, help="figure-8 scans to run")
    ap.add_argument("--seed", type=int, default=0, help="seed of the kernel inputs")
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    ap.add_argument("--profile-scans", type=int, default=0,
                    help="trace the last N scans of an extra run with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    print(card_line())
    dev = torch.device("cuda", 0)

    from fastliosam_tpu_torch.ops import KERNEL_MODULES, build
    from fastliosam_tpu_torch.utils import geometry_precision

    t0 = time.perf_counter()
    build.build(build.sources())
    print(f"build: {len(build.sources())} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}.cu: {line.strip()}")

    with geometry_precision():
        print("kernel phase:")
        kernels = {"nearest_neighbors": check_nn(dev, args.seed)}
        print("slice phase:")
        result = slice_phase(dev, args.scans, args.profile_scans)

    line = {"kernels": []}
    for mod in KERNEL_MODULES:
        rec = dict(mod.KERNEL)
        rec["launches"] = result["launches"][rec["name"]]
        rec.update(kernels[rec["name"]])
        line["kernels"].append(rec)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card_line(), "kernels": line["kernels"], "slice": result}, indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
