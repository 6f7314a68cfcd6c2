#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastliosam_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds and runs there.

    python3 chip_smoke.py [--scans 150] [--corridor-scans 400] [--out results.json]
                          [--profile-scans N]

Phases, each of which fails the script (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi); the two sim feeds start
     generating in two worker processes (they take ~1-2 minutes of host
     time and are cached under build/);
  2. build every CUDA kernel of the package from ``fastliosam_tpu_torch/csrc``
     (one nvcc per source, all started together) into ``build/kernels/``;
  3. kernel phase: each kernel against its plain PyTorch version on the card
     at the main path's shapes plus ragged ones (the gathers and the
     association bit for bit; the nearest neighbours also on ties planted
     across its destination slices, and twice for identical words), timed
     with CUDA events around back-to-back device work (fresh indices or
     queries; ``utils/timing.py``) beside the plain version, a one-call
     PyTorch yardstick that the port never calls (where one exists), and
     its bound; then the gather experiment entry point
     (``fastliosam_tpu_torch.scripts.exp_gather``), the path of
     ``take_along_axis``; the association kernel (``merged_moments``) is
     checked once the figure-8 feed is made, on the engine's own 2^19-slot
     map after 20 scans;
  4. per-scan phase: ``SlamEngine.process`` over the figure-8 loop feed at
     the full width of the bench's loop-closing configuration (2048 x 16
     rays = 32,768 points per scan, 8192 iEKF points, a 2^19-slot map,
     16,384-point loop submaps), run twice from ``reset()``: the two runs
     must give bit-identical realtime trajectories and loop pairs, and the
     result must hold to ground truth (ATE < 0.10 m);
  5. chunked phase: ``process_chunk_deferred`` (chunk 5) over the same feed,
     twice from ``reset()`` with the same replay check, ATE < 0.10 m, at
     least one loop, at most one host read per chunk for odometry and
     keyframing;
  6. GPS phase: the bench's GPS corridor (``bench.py:
     build_corridor_sequence`` and ``bench_gps_corridor``), fixes through
     WGS84 geodesy, ``process_chunk`` with GPS off and on; with GPS on at
     least two GPS factors, a solve, and ATE < 2.0 m.
Every kernel's launch count is set to 0 just before each path and read
just after; each kernel must have launched on its path (the nearest
neighbours on the loop-closing phases 4 and 5, the row gather and the
association on 4-6, take_along_axis on the experiment entry point). Phases
4-6 report the row gather's and the association's launches per scan, and
device operations per scan over a window traced with ``torch.profiler``
(the last 50 scans of the replay in 4 and 5, the last 25 of the GPS-off
run in 6; ``engine.finish()`` included). With ``--profile-scans N``
an extra per-scan run, after every phase, traces its last N scans with
``torch.profiler``; it does not touch the launch counts. The line before
the last is a JSON object describing every kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    from fastliosam_tpu_torch.utils.timing import device_ms

    return device_ms(fn, [()] * reps)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def check_nn(dev, seed: int):
    """The NN kernel against its plain version: 16,384 x 16,384 with ~10%
    of destinations masked (the loop-verification shape), a ragged
    1000 x 3001 and an all-masked 64 x 256; at the main shape, exact
    duplicate destinations planted on both sides of every slice boundary
    must give exactly the lower index, and two launches the same words.
    Returns the record of the main shape."""
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

    src, dst, mask, _ = main
    n, m = src.shape[0], dst.shape[0]
    slices, slice_len = nn_cuda.slice_plan(n, m)
    tsrc, tdst, tmask = src.clone(), dst.clone(), mask.clone()
    lower = []
    for k, b in enumerate(range(slice_len, slices * slice_len, slice_len)):
        p = torch.from_numpy(rng.normal(size=3).astype(np.float32) * 5).to(dev)
        tdst[b - 2] = p
        tdst[b + 1] = p
        tmask[b - 2] = tmask[b + 1] = True
        tsrc[3 * k] = p  # on the point: the expansion may round d2 below 0
        tsrc[3 * k + 1: 3 * k + 3] = p + 1e-3 * torch.from_numpy(
            rng.normal(size=(2, 3)).astype(np.float32)).to(dev)
        lower.append((3 * k, b - 2))
    i1, d1 = nn_cuda.nearest_neighbors_cuda(tsrc, tdst, tmask)
    i2, d2 = nn_cuda.nearest_neighbors_cuda(tsrc, tdst, tmask)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(d1.view(torch.int32), d2.view(torch.int32))):
        raise AssertionError("nn: two launches on the same inputs differ")
    got = i1.cpu().numpy()
    if not all(np.all(got[k: k + 3] == j) for k, j in lower):
        raise AssertionError("nn: a tie across a slice boundary did not give the lower index")
    print(f"  nn {n}x{m}: {slices} slices of {slice_len}; {len(lower)} planted ties across "
          f"slice boundaries give the lower index; two launches bit-identical")

    err = main[3]
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


def _gather_bytes(idx_np, d, c, valid=None, idx_itemsize=None):
    """HBM bytes a row gather must move: the distinct 32-byte sectors of the
    rows it reads (after the wrap/clamp rule), the index (and mask) read and
    the output write."""
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes

    i = idx_np.astype(np.int64)
    i = np.clip(np.where(i < 0, i + c, i), 0, c - 1)
    if valid is not None:
        i = i[valid]
    n = len(idx_np)
    return (sector_bytes(i, d) + n * (idx_itemsize or idx_np.itemsize)
            + (n if valid is not None else 0) + n * d * 4)


def check_gather(dev, seed: int):
    """The row gather against its plain version, bit for bit: the
    association's reads of a 2^19-slot map — the (C, 10) moments (with and
    without the found-mask), the (C,) int32 fingerprints, the (C, 3) int32
    voxel coordinates — with 8192 indices; the (2^19, 16) and (2^14, 16)
    tables of experiments A and B; a ragged 1000 x 3 case with negative and
    out-of-range indices. Each is timed over 10 fresh index sets beside the
    plain version and ``torch.index_select``. Returns the record of the
    moment read (the kernels line) and every case's record."""
    import torch

    from fastliosam_tpu_torch.ops import gather_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    C, N = 1 << 19, 8192
    cases = [  # name, table shape, dtype, n, index dtype, masked, out of range
        ("moments", (C, 10), np.float32, N, np.int64, False, False),
        ("moments_found_mask", (C, 10), np.float32, N, np.int64, True, False),
        ("fingerprints", (C,), np.int32, N, np.int64, False, False),
        ("voxel_coords", (C, 3), np.int32, N, np.int64, False, False),
        ("exp_A", (C, 16), np.float32, N, np.int32, False, False),
        ("exp_B", (1 << 14, 16), np.float32, N, np.int32, False, False),
        ("ragged", (1000, 3), np.int32, 1000, np.int32, True, True),
    ]
    rng = np.random.default_rng(seed)
    records = {}
    for name, shape, dtype, n, idx_dtype, masked, oor in cases:
        c = shape[0]
        d = shape[1] if len(shape) == 2 else 1
        if dtype == np.int32:
            tab = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
        else:
            tab = rng.normal(size=shape).astype(np.float32)
        table = torch.from_numpy(tab).to(dev)
        lo, hi = (-2 * c, 2 * c) if oor else (0, c)
        idx_np = [rng.integers(lo, hi, size=n).astype(idx_dtype) for _ in range(10)]
        val_np = [rng.uniform(size=n) > 0.3 for _ in range(10)] if masked else [None] * 10
        idx = [torch.from_numpy(a).to(dev) for a in idx_np]
        val = [None if v is None else torch.from_numpy(v).to(dev) for v in val_np]
        got = gather_cuda.gather_rows_cuda(table, idx[0], val[0])
        want = gather_cuda.gather_rows_ref(table, idx[0], val[0])
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32)):
            raise AssertionError(f"gather_rows {name}: kernel and plain version differ")
        sets = list(zip(idx, val))
        ms = device_ms(lambda i, v: gather_cuda.gather_rows_cuda(table, i, v), sets)
        plain_ms = device_ms(lambda i, v: gather_cuda.gather_rows_ref(table, i, v), sets)
        library_ms = None
        if not masked and not oor:  # one library call computes the same function
            library_ms = device_ms(lambda i: torch.index_select(table, 0, i),
                                       [(i,) for i in idx])
        nbytes = _gather_bytes(idx_np[0], d, c, val_np[0])
        rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "library_ms": library_ms, "table": list(shape), "n": n, "bytes": nbytes}
        records[name] = rec
        lib = "n/a (masked)" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  gather_rows {name} {shape} x {n}: equal, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_select {lib}, bound {rec['bound_ms']:.5f} ms "
              f"({nbytes} HBM bytes)")
    main = {k: records["moments"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
    return main, records


def check_assoc(dev, feed, n_map_scans: int = 20, reps: int = 10):
    """The association kernel against its plain version, bit for bit: the
    engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``SlamEngine.process``, 2 probes), queried with 8192 points of each of
    its last ``reps`` scans at the engine's poses (world frame, not
    deskewed), in the merged3 pools (3 per query). Timed over those fresh
    query sets beside the plain version. Returns the record (the kernels
    line)."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import assoc_cuda
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes
    from fastliosam_tpu_torch.utils.timing import device_ms

    engine = make_engine(dev)
    run_engine(engine, feed, dev, n_map_scans)
    m, cfg = engine.odom.vmap, engine.map_cfg
    rng = np.random.default_rng(n_map_scans)
    sets, nbytes = [], []
    fp_np = m.fp.cpu().numpy()
    for k in range(n_map_scans - reps, n_map_scans):
        # scan k's points at the engine's pose of scan k, as its iEKF queries them
        pose = torch.from_numpy(np.asarray(engine.realtime_traj[k], np.float32)).to(dev)
        keep = np.nonzero(feed["mask"][k])[0]
        pick = torch.from_numpy(np.sort(rng.choice(keep, 8192, replace=False))).to(dev)
        xyz = torch.from_numpy(feed["xyz"][k]).to(dev)[pick] @ pose[:3, :3].T + pose[:3, 3]
        coords0, pools = vh.merged3_pools(xyz, cfg.voxel_size)
        mask = torch.ones(8192, dtype=torch.bool, device=dev)
        sets.append((pools, coords0, mask))
        # HBM bytes: the probed fingerprint sectors and the found rows'
        # sectors (distinct), the coordinates and mask read, the output
        h0 = vh._hash(pools, cfg.capacity).to(torch.int64).cpu().numpy().reshape(-1)
        want = vh._fingerprint(pools).cpu().numpy().reshape(-1)
        cand = (h0[:, None] + np.arange(cfg.query_probes)) & (cfg.capacity - 1)
        hit = fp_np[cand] == want[:, None]
        found = cand[hit.any(1), hit[hit.any(1)].argmax(1)]
        nbytes.append(sector_bytes(cand.reshape(-1), 1) + sector_bytes(found, 10)
                      + pools.numel() * 4 + coords0.numel() * 4 + 8192 + 8192 * 13 * 4)
    args = (m.fp, m.moments)
    tail = (cfg.voxel_size, cfg.query_probes)
    found_share = []
    for pools, coords0, mask in sets:
        got = assoc_cuda.merged_moments_cuda(*args, pools, coords0, mask, *tail)
        want = assoc_cuda.merged_moments_ref(*args, pools, coords0, mask, *tail)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("merged_moments: kernel and plain version differ")
        found_share.append(float((got[:, 0] > 0).float().mean()))
    ms = device_ms(lambda p, c, k: assoc_cuda.merged_moments_cuda(*args, p, c, k, *tail), sets)
    plain_ms = device_ms(lambda p, c, k: assoc_cuda.merged_moments_ref(*args, p, c, k, *tail),
                         sets)
    bound_ms = float(np.mean(nbytes)) / H100_BYTES_PER_S * 1e3
    print(f"  merged_moments (2^{cfg.capacity.bit_length() - 1}-slot map after {n_map_scans} "
          f"figure-8 scans) 8192 x 3 pools x "
          f"{cfg.query_probes} probes, {reps} query sets: equal, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({np.mean(nbytes):.0f} HBM bytes), "
          f"voxels found {np.mean(found_share):.1%} of queries; "
          f"map holds {int((fp_np != 0).sum())} voxels")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no single PyTorch call probes a hash table and merges moments"}


def experiment_phase(dev):
    """The gather experiment entry point, once: the path of take_along_axis
    (its launch count is read around this run). Returns the record of the
    map-size take_along_axis (the kernels line), the launches and every
    experiment's record."""
    from fastliosam_tpu_torch.ops import KERNEL_MODULES
    from fastliosam_tpu_torch.scripts import exp_gather

    for mod in KERNEL_MODULES:
        mod.reset_launches()
    recs = exp_gather.run(dev, print_fn=lambda line: print("  " + line))
    launches = {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}
    big = next(r for r in recs if r["name"] == "tal_big")
    main = {"max_abs_err": 0.0, **{k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")}}
    return main, launches, recs


# ---------------------------------------------------------------------------
# feeds (made in worker processes while the kernels build)
# ---------------------------------------------------------------------------
def _pack(data, traj) -> dict:
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
    if data["gps"]:
        feed["gps_t"] = np.asarray([g[0] for g in data["gps"]], np.float64)
        feed["gps_xyz"] = np.stack([g[1] for g in data["gps"]]).astype(np.float64)
    return feed


def _cached_feed(name: str, build) -> str:
    """Make the feed once and cache it under build/; returns its path."""
    cache = ROOT / "build" / f"chip_smoke_{name}.npz"
    if not cache.exists():
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npz")
        np.savez(tmp, **build())
        tmp.replace(cache)
    return str(cache)


def figure8_feed(n_scans: int, seed: int = 11) -> str:
    """The bench's loop-closing feed (``bench.py: build_fig8_sequence``): a
    lemniscate through a 60 m room, 2048 azimuths x 16 rings at 10 Hz, IMU
    at 200 Hz."""
    def build():
        from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

        world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=seed)
        traj = Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
        cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0,
                        gyro_noise=0.001, acc_noise=0.01, seed=seed, time_groups=32)
        return _pack(simulate_sequence(world, traj, cfg, n_scans=n_scans), traj)

    return _cached_feed(f"fig8_{n_scans}_{seed}", build)


def corridor_feed(n_scans: int, seed: int = 3) -> str:
    """The bench's GPS corridor (``bench.py: build_corridor_sequence``): a
    400 m corridor whose planes are all ⊥ x beyond its clutter, a straight
    run at 6 m/s with a strong accelerometer bias, 2048 x 16 rays to 60 m,
    GPS at 10 Hz with 0.3 m noise."""
    def build():
        from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

        world = PlaneWorld.corridor(length=400.0, width=8.0, height=5.0, n_clutter=8,
                                    clutter_span=15.0, seed=seed)
        traj = Trajectory.straight(speed=6.0)
        cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=60.0,
                        gyro_noise=0.001, acc_noise=0.01, acc_bias=(0.08, -0.03, 0.04),
                        seed=seed, time_groups=32, gps_rate=10.0, gps_noise=0.3)
        return _pack(simulate_sequence(world, traj, cfg, n_scans=n_scans), traj)

    return _cached_feed(f"corridor_{n_scans}_{seed}", build)


def load_feed(path: str) -> dict:
    with np.load(path) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# engine phases
# ---------------------------------------------------------------------------
def make_engine(dev, max_kf: int = 128, max_between: int = 256, max_gps: int = 64,
                chunk: int = 5):
    """The bench's pipeline configuration (``bench.py: make_engine_for``)."""
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
        pgo_cfg=PoseGraphConfig(max_keyframes=max_kf, max_between=max_between,
                                max_gps=max_gps),
        cfg=EngineConfig(keyframe_threshold=1.0, loop_check_every=chunk,
                         kf_cloud_points=4096, kf_cloud_voxel=0.3),
        device=dev,
    )


def _start(engine, feed, dev):
    """reset() at the feed's initial state; the feed staged on the card (as
    the bench stages its chunks)."""
    import torch

    engine.reset()
    engine.odom = engine.odom._replace(nav=engine.odom.nav._replace(
        R=torch.from_numpy(feed["R0"]).to(dev), p=torch.from_numpy(feed["p0"]).to(dev),
        v=torch.from_numpy(feed["v0"]).to(dev)))
    return {k: torch.from_numpy(np.asarray(feed[k])).to(dev)
            for k in ("xyz", "toff", "mask", "imu_t", "imu_g", "imu_a", "imu_m")}


class _Probe:
    """Host time, host reads and NN launches inside the engine's loop
    verification, loop resolution and solve (wrapped on the instance)."""

    NAMES = ("_launch_verify", "_resolve_pending_loop", "_solve")

    def __init__(self, engine):
        self.engine = engine
        self.s = {n: 0.0 for n in self.NAMES}
        self.reads = {n: 0 for n in self.NAMES}
        self.calls = {n: 0 for n in self.NAMES}
        self.verify_reads, self.verify_nn = [], []

    def __enter__(self):
        from fastliosam_tpu_torch.ops import nn_cuda
        from fastliosam_tpu_torch.utils import host_reads

        self.saved = {n: getattr(self.engine, n) for n in self.NAMES}

        def wrap(name, fn):
            def call(*args):
                t0, r0, l0 = time.perf_counter(), host_reads(), nn_cuda.launches
                try:
                    return fn(*args)
                finally:
                    self.s[name] += time.perf_counter() - t0
                    self.reads[name] += host_reads() - r0
                    self.calls[name] += 1
                    if name == "_launch_verify":
                        self.verify_reads.append(host_reads() - r0)
                        self.verify_nn.append(nn_cuda.launches - l0)
            return call

        for n, fn in self.saved.items():
            setattr(self.engine, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            delattr(self.engine, n)  # back to the class's methods
        return False


def _start_profile():
    """Start ``torch.profiler`` on the device's activity after draining the
    queue; returns it and the host clock. Only device rows are read, and
    recording the host's operations too would cost tens of seconds per
    window (the host's are recorded only in a rehearsal on the CPU)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof, time.perf_counter()


def run_engine(engine, feed, dev, n_scans: int, profile_from=None):
    """Drive ``engine.process`` over the feed. Returns host times, the
    per-verification host reads and NN launches; with ``profile_from`` the
    scans from that index on run under ``torch.profiler``."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan

    g = _start(engine, feed, dev)
    prof = None
    with _Probe(engine) as probe:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n_scans):
            if k == profile_from:
                prof, t_prof = _start_profile()
            scan = Scan(g["xyz"][k], g["toff"][k], g["mask"][k])
            imu = ImuBatch(g["imu_t"][k], g["imu_g"][k], g["imu_a"][k], g["imu_m"][k])
            engine.process(scan, imu, float(feed["stamps"][k]), float(feed["scan_dt"]))
        engine.finish()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    timing = {"total_s": total, "verify_s": probe.s["_launch_verify"],
              "solve_s": probe.s["_solve"], "verify_syncs": probe.verify_reads,
              "verify_nn": probe.verify_nn}
    if prof is not None:
        prof.__exit__(None, None, None)
        timing["prof"], timing["prof_wall_s"] = prof, time.perf_counter() - t_prof
        timing["prof_scans"] = n_scans - profile_from
    return timing


def run_chunks(engine, feed, dev, chunk: int, deferred: bool, fixes=None, profile_from=None):
    """Drive ``process_chunk`` (or its deferred form) over the feed in
    chunks, as ``bench.py: _run_pipeline`` does, with the GPS fixes of each
    chunk's time span. Returns host time and the host reads inside loop
    verification, loop resolution and solves; with ``profile_from`` the
    chunks from that index on run under ``torch.profiler``."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan
    from fastliosam_tpu_torch.utils import host_reads

    g = _start(engine, feed, dev)
    n = (len(feed["stamps"]) // chunk) * chunk
    dt = float(feed["scan_dt"])
    step = engine.process_chunk_deferred if deferred else engine.process_chunk
    prof = None
    with _Probe(engine) as probe:
        torch.cuda.synchronize()
        r0, t0 = host_reads(), time.perf_counter()
        for c in range(0, n, chunk):
            if profile_from is not None and c == profile_from * chunk:
                prof, t_prof = _start_profile()
            sl = slice(c, c + chunk)
            stamps = feed["stamps"][sl]
            lo, hi = float(stamps[0]) - dt, float(stamps[-1])
            gps = None if fixes is None else [f for f in fixes if lo <= f.stamp < hi]
            step(Scan(g["xyz"][sl], g["toff"][sl], g["mask"][sl]),
                 ImuBatch(g["imu_t"][sl], g["imu_g"][sl], g["imu_a"][sl], g["imu_m"][sl]),
                 stamps, dt, gps=gps)
        engine.finish()
        torch.cuda.synchronize()
        total, reads = time.perf_counter() - t0, host_reads() - r0
    out = {"total_s": total, "scans": n, "chunks": n // chunk, "host_reads": reads,
           "loop_and_solve_reads": sum(probe.reads.values()),
           "solve_s": probe.s["_solve"], "verify_s": probe.s["_launch_verify"]}
    if prof is not None:
        prof.__exit__(None, None, None)
        out["prof"], out["prof_wall_s"] = prof, time.perf_counter() - t_prof
        out["prof_scans"] = n - profile_from * chunk
    return out


def _ate(engine, feed) -> float:
    rt = np.stack(engine.realtime_traj)[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum((rt - feed["gt_p"][: len(rt)]) ** 2, axis=1))))


def _launch_counts(fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just before;
    returns its result and the counts read just after."""
    from fastliosam_tpu_torch.ops import KERNEL_MODULES

    for mod in KERNEL_MODULES:
        mod.reset_launches()
    out = fn()
    return out, {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}


def _per_scan(launches, scans) -> dict:
    """The association's kernels per scan: gather_rows (the insert's table
    reads) and merged_moments (one per association)."""
    return {name: launches[name] / scans for name in ("gather_rows", "merged_moments")}


def _window_ops(run, top: int = 6) -> float:
    """Device operations per scan over the profiled window of ``run``."""
    return profile_summary(run["prof"], run["prof_wall_s"], run["prof_scans"],
                           top=top)["device_ops_per_scan"]


def _replay(engine, first) -> bool:
    """The replay check of a second run from reset(): bit-identical realtime
    trajectory and the same loop pairs."""
    traj, loops = first
    return np.array_equal(np.stack(engine.realtime_traj), traj) and engine.loop_pairs == loops


def _fail(phase, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} failed: " + ", ".join(failed))


def per_scan_phase(dev, feed):
    import torch

    from fastliosam_tpu_torch.utils import host_read, host_reads, reset_host_reads

    n_scans = len(feed["stamps"])
    engine = make_engine(dev)
    run_engine(engine, feed, dev, min(12, n_scans))  # warm-up: allocator, cuBLAS
    reset_host_reads()
    timing, launches = _launch_counts(lambda: run_engine(engine, feed, dev, n_scans))
    syncs = host_reads()
    ate = _ate(engine, feed)
    matched = host_read(torch.stack(engine.match_counts))
    first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
    n_verify = len(engine.loop_attempts)
    verify_n = len(timing["verify_syncs"])
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
                                        if verify_n else None),
        "nn_launches_per_verification": (float(np.mean(timing["verify_nn"]))
                                         if verify_n else None),
        "verify_ms_each": 1e3 * timing["verify_s"] / verify_n if verify_n else None,
        "solve_ms_each": (1e3 * timing["solve_s"] / engine.solve_count
                          if engine.solve_count else None),
        "host_s": {k: timing[k] for k in ("total_s", "verify_s", "solve_s")},
        "ate_m": ate,
        "min_matched_after_scan2": int(matched[2:].min()),
        "loop_pairs": first[1],
    }
    result["launches_per_scan"] = _per_scan(launches, n_scans)
    poses = np.stack(engine.realtime_traj)
    window = min(50, n_scans)
    # the replay; its last 50 scans are traced (tracing changes no result)
    replay = run_engine(engine, feed, dev, n_scans, profile_from=n_scans - window)
    result["replay_bit_identical"] = _replay(engine, first)
    result["device_ops_per_scan"] = _window_ops(replay)
    print("  " + json.dumps(result))
    _fail("per-scan phase", {
        "every pose finite": bool(np.all(np.isfinite(poses)))
        and bool(np.all(np.isfinite(engine.keyframe_poses()))),
        "n_matched > 500 after scan 2": result["min_matched_after_scan2"] > 500,
        "at least one verification": n_verify >= 1,
        "nearest_neighbors, gather_rows and merged_moments launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments")) > 0,
        "ATE < 0.10 m": ate < 0.10,
        "replay bit-identical": result["replay_bit_identical"],
    })
    return result


def profile_phase(dev, feed, profile_scans: int):
    """An extra per-scan run whose last ``profile_scans`` scans run under
    ``torch.profiler``; it comes after every other phase (tracing slows the
    host for a while after it ends) and touches no launch count read."""
    n_scans = len(feed["stamps"])
    engine = make_engine(dev)
    run_engine(engine, feed, dev, min(12, n_scans))  # warm-up
    start = max(0, n_scans - profile_scans)
    run = run_engine(engine, feed, dev, n_scans, profile_from=start)
    return profile_summary(run["prof"], run["prof_wall_s"], n_scans - start)


def chunked_phase(dev, feed, chunk: int = 5):
    """process_chunk_deferred over the loop feed, twice from reset()."""
    engine = make_engine(dev, chunk=chunk)
    run, launches = _launch_counts(
        lambda: run_chunks(engine, feed, dev, chunk, deferred=True))
    first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
    odom_reads = run["host_reads"] - run["loop_and_solve_reads"]
    result = {
        "scans": run["scans"], "chunk": chunk, "defer_depth": engine.cfg.defer_depth,
        "scans_per_s": run["scans"] / run["total_s"],
        "keyframes": engine.kf.n, "loops": len(engine.loop_pairs),
        "verifications": len(engine.loop_attempts), "solves": engine.solve_count,
        "launches": launches,
        "host_syncs_per_chunk": run["host_reads"] / run["chunks"],
        "odom_keyframe_reads_per_chunk": odom_reads / run["chunks"],
        "host_s": {k: run[k] for k in ("total_s", "verify_s", "solve_s")},
        "ate_m": _ate(engine, feed), "loop_pairs": first[1],
    }
    result["launches_per_scan"] = _per_scan(launches, run["scans"])
    poses = np.stack(engine.realtime_traj)
    # the replay; its last 10 chunks are traced (tracing changes no result)
    replay = run_chunks(engine, feed, dev, chunk, deferred=True,
                        profile_from=max(0, run["chunks"] - 10))
    result["replay_bit_identical"] = _replay(engine, first)
    result["device_ops_per_scan"] = _window_ops(replay)
    print("  " + json.dumps(result))
    _fail("chunked phase", {
        "every pose finite": bool(np.all(np.isfinite(poses))),
        "ATE < 0.10 m": result["ate_m"] < 0.10,
        "at least one loop": result["loops"] >= 1,
        "<= 1 host read per chunk for odometry + keyframing":
            result["odom_keyframe_reads_per_chunk"] <= 1.0,
        "nearest_neighbors, gather_rows and merged_moments launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments")) > 0,
        "replay bit-identical": result["replay_bit_identical"],
    })
    return result


def gps_fixes(feed, anchor=(22.3193, 114.1694, 10.0)):
    """The corridor's world-frame fixes as GpsFix records through WGS84
    geodesy from the bench's anchor (``bench.py: _fixes_from_data``)."""
    import torch

    from fastliosam_tpu_torch.core.geodesy import LocalCartesian
    from fastliosam_tpu_torch.runtime import GpsFix

    lc = LocalCartesian.from_origin(*anchor)
    lat, lon, alt = (t.numpy() for t in lc.reverse(
        torch.from_numpy(feed["gps_xyz"].astype(np.float32))))
    return [GpsFix(stamp=float(ts), lat=float(a), lon=float(b), alt=float(h),
                   cov_xyz=(0.25, 0.25, 1.0))
            for ts, a, b, h in zip(feed["gps_t"], lat, lon, alt)]


def gps_phase(dev, feed, chunk: int = 5):
    """The bench's corridor (``bench.py: bench_gps_corridor``): process_chunk
    with GPS off, then on with the bench's GPS configuration."""
    engine = make_engine(dev, max_kf=256, max_between=512, max_gps=256, chunk=chunk)
    n_chunks = len(feed["stamps"]) // chunk
    # the GPS-off run's last 5 chunks are traced (no solve runs there)
    off, launches_off = _launch_counts(
        lambda: run_chunks(engine, feed, dev, chunk, deferred=False,
                           profile_from=max(0, n_chunks - 5)))
    ate_off = _ate(engine, feed)
    fixes = gps_fixes(feed)
    engine.pgo_cfg = engine.pgo_cfg._replace(gps_huber_delta=2.0)
    engine.cfg = engine.cfg._replace(use_gps=True, gps_dist_thres=2.0, gps_noise_floor=0.25,
                                     odom_trans_sqrt_info=50.0, odom_rot_sqrt_info=1000.0)
    on, launches = _launch_counts(
        lambda: run_chunks(engine, feed, dev, chunk, deferred=False, fixes=fixes))
    poses = np.stack(engine.realtime_traj)
    result = {
        "scans": on["scans"], "chunk": chunk, "fixes": len(fixes),
        "ate_gps_off_m": ate_off, "ate_gps_on_m": _ate(engine, feed),
        "gps_factors": int(engine.graph.n_gps), "solves": engine.solve_count,
        "keyframes": engine.kf.n, "launches": launches, "launches_gps_off": launches_off,
        "scans_per_s_gps_off": off["scans"] / off["total_s"],
        "scans_per_s_gps_on": on["scans"] / on["total_s"],
        "solve_ms_each": 1e3 * on["solve_s"] / max(engine.solve_count, 1),
        "host_syncs_per_chunk": on["host_reads"] / on["chunks"],
        "launches_per_scan": _per_scan(launches, on["scans"]),
        "launches_per_scan_gps_off": _per_scan(launches_off, off["scans"]),
        "device_ops_per_scan_gps_off": _window_ops(off),
    }
    print("  " + json.dumps(result))
    print(f"  corridor ATE: GPS off {ate_off:.4f} m, GPS on {result['ate_gps_on_m']:.4f} m "
          f"(accuracy reference, JAX engine on a TPU over 400 scans: 1.8293 / 1.8664 m)")
    _fail("GPS phase", {
        "at least 2 GPS factors": result["gps_factors"] >= 2,
        "at least 1 solve": result["solves"] >= 1,
        "every pose finite": bool(np.all(np.isfinite(poses))),
        "ATE with GPS < 2.0 m": result["ate_gps_on_m"] < 2.0,
        "gather_rows and merged_moments launched":
            launches["gather_rows"] > 0 and launches["merged_moments"] > 0,
    })
    return result


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=150, help="figure-8 scans to run")
    ap.add_argument("--corridor-scans", type=int, default=400, help="GPS corridor scans")
    ap.add_argument("--chunk", type=int, default=5, help="scans per chunk")
    ap.add_argument("--seed", type=int, default=0, help="seed of the kernel inputs")
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    ap.add_argument("--profile-scans", type=int, default=0,
                    help="trace the last N scans of an extra per-scan run with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    print(card_line())
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from fastliosam_tpu_torch.ops import KERNEL_MODULES, build
    from fastliosam_tpu_torch.utils import geometry_precision

    # the feeds take minutes of host time: two worker processes make them
    # while the kernels build and the kernel phase runs; the pool is shut
    # down before the engine phases, which are host-bound
    with ProcessPoolExecutor(max_workers=2,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        fig8_job = pool.submit(figure8_feed, args.scans)
        corridor_job = pool.submit(corridor_feed, args.corridor_scans)

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
            kernels["gather_rows"], gather_cases = check_gather(dev, args.seed)
            print("experiment entry point (fastliosam_tpu_torch.scripts.exp_gather):")
            kernels["take_along_axis"], exp_launches, exp_recs = experiment_phase(dev)
            _fail("experiment entry point", {
                "take_along_axis launched": exp_launches["take_along_axis"] > 0})
        t0 = time.perf_counter()
        fig8 = load_feed(fig8_job.result())
        corridor = load_feed(corridor_job.result())
    print(f"feeds: figure-8 {len(fig8['stamps'])} x {fig8['xyz'].shape[1]} points, "
          f"corridor {len(corridor['stamps'])} scans, {len(corridor['gps_t'])} fixes "
          f"({time.perf_counter() - t0:.1f} s more to wait for)")

    with geometry_precision():
        print("kernel phase, association (on the figure-8 map):")
        kernels["merged_moments"] = check_assoc(dev, fig8)
        print("per-scan phase (SlamEngine.process):")
        per_scan = per_scan_phase(dev, fig8)
        print(f"chunked phase (SlamEngine.process_chunk_deferred, chunk {args.chunk}):")
        chunked = chunked_phase(dev, fig8, args.chunk)
        print(f"GPS phase (corridor, SlamEngine.process_chunk, chunk {args.chunk}):")
        gps = gps_phase(dev, corridor, args.chunk)
        if args.profile_scans > 0:
            print(f"profile (SlamEngine.process, last {args.profile_scans} scans):")
            per_scan["profile"] = profile_phase(dev, fig8, args.profile_scans)

    paths = {"per_scan": per_scan["launches"], "chunked": chunked["launches"],
             "gps": gps["launches"], "exp_gather": exp_launches}
    line = {"kernels": []}
    for mod in KERNEL_MODULES:
        rec = dict(mod.KERNEL)
        name = rec["name"]
        rec["launches"] = sum(p[name] for p in paths.values())
        rec["launches_by_path"] = {k: p[name] for k, p in paths.items()}
        rec.update(kernels[name])
        line["kernels"].append(rec)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card_line(), "kernels": line["kernels"], "gather_cases": gather_cases,
             "exp_gather": exp_recs, "per_scan": per_scan, "chunked": chunked, "gps": gps,
             "total_s": time.perf_counter() - t_start},
            indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
