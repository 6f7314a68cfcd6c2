#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastliosam_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds and runs there.

    python3 chip_smoke.py [--scans 150] [--corridor-scans 200] [--out results.json]
                          [--profile-scans N]

Phases, each of which fails the script (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi); the two sim feeds start
     generating in two worker processes (they take ~1-2 minutes of host
     time and are cached under build/), the recording of phase 9 after
     them in one of the two (at nice 10), and the KITTI sequence of phase 8
     in its own worker processes;
  2. build every CUDA kernel of the package from ``fastliosam_tpu_torch/csrc``
     (one nvcc per source, all started together) into ``build/kernels/``;
  3. kernel phase: the timing floor first (an empty kernel, ``csrc/empty.cu``,
     at 1 and 132 blocks, timed as the kernels are); each kernel against
     its plain PyTorch version on the card
     at the main path's shapes plus ragged ones (the gathers, the
     association and the insert bit for bit; the nearest neighbours also
     on ties planted across its destination slices, and twice for
     identical words), timed with CUDA events around back-to-back device
     work (fresh indices or queries; ``utils/timing.py``) beside the
     plain version, a one-call PyTorch yardstick that the port never calls
     (where one exists), and its bound; then the gather experiment entry
     point (``fastliosam_tpu_torch.scripts.exp_gather``), the path of
     ``take_along_axis``, with its random-read ceiling probe; the row
     gather (``gather_rows``), the association kernel (``merged_moments``,
     merged3 and merged2 pools), the map insert's kernel (``insert_claim``)
     and the cached-plane query (``query_cached``) are checked once the
     figure-8 feed is made: the gather on the loop closure's plane-refresh
     reads of submaps around the engine's keyframes after 30 scans and on
     the point-to-plane ICP's row reads of those submaps, the
     association and the insert on the engine's own 2^19-slot map after 20
     scans (the association also in the merged stencil at 4 probes and the
     insert at 4 rounds, run_slam's map configuration; the insert also on
     a tight table that drops points and on an evicted map), the cached
     query on that map with its planes fitted (8192 queries, 2 probes) and
     on the submaps' surfel maps (16,384
     queries, 2^14 slots, 4 probes), plus ragged, all-masked, not-found
     and tight-table queries;
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
     build_corridor_sequence`` and ``bench_gps_corridor``; 200 of its 400
     scans by default, to keep the script inside its time), fixes through
     WGS84 geodesy, ``process_chunk`` with GPS off and on; with GPS on at
     least two GPS factors, a solve, and ATE < 2.0 m;
  7. modes phase: the figure-8 feed at the same width with the other query
     and loop-ICP modes: ``process`` per scan with the cached-plane query
     and point-to-plane loop ICP, and ``process_chunk_deferred`` with the
     merged2 query and the multi-start loop ICP of ``bench.py:
     bench_kitti_rich``; each twice from ``reset()`` (replay bit for bit),
     ATE < 0.10 m, more than 500 matches a scan from scan 3 on, a
     verification;
  8. KITTI phase, the dataset entry point at the bench's width and depth
     (``bench.py: bench_kitti_longrun``): ``drive_kitti`` over the
     1160-scan synthetic KITTI circuit read by the native reader (q16
     upload, chunk 5, deferred), with a loop audit against ground truth,
     and the same run loop-free;
     ``save_results`` with its files checked;
     a checkpoint at scan 300 that a restored engine must continue over
     scans 300-400 bit for bit with the engine that saved it;
     ``MapLocalizer`` on the exported bundle (global init from a pose
     perturbed by 1 m and 5 degrees, 200 scans, every step matching
     points); and the NN, insert and row gather against their plain
     versions at the localizer's shapes (8192 x 2^19, 65,536 points, (2^19,
     10|3) x 65,536), printed under ``at_localizer_shape``;
  9. bag phase, the ROS-bag entry point through the port's CLI
     (``run_slam.run``, the body of ``run_slam.main``): the figure-8
     world and path of phases 4-7, started from rest, rendered at Ouster
     OS1-64 width (1024 x 64 rays, 65,536 points a scan, 150 scans, IMU at
     100 Hz) in the ``newer-college2020`` preset's LiDAR frame and written
     as the Ouster driver publishes it (``sim/writers.py``), run with
     ``--dataset bag --preset newer-college2020`` at the default 131,072
     points of capacity, twice (bit-identical trajectories and loop pairs;
     ATE < 0.10 m; a verification; the replay traced); then ``--dataset
     mulran --use-gps`` over the first 50 scans written as a MulRan
     directory (GPS factors; ATE gated) and ``--dataset newer-college``
     over their bag (the decoded scans and IMU equal ``BagSequence``'s);
 10. batched phase, the data-parallel rollout (``eval/batch_eval.py:
     batched_rollout``, the JAX package's ``vmap`` of ``odom_rollout``):
     8 lanes x 75 scans of the figure-8 feed at the per-scan phase's
     ``OdomConfig`` and map (32,768 points a scan, 8192 iEKF points,
     merged3, a 2^19-slot map per lane), lane b over scans [10 b, 10 b +
     75) from the ground truth's pose and velocity there, every step one
     pass over all lanes. Gates: each lane's ATE below max(0.10 m, the JAX
     package's reading for its window + 1 cm) (the reference reads
     0.11-0.18 m on three windows started mid-path from an empty map, whose
     first scans starve merged3's association, 0.02 m from scan 0;
     ``tests/test_torch_batch_eval.py``, slow); more than 500
     matches a scan in every lane from scan 3 on; the replay bit for bit
     (its last 15 steps traced: device operations a batched step and the
     device's idle share); lane isolation (a batch whose lane 7 carries
     lane 0's window leaves lanes 0-6 bit for bit and gives lane 7 lane
     0's bits); lane 0 within 5 mm of the unbatched ``odom_rollout`` of its
     window over the first 4 scans (the largest difference over the window
     printed); ``merged_moments`` and ``insert_claim`` launched as many
     times a step at 8 lanes as at 1; and a cached-mode batch (8 lanes x
     20 scans, ATE gated as above) that launches ``query_cached``, ``gather_rows``
     and ``insert_claim``. Printed: lane-scans/s, peak device memory. Then
     the map kernels at the lane shapes, on the rollout's 8 maps: each bit
     for bit with its lane-batched plain version and, lane by lane, with
     the unbatched kernel on that lane's table alone, timed beside the
     timing floor and its byte bound (``merged_moments`` 8 x 8192 x 3 pools
     x 2 probes and a ragged 3 x 5000; ``insert_claim`` 8 x 8192 and 32 x
     8192 points, 2 rounds, one cooperative launch each; ``query_cached``
     8 x 8192; ``gather_rows`` of (8, 2^19, 10) rows at 8 x 8192 slots,
     beside ``torch.gather`` of the same rows), printed under ``at_lanes``
     in the kernels line.
Every kernel's launch count is set to 0 just before each path and read
just after; each kernel must have launched on its path (the nearest
neighbours and the row gather (the loop closure's plane refresh) on the
loop-closing phases 4 and 5, the association and the insert on 4-6,
all four on the KITTI long run and the localizer, take_along_axis on the
experiment entry point; in phase 7 the cached query, the insert, the row
gather and the NN on the cached run and the association, the insert and
the NN on the merged2 run; the association, the insert, the row gather
and the NN on the bag run of phase 9; the association and the insert on
the batched rollout of phase 10, the cached query, the row gather and the
insert on its cached-mode batch). Phases 4-6 and 9 report the
insert's, the association's and the row gather's launches per scan, and
device operations per scan over a window traced with ``torch.profiler``
(the last 50 scans of the replay in 4 and 5, the last 25 of the GPS-off
run in 6, the whole replay in 9; ``engine.finish()`` included). With
``--profile-scans N`` an extra per-scan run, after every phase, traces its last N scans with
``torch.profiler``; it does not touch the launch counts. The line before
the last is a JSON object describing every kernel (with the timing
floor under ``timing_floor_ms``); the last line is
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
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
KITTI_SCANS = 1160  # the bench's circuit long run (bench.py: LONGRUN_SCANS)


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


def launch_floor_ms(blocks: int) -> float:
    """Device time of an empty kernel (``csrc/empty.cu``, ``blocks`` x 256
    threads), launched through ctypes as every kernel wrapper launches its
    kernel and timed as the kernels are (:func:`cuda_ms`): the least time a
    kernel can read there."""
    import ctypes

    import torch

    from fastliosam_tpu_torch.ops import build

    fn = build.load("empty").empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(blocks, 256, stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {err}")

    return cuda_ms(launch, 10)


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


def check_gather(dev, seed: int, plane_sets, surfel_cfg):
    """The row gather against its plain version, bit for bit, at the shapes
    the main path gives it: the loop closure's plane refresh
    (``map/voxel_hash.py: _fit_planes`` on the throwaway map of
    ``loop/closure.py: _dst_surfel_map``), which reads the (2^14, 10)
    moments and the (2^14, 3) int32 voxel coordinates at the 16,384 int64
    slots of the submap's insert (``plane_sets``, one set per submap); the
    point-to-plane ICP's row reads (``loop/icp.py: icp_align_p2pl``), which
    read the submap (16,384, 3), its normals from ``query_planes`` on that
    surfel map (``surfel_cfg``) and their 1-D int32 valid flags at the
    int32 nearest-neighbour indices of a copy of the submap shifted by
    (0.2, 0.2, 0) m; and a ragged 1000 x 3 case with a found-mask and
    negative and out-of-range indices. Each is timed over its sets beside
    the plain version and (unmasked) ``torch.index_select`` (experiments A
    and B's shapes are timed by the experiment entry point). Returns the
    record of the moment read with the p2pl reads' under ``at_p2pl_rows``
    (the kernels line) and every case's record."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import gather_cuda, nn_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    p2pl = []  # (dst, normals, nvalid, nn_idx) per submap
    shift = torch.tensor([0.2, 0.2, 0.0], device=dev)
    for *_, sm, dst, dmask in plane_sets:
        nrm, _, nvalid = vh.query_planes(sm, surfel_cfg, dst, dmask)
        nn_idx = nn_cuda.nearest_neighbors((dst + shift).contiguous(), dst, dmask)[0]
        p2pl.append((dst, nrm, nvalid.to(torch.int32), nn_idx))
    rng = np.random.default_rng(seed)
    ragged = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(1000, 3),
                                           dtype=np.int64).astype(np.int32)).to(dev)
    cases = {  # name: [(table, idx, valid)] with fresh indices per set
        "plane_moments": [(mom, sl, None) for mom, _, sl, *_ in plane_sets],
        "plane_coords": [(crd, sl, None) for _, crd, sl, *_ in plane_sets],
        "p2pl_points": [(dst, i, None) for dst, _, _, i in p2pl],
        "p2pl_normals": [(nrm, i, None) for _, nrm, _, i in p2pl],
        "p2pl_nvalid": [(nv, i, None) for _, _, nv, i in p2pl],
        "ragged": [(ragged, torch.from_numpy(rng.integers(-2000, 2000, size=1000)
                                             .astype(np.int32)).to(dev),
                    torch.from_numpy(rng.uniform(size=1000) > 0.3).to(dev))
                   for _ in range(10)],
    }
    records = {}
    for name, sets in cases.items():
        for table, idx, val in sets:
            got = gather_cuda.gather_rows_cuda(table, idx, val)
            want = gather_cuda.gather_rows_ref(table, idx, val)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                          want.view(torch.int32)):
                raise AssertionError(f"gather_rows {name}: kernel and plain version differ")
        ms = device_ms(gather_cuda.gather_rows_cuda, sets)
        plain_ms = device_ms(gather_cuda.gather_rows_ref, sets)
        library_ms = None
        if name != "ragged":
            # index_select raises on the slot C of unassigned points, so it
            # reads the slots clamped to C - 1 beforehand: the same rows (the
            # nearest-neighbour indices are in range already)
            clamped = [(t, i.clamp(max=t.shape[0] - 1)) for t, i, _ in sets]
            library_ms = device_ms(lambda t, i: torch.index_select(t, 0, i), clamped)
        table, idx, val = sets[0]
        c, d = table.shape[0], (table.shape[1] if table.dim() == 2 else 1)
        nbytes = float(np.mean([_gather_bytes(i.cpu().numpy(), d, c,
                                              None if v is None else v.cpu().numpy())
                                for _, i, v in sets]))
        rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "library_ms": library_ms, "table": list(table.shape), "n": idx.shape[0],
               "index": str(idx.dtype), "sets": len(sets), "bytes": nbytes}
        records[name] = rec
        lib = "n/a (masked)" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  gather_rows {name} {tuple(table.shape)} x {idx.shape[0]} {idx.dtype}, "
              f"{len(sets)} sets: equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_select {lib}, bound {rec['bound_ms']:.5f} ms ({nbytes:.0f} HBM bytes)")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main = {k: records["plane_moments"][k] for k in keys}
    main["at_p2pl_rows"] = {name: {k: records[name][k] for k in keys}
                            for name in ("p2pl_points", "p2pl_normals", "p2pl_nvalid")}
    return main, records


def plane_refresh_sets(dev, engine, n_sets: int = 10):
    """The inputs of the loop closure's plane refresh, as
    ``loop/closure.py: _dst_surfel_map`` makes them: the submap
    (``build_submap``) around each of up to ``n_sets`` of the engine's
    keyframes (from the middle of its store) inserted into a throwaway
    2^14-slot map. Returns ``(moments (2^14, 10), coords (2^14, 3), sl
    (16,384,) int64, map, dst (16,384, 3), mask)`` for each: the tables
    after the insert, the slots it gave, and the refreshed map with the
    submap, the point-to-plane ICP's normal query; and that map's config."""
    from fastliosam_tpu_torch.loop.closure import _dst_surfel_map, build_submap
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda

    lc, kf = engine.loop_cfg, engine.kf
    lo = max(0, (kf.n - n_sets) // 2)
    out, cfg = [], None
    for centre in range(lo, min(kf.n, lo + n_sets)):
        dst, mask = build_submap(kf.clouds, kf.masks, engine.graph.poses,
                                 engine.graph.kf_valid, centre, lc)
        dst, mask = dst.contiguous(), mask.contiguous()
        m, cfg = _dst_surfel_map(dst, mask, lc)
        empty = vh.make_map(cfg, dev)
        sl = insert_cuda.insert_claim(
            empty.fp, empty.coords, empty.moments, dst, mask, cfg.voxel_size,
            max(cfg.insert_probes, cfg.claim_probes), cfg.max_points_per_voxel)[2]
        out.append((m.moments, m.coords, sl, m, dst, mask))
    return out, cfg


def figure8_map(dev, feed, n_map_scans: int = 20, n_more: int = 10):
    """The engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``SlamEngine.process``, 2 probes), its config, the engine's poses of
    the first ``n_map_scans + n_more`` scans (a second run from
    ``reset()``, which replays the first bit for bit) and the plane-refresh
    inputs of loop-closure submaps around its keyframes then with their
    surfel maps' config (``plane_refresh_sets``)."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev)
    run_engine(engine, feed, dev, n_map_scans)
    m = type(engine.odom.vmap)(*(t.clone() for t in engine.odom.vmap))
    run_engine(engine, feed, dev, n_map_scans + n_more)
    return (m, engine.map_cfg, np.stack(engine.realtime_traj).astype(np.float32),
            *plane_refresh_sets(dev, engine))


def _scan_queries(dev, feed, traj, ks, seed: int, n: int = 8192):
    """``n`` points of each scan ``k`` in ``ks`` at the engine's pose of
    scan ``k`` (world frame, not deskewed), as its iEKF queries them."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for k in ks:
        pose = torch.from_numpy(traj[k]).to(dev)
        keep = np.nonzero(feed["mask"][k])[0]
        pick = torch.from_numpy(np.sort(rng.choice(keep, n, replace=False))).to(dev)
        xyz = torch.from_numpy(feed["xyz"][k]).to(dev)[pick] @ pose[:3, :3].T + pose[:3, 3]
        out.append(xyz.contiguous())
    return out


def check_assoc(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The association kernel against its plain version, bit for bit: the
    engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``figure8_map``), queried with 8192 points of each of its last
    ``reps`` scans at the engine's poses (world frame, not deskewed), in the
    merged3 pools (3 per query), the merged2 pools (2 per query) and the
    merged stencil (7 per query, 4 probes). Each is timed over those fresh
    query sets beside the plain version. Returns the record of merged3 (the
    kernels line) with merged2's under
    ``at_merged2``, and the merged stencil's (7 pools at the map's default
    4 probes: run_slam's bag, MulRan and Newer College paths) under
    ``at_merged``."""
    import torch

    from fastliosam_tpu_torch.core import voxel
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import assoc_cuda
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, *_ = fig8
    fp_np = m.fp.cpu().numpy()
    queries = _scan_queries(dev, feed, traj, range(n_map_scans - reps, n_map_scans),
                            seed=n_map_scans)
    args = (m.fp, m.moments)
    recs = {}
    # the bench's pools and probes, and run_slam's (the merged stencil at
    # the map's default probe count: the bag, MulRan and Newer College paths)
    for mode, pools_fn, probes in (
            ("merged3", vh.merged3_pools, cfg.query_probes),
            ("merged2", vh.merged2_pools, cfg.query_probes),
            ("merged", vh.merged_pools, vh.VoxelMapConfig().query_probes)):
        tail = (cfg.voxel_size, probes)
        sets, nbytes = [], []
        for xyz in queries:
            coords0, pools = pools_fn(xyz, cfg.voxel_size)
            mask = torch.ones(8192, dtype=torch.bool, device=dev)
            sets.append((pools, coords0, mask))
            # HBM bytes: the probed fingerprint sectors and the found rows'
            # sectors (distinct), the coordinates and mask read, the output
            h0 = voxel.hash_slot(pools, cfg.capacity).to(torch.int64).cpu().numpy().reshape(-1)
            want = voxel.fingerprint(pools).cpu().numpy().reshape(-1)
            cand = (h0[:, None] + np.arange(probes)) & (cfg.capacity - 1)
            hit = fp_np[cand] == want[:, None]
            found = cand[hit.any(1), hit[hit.any(1)].argmax(1)]
            nbytes.append(sector_bytes(cand.reshape(-1), 1) + sector_bytes(found, 10)
                          + pools.numel() * 4 + coords0.numel() * 4 + 8192 + 8192 * 13 * 4)
        found_share = []
        for pools, coords0, mask in sets:
            got = assoc_cuda.merged_moments_cuda(*args, pools, coords0, mask, *tail)
            want = assoc_cuda.merged_moments_ref(*args, pools, coords0, mask, *tail)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"merged_moments {mode}: kernel and plain version differ")
            found_share.append(float((got[:, 0] > 0).float().mean()))
        ms = device_ms(lambda p, c, k: assoc_cuda.merged_moments_cuda(*args, p, c, k, *tail),
                       sets)
        plain_ms = device_ms(
            lambda p, c, k: assoc_cuda.merged_moments_ref(*args, p, c, k, *tail), sets)
        bound_ms = float(np.mean(nbytes)) / H100_BYTES_PER_S * 1e3
        n_pools = sets[0][0].shape[0]
        print(f"  merged_moments {mode} (2^{cfg.capacity.bit_length() - 1}-slot map after "
              f"{n_map_scans} figure-8 scans) 8192 x {n_pools} pools x "
              f"{probes} probes, {reps} query sets: equal, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({np.mean(nbytes):.0f} HBM bytes), "
              f"voxels found {np.mean(found_share):.1%} of queries; "
              f"map holds {int((fp_np != 0).sum())} voxels")
        recs[mode] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes", "library_ms": None, "pools": n_pools, "probes": probes,
                      "library_note": "no single PyTorch call probes a hash table and "
                                      "merges moments"}
    return dict(recs["merged3"], at_merged2=recs["merged2"], at_merged=recs["merged"])


def _cached_map(m, cfg):
    """The map with the cached plane of every occupied voxel fitted, as the
    cached query mode's insert keeps it (``map/voxel_hash.py:
    _fit_planes``)."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh

    occ = torch.nonzero(m.fp != 0)[:, 0]
    nrm, dd, pv = vh._fit_planes(m, cfg, occ)
    normal, d, plane_valid = m.normal.clone(), m.d.clone(), m.plane_valid.clone()
    normal[occ], d[occ], plane_valid[occ] = nrm, dd, pv
    return m._replace(normal=normal, d=d, plane_valid=plane_valid)


def _query_bytes(fp, cfg, xyz, mask) -> int:
    """HBM bytes the cached-plane query must move: the distinct fingerprint
    sectors of the live queries' probes, the sectors of the rows read
    (normal, d and plane_valid: three arrays; slot 0 for a miss), the xyz
    and mask read and the 17-byte output rows."""
    import torch

    from fastliosam_tpu_torch.core import voxel
    from fastliosam_tpu_torch.ops import query_cuda
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes

    live = mask.cpu().numpy()
    coords = voxel.voxel_coords(xyz, cfg.voxel_size)
    h0 = voxel.hash_slot(coords, cfg.capacity).to(torch.int64).cpu().numpy()[live]
    cand = (h0[:, None] + np.arange(cfg.query_probes)) & (cfg.capacity - 1)
    slots, _ = query_cuda.find_slots_ref(fp, coords, mask, cfg.query_probes)
    rows = np.clip(slots.cpu().numpy(), 0, None)
    n = len(live)
    return (sector_bytes(cand.reshape(-1), 1) + sector_bytes(rows, 3) + 2 * sector_bytes(rows, 1)
            + n * 12 + n + n * 17)


def check_query(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The cached-plane query kernel against its plain version, bit for bit
    (normal, d and valid), at the two shapes of the main path: the cached
    mode's odometry, 8192 points of each of the engine map's last ``reps``
    scans (as ``check_assoc``) against the 2^19-slot figure-8 map with
    every occupied voxel's plane fitted, 2 probes; and the point-to-plane
    ICP's normals, the 16,384 points of each plane-refresh submap against
    its own 2^14-slot surfel map, 4 probes. Also ragged (8191 + 77 points,
    every 13th masked), all queries masked, queries that find nothing
    (slot 0's row, never valid), and a tight 2^12 table that dropped
    points. Each main shape is timed beside the plain version and the
    plain probe with three ``index_select`` row reads. Returns the record
    of the odometry shape (the kernels line) with the p2pl shape's under
    ``at_p2pl_shape``."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import query_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, plane_sets, surfel_cfg = fig8
    mc = _cached_map(m, cfg)
    queries = _scan_queries(dev, feed, traj, range(n_map_scans - reps, n_map_scans),
                            seed=n_map_scans + 1)
    ones = torch.ones(8192, dtype=torch.bool, device=dev)
    shapes = {
        "odometry": (mc, cfg, [(xyz, ones) for xyz in queries]),
        "p2pl": (None, surfel_cfg, [(sm, dst, dmask) for *_, sm, dst, dmask in plane_sets]),
    }

    def args_of(name, item):
        m_, c_, _ = shapes[name]
        if name == "odometry":
            xyz, mask = item
            return (m_.fp, m_.normal, m_.d, m_.plane_valid, xyz, mask, c_.voxel_size,
                    c_.query_probes)
        sm, dst, dmask = item
        return (sm.fp, sm.normal, sm.d, sm.plane_valid, dst, dmask, c_.voxel_size,
                c_.query_probes)

    def compare(name, args):
        got = query_cuda.query_cached_cuda(*args)
        want = query_cuda.query_cached_ref(*args)
        torch.cuda.synchronize()
        same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
                and torch.equal(got[2], want[2]))
        if not same:
            raise AssertionError(f"query_cached {name}: kernel and plain version differ")
        return got

    def plain_probe_index_select(fp, normal, d, pv, xyz, mask, vs, probes):
        from fastliosam_tpu_torch.core.voxel import voxel_coords

        slots, _ = query_cuda.find_slots_ref(fp, voxel_coords(xyz, vs), mask, probes)
        sl = slots.clamp(min=0)
        return (torch.index_select(normal, 0, sl), torch.index_select(d, 0, sl),
                torch.index_select(pv, 0, sl))

    recs = {}
    for name, (_, c_, items) in shapes.items():
        sets = [args_of(name, it) for it in items]
        valid_share = [float(compare(name, a)[2].float().mean()) for a in sets]
        ms = device_ms(query_cuda.query_cached_cuda, sets)
        plain_ms = device_ms(query_cuda.query_cached_ref, sets)
        composed_ms = device_ms(plain_probe_index_select, sets)
        nbytes = float(np.mean([_query_bytes(a[0], c_, a[4], a[5]) for a in sets]))
        recs[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
                      "library_ms": None,
                      "library_note": "none: no PyTorch call probes a hash table",
                      "plain_probe_and_index_select_ms": composed_ms,
                      "n": int(sets[0][4].shape[0]), "capacity": c_.capacity,
                      "probes": c_.query_probes, "sets": len(sets), "bytes": nbytes,
                      "valid_share": float(np.mean(valid_share))}
        print(f"  query_cached {name}: {recs[name]['n']} queries x 2^"
              f"{c_.capacity.bit_length() - 1} slots, {c_.query_probes} probes, {len(sets)} "
              f"sets: equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, plain probe + 3 "
              f"index_select {composed_ms:.4f} ms, bound {recs[name]['bound_ms']:.5f} ms "
              f"({nbytes:.0f} HBM bytes), valid {np.mean(valid_share):.1%}")

    # the edge cases, bit for bit
    xyz0 = queries[0]
    far = (torch.full((77, 3), 900.0, device=dev)
           + torch.arange(77, device=dev, dtype=torch.float32)[:, None])
    ragged = torch.cat([xyz0[:8191], far]).contiguous()
    rmask = torch.ones(len(ragged), dtype=torch.bool, device=dev)
    rmask[::13] = False
    got = compare("ragged", args_of("odometry", (ragged, rmask)))
    if bool(got[2][-77:].any()) or not torch.equal(got[0][-77:], mc.normal[0].expand(77, 3)):
        raise AssertionError("query_cached: a query that finds nothing must read slot 0, "
                             "not valid")
    compare("all masked", args_of("odometry", (xyz0, torch.zeros_like(ones))))
    compare("not found", args_of("odometry", (far.contiguous(), ones[:77])))
    tight_cfg = vh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=5,
                                  query_probes=4)
    tight, dropped = vh.insert(vh.make_map(tight_cfg, dev), tight_cfg,
                               torch.cat(queries[:2]).contiguous(), torch.cat([ones, ones]))
    if int(dropped) == 0:
        raise AssertionError("query_cached tight case: the 2^12 table must overflow")
    compare("tight 2^12", (tight.fp, tight.normal, tight.d, tight.plane_valid, xyz0, ones,
                           0.5, 4))
    print(f"  query_cached: equal on the ragged, all-masked, not-found and tight 2^12 "
          f"({int(dropped)} of 16384 points dropped) cases")
    return dict(recs["odometry"], at_p2pl_shape=recs["p2pl"])


def _downsampled_world(feed, k, pose, dev, budget: int = 8192):
    """Scan ``k``'s points downsampled as the odometry downsamples them
    (0.5 m voxels, the first ``budget`` of the packed output) and placed at
    ``pose`` (not deskewed): ``(xyz (budget, 3), mask (budget,))``."""
    import torch

    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample

    ds = voxel_downsample(Cloud(torch.from_numpy(feed["xyz"][k]).to(dev),
                                torch.from_numpy(feed["mask"][k]).to(dev)), 0.5)
    pose = torch.from_numpy(pose).to(dev)
    return (ds.xyz[:budget] @ pose[:3, :3].T + pose[:3, 3]).contiguous(), ds.mask[:budget]


def _insert_bytes(fp_np, cfg, xyz, mask, sl, rounds: int) -> int:
    """HBM bytes the insert must move: the distinct fingerprint sectors of
    every probe chain walked (to the slot found, or ``rounds`` long where
    none was), the sectors of the new fingerprint words and coordinate rows
    and of the old moment words read, the xyz and mask read and the sl,
    upd and n_dropped writes. ``fp_np``: the fingerprints before."""
    import torch

    from fastliosam_tpu_torch.core import voxel
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes

    c = cfg.capacity
    h0 = voxel.hash_slot(voxel.voxel_coords(xyz, cfg.voxel_size), c).to(torch.int64).cpu().numpy()
    sl, mask = sl.cpu().numpy(), mask.cpu().numpy()
    found = sl < c
    steps = np.where(found, ((sl - h0) & (c - 1)) + 1, np.where(mask, rounds, 0))
    walked = np.concatenate([(h0[steps > k] + k) & (c - 1) for k in range(int(steps.max()))])
    slots = np.unique(sl[found])
    new = slots[fp_np[slots] == 0]  # empty before: a winner wrote it
    n = len(sl)
    return (sector_bytes(walked, 1) + sector_bytes(new, 1) + sector_bytes(new, 3)
            + sector_bytes(slots * 10, 1) + n * (12 + 1) + n * (8 + 40) + 4)


def check_insert(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The map insert's kernel against its plain version, bit for bit on
    ``fp``, ``coords``, ``sl``, ``n_dropped`` and the ``upd`` rows of the
    assigned points (the unassigned rows go to the moment scatter's dead
    segment and are never read): the engine's 2^19-slot map after
    ``n_map_scans`` figure-8 scans (``figure8_map``), inserting the
    downsampled points of each of the next ``reps`` scans at the engine's
    poses, 2 rounds; a tight 2^12-slot table with drops (16,384 points, 4
    rounds); and the map after ``evict_far`` with a re-insert. The kernel
    is timed alone on fresh copies of the tables over the ``reps`` scans
    (and at 1 and 4 rounds), beside the whole call with its table copies,
    the plain version, the bound and the grid barriers alone at the
    kernel's grid. Returns the record (the kernels line)."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, *_ = fig8
    maxp, vs = cfg.max_points_per_voxel, cfg.voxel_size
    rounds = max(cfg.insert_probes, cfg.claim_probes)
    sets = [_downsampled_world(feed, k, traj[k], dev)
            for k in range(n_map_scans, n_map_scans + reps)]

    def compare(name, fp, coords, moments, xyz, mask, rnds):
        got = insert_cuda.insert_claim_cuda(fp, coords, moments, xyz, mask, vs, rnds, maxp)
        want = insert_cuda.insert_claim_ref(fp, coords, moments, xyz, mask, vs, rnds, maxp)
        torch.cuda.synchronize()
        cap = fp.shape[0]
        assigned = want[2] < cap
        same = {
            "fp": torch.equal(got[0], want[0]), "coords": torch.equal(got[1], want[1]),
            "sl": torch.equal(got[2], want[2]), "n_dropped": torch.equal(got[4], want[4]),
            "upd (assigned rows)": torch.equal(got[3][assigned].view(torch.int32),
                                               want[3][assigned].view(torch.int32)),
        }
        bad = [k for k, ok in same.items() if not ok]
        if bad:
            raise AssertionError(f"insert_claim {name}: kernel and plain version differ on "
                                 + ", ".join(bad))
        return got

    new_voxels = []
    for xyz, mask in sets:
        got = compare("figure-8", m.fp, m.coords, m.moments, xyz, mask, rounds)
        new_voxels.append(int((got[0] != 0).sum()) - int((m.fp != 0).sum()))
        # run_slam's maps probe and claim over 4 slots (VoxelMapConfig's default)
        compare("figure-8, 4 rounds", m.fp, m.coords, m.moments, xyz, mask, 4)
    # tight: two scans' points into 2^12 slots, 4 rounds
    tight_xyz = torch.cat([sets[0][0], sets[1][0]])
    tight_mask = torch.cat([sets[0][1], sets[1][1]])
    tight = vh.make_map(vh.VoxelMapConfig(capacity=1 << 12), dev)
    got = compare("tight 2^12", tight.fp, tight.coords, tight.moments, tight_xyz, tight_mask, 4)
    tight_dropped = int(got[4])
    if tight_dropped == 0:
        raise AssertionError("insert_claim tight case: the 2^12 table must overflow")
    # evicted: holes punched around the pose of the first inserted scan
    ev = vh.evict_far(m, cfg, torch.from_numpy(traj[n_map_scans][:3, 3]).to(dev), 8.0)
    compare("evicted", ev.fp, ev.coords, ev.moments, *sets[0], rounds)
    print(f"  insert_claim: equal on the figure-8 map ({reps} scans at {rounds} and 4 rounds, "
          f"{np.mean(new_voxels):.0f} new voxels per insert), the tight 2^12 table "
          f"({tight_dropped} of {int(tight_mask.sum())} points dropped) and the evicted map "
          f"({int((m.fp != 0).sum()) - int((ev.fp != 0).sum())} voxels evicted)")

    # timing: the launch alone (the claim table's zeroing and the kernel),
    # each call on its own fresh copy of the tables; device_ms makes 3
    # untimed calls (warm-up, enqueue time) before the timed ones
    def launch(r):
        fresh = iter([(m.fp.clone(), m.coords.clone()) for _ in range(reps + 3)])
        return lambda x, k: insert_cuda.insert_claim_into(*next(fresh), m.moments, x, k, vs, r,
                                                          maxp)

    times = {r: device_ms(launch(r), sets) for r in (1, 2, 4)}
    ms = times[rounds]
    call_ms = device_ms(lambda x, k: insert_cuda.insert_claim_cuda(
        m.fp, m.coords, m.moments, x, k, vs, rounds, maxp), sets)
    plain = {r: device_ms(lambda x, k, r=r: insert_cuda.insert_claim_ref(
        m.fp, m.coords, m.moments, x, k, vs, r, maxp), sets) for r in (rounds, 4)}
    plain_ms = plain[rounds]
    blocks, per_thread = insert_cuda.insert_claim_grid(sets[0][0].shape[0], dev)
    sync_ms = {s: device_ms(lambda b, s=s: insert_cuda.grid_sync_probe(b, s, dev),
                            [(blocks,)] * reps) for s in (0, 2 * rounds)}
    per_sync = (sync_ms[2 * rounds] - sync_ms[0]) / (2 * rounds)
    fp_np = m.fp.cpu().numpy()
    nbytes = {}  # HBM bytes at the bench's rounds and at run_slam's 4
    for r in (rounds, 4):
        sls = [insert_cuda.insert_claim_cuda(m.fp, m.coords, m.moments, xyz, mask, vs, r,
                                             maxp)[2] for xyz, mask in sets]
        nbytes[r] = float(np.mean([_insert_bytes(fp_np, cfg, xyz, mask, sl, r)
                                   for (xyz, mask), sl in zip(sets, sls)]))
    bounds = {r: b / H100_BYTES_PER_S * 1e3 for r, b in nbytes.items()}
    bound_ms = bounds[rounds]
    print(f"  insert_claim 8192 points, 2^19-slot map, {rounds} rounds: kernel {ms:.4f} ms "
          f"(1 round {times[1]:.4f}, 4 rounds {times[4]:.4f}), whole call with its table "
          f"copies {call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({nbytes[rounds]:.0f} HBM bytes); grid {blocks} x 256 threads, {per_thread} "
          f"point(s) a thread (4 rounds: plain {plain[4]:.4f} ms, bound {bounds[4]:.5f} ms): "
          f"a grid barrier {per_sync * 1e3:.2f} us "
          f"({2 * rounds} barriers = {2 * rounds * per_sync / ms:.0%} of the kernel), "
          f"an empty cooperative launch {sync_ms[0]:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "library_note": "none: no PyTorch call probes and claims a hash table",
            "ms_by_rounds": times, "plain_ms_by_rounds": plain, "bound_ms_by_rounds": bounds,
            "call_ms": call_ms, "grid_blocks": blocks,
            "grid_sync_ms": per_sync, "empty_launch_ms": sync_ms[0]}


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
    probe = next(r for r in recs if r["name"] == "tal_big_ceiling_probe")
    main = {"max_abs_err": 0.0, **{k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")},
            "ceiling_probe_ms": probe["ms"]}
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


def figure8_traj():
    """The figure-8 feed's path (``bench.py: build_fig8_sequence``)."""
    from fastliosam_tpu_torch.sim import Trajectory

    return Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)


def figure8_feed(n_scans: int, seed: int = 11) -> str:
    """The bench's loop-closing feed (``bench.py: build_fig8_sequence``): a
    lemniscate through a 60 m room, 2048 azimuths x 16 rings at 10 Hz, IMU
    at 200 Hz."""
    def build():
        from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, simulate_sequence

        world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=seed)
        traj = figure8_traj()
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
           "solve_s": probe.s["_solve"], "verify_s": probe.s["_launch_verify"],
           "verify_syncs": probe.verify_reads, "verify_nn": probe.verify_nn}
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
    """The map's kernels per scan: insert_claim (one per insert),
    merged_moments (one per association) and gather_rows (the plane
    refresh of the loop closure's throwaway map)."""
    return {name: launches[name] / scans
            for name in ("insert_claim", "merged_moments", "gather_rows")}


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

    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine
    from fastliosam_tpu_torch.utils import host_read, host_reads, reset_host_reads

    n_scans = len(feed["stamps"])
    engine = make_bench_engine(dev)
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
        "nearest_neighbors, gather_rows, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments",
                                      "insert_claim")) > 0,
        "ATE < 0.10 m": ate < 0.10,
        "replay bit-identical": result["replay_bit_identical"],
    })
    return result


def profile_phase(dev, feed, profile_scans: int):
    """An extra per-scan run whose last ``profile_scans`` scans run under
    ``torch.profiler``; it comes after every other phase (tracing slows the
    host for a while after it ends) and touches no launch count read."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    n_scans = len(feed["stamps"])
    engine = make_bench_engine(dev)
    run_engine(engine, feed, dev, min(12, n_scans))  # warm-up
    start = max(0, n_scans - profile_scans)
    run = run_engine(engine, feed, dev, n_scans, profile_from=start)
    return profile_summary(run["prof"], run["prof_wall_s"], n_scans - start)


def chunked_phase(dev, feed, chunk: int = 5):
    """process_chunk_deferred over the loop feed, twice from reset()."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev, chunk=chunk)
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
        "nearest_neighbors, gather_rows, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments",
                                      "insert_claim")) > 0,
        "replay bit-identical": result["replay_bit_identical"],
    })
    return result


# the other query and loop-ICP modes: each run's engine configuration over
# the bench's pipeline, its path, and the kernels that path must launch
MODES = {
    "cached_p2pl": (dict(query_mode="cached"), dict(icp_method="p2pl"), "per_scan",
                    ("query_cached", "insert_claim", "gather_rows", "nearest_neighbors")),
    "merged2_multistart": (dict(query_mode="merged2"),
                           dict(icp_multistart=5, multistart_step=4.0, multistart_iters=12),
                           "chunked", ("merged_moments", "insert_claim", "nearest_neighbors")),
}


def modes_phase(dev, feed, chunk: int = 5) -> dict:
    """The other query and loop-ICP modes over the figure-8 feed at the
    bench's width: (a) ``process`` per scan with the cached-plane query and
    point-to-plane loop ICP; (b) ``process_chunk_deferred`` (chunk 5) with
    the merged2 query and the multi-start loop ICP of ``bench.py:
    bench_kitti_rich`` (5 starts 4 m apart, 12 coarse iterations). Each
    run goes twice from ``reset()``; gates: every pose finite, more than
    500 matches in every scan after scan 2 (from scan 3 on: a cached plane
    needs 5 points in one voxel, so scan 2 against the map of scans 0-1
    matches only tens of points), a verification, a bit-identical replay,
    the path's kernels launched and ATE < 0.10 m."""
    import torch

    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine
    from fastliosam_tpu_torch.utils import host_read

    out = {}
    for name, (odom_kw, loop_kw, path, kernels) in MODES.items():
        engine = make_bench_engine(dev, chunk=chunk)
        engine.odom_cfg = engine.odom_cfg._replace(**odom_kw)
        engine.loop_cfg = engine.loop_cfg._replace(**loop_kw)
        engine.reset()
        if path == "per_scan":
            def drive():
                return run_engine(engine, feed, dev, len(feed["stamps"]))
        else:
            def drive():
                return run_chunks(engine, feed, dev, chunk, deferred=True)
        run, launches = _launch_counts(drive)
        first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
        matched = host_read(torch.stack(engine.match_counts))
        n_scans = len(engine.realtime_traj)
        n_verify = len(run["verify_syncs"])
        result = {
            "path": path, "odom": odom_kw, "loop": loop_kw, "scans": n_scans,
            "scans_per_s": n_scans / run["total_s"], "keyframes": engine.kf.n,
            "loops": len(engine.loop_pairs), "verifications": len(engine.loop_attempts),
            "solves": engine.solve_count, "ate_m": _ate(engine, feed),
            "launches": launches,
            "launches_per_scan": {k: v / n_scans for k, v in launches.items()},
            "host_syncs_per_verification": (float(np.mean(run["verify_syncs"]))
                                            if n_verify else None),
            "nn_launches_per_verification": (float(np.mean(run["verify_nn"]))
                                             if n_verify else None),
            "verify_ms_each": 1e3 * run["verify_s"] / n_verify if n_verify else None,
            "matched_first_scans": matched[:5].tolist(),
            "min_matched_after_scan2": int(matched[3:].min()),
            "loop_pairs": first[1],
        }
        finite = bool(np.all(np.isfinite(first[0]))) and bool(
            np.all(np.isfinite(engine.keyframe_poses())))
        drive()  # the replay
        result["replay_bit_identical"] = _replay(engine, first)
        print(f"  {name}: " + json.dumps(result))
        _fail(f"modes phase, {name}", {
            "every pose finite": finite,
            "n_matched > 500 after scan 2 (scans 3 on)": result["min_matched_after_scan2"] > 500,
            "at least one verification": result["verifications"] >= 1,
            "replay bit-identical": result["replay_bit_identical"],
            ", ".join(kernels) + " launched": min(launches[k] for k in kernels) > 0,
            "ATE < 0.10 m": result["ate_m"] < 0.10,
        })
        out[name] = result
    return out


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
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev, max_kf=256, max_between=512, max_gps=256, chunk=chunk)
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
        "merged_moments and insert_claim launched":
            launches["merged_moments"] > 0 and launches["insert_claim"] > 0,
    })
    return result


# ---------------------------------------------------------------------------
# KITTI phase: the dataset entry point (drive_kitti over the native reader),
# export, checkpoint/resume and relocalization
# ---------------------------------------------------------------------------
def kitti_feed() -> tuple[str, float]:
    """The bench's KITTI_SYNTH v2 (``bench.py: _ensure_longrun_dataset``):
    ``make_kitti_synth.generate(root, "00", 1160)``, 2048 x 16 rays to
    50 m, written as KITTI .bin files under build/ (kept when complete;
    ``scripts/exp_loop_trust.py: ensure_longrun_dataset``). Builds the
    native reader first. Returns the root and the seconds it took."""
    import os

    from fastliosam_tpu_torch.io.native import native_available
    from fastliosam_tpu_torch.scripts.exp_loop_trust import ensure_longrun_dataset

    t0 = time.perf_counter()
    # exp_loop_trust.GEN_WORKERS processes at nice 10, which they inherit
    # from this thread: they leave the card's feeder process and the
    # machine's own services their cores (6-7 generators busy from the
    # start took an 8-core host down twice)
    os.nice(10)
    native_available()
    root = ensure_longrun_dataset("canyon")
    return root, time.perf_counter() - t0


def _finite(engine) -> bool:
    return bool(np.all(np.isfinite(np.stack(engine.realtime_traj)))
                and np.all(np.isfinite(engine.keyframe_poses())))


def kitti_longrun_phase(dev, root: str, chunk: int = 5):
    """``drive_kitti`` over the whole sequence at the bench's width and
    depth (``bench.py: bench_kitti_longrun``), q16 upload: the bench's
    configuration, then the same run loop-free (the odometry alone, the
    radius of loop candidates set to 0). Gates: every pose finite, the
    loop-free realtime ATE <= 10 m (JAX on a TPU: 3.56 m) and, as a
    regression guard, the bench configuration's <= 20 m (the 10 m target
    is unmet: ROADMAP Queue 3 fault 1; its loop trust is chaotic on this
    feed: the JAX engine gives 3.35 m on a TPU and 7.41 m on the CPU, and
    31 m with the spec's 35 m radius; PERF.md), every kernel of the path
    launched."""
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.io.native import native_available
    from fastliosam_tpu_torch.runtime.drivers import drive_kitti
    from fastliosam_tpu_torch.scripts.exp_loop_trust import loop_audit, make_longrun_engine
    from fastliosam_tpu_torch.utils import host_reads, reset_host_reads

    if not native_available():
        raise AssertionError("KITTI phase: the native reader did not build (g++)")
    engine = make_longrun_engine(device=dev)
    reset_host_reads()
    out, launches = _launch_counts(lambda: drive_kitti(
        engine, root, "00", scan_capacity=32768, chunk=chunk, progress=False))
    n = out["n_scans"]
    result = dict(out, chunk=chunk, upload="q16", scan_capacity=32768,
                  verifications=len(engine.loop_attempts),
                  loop_audit=loop_audit(engine, KittiSequence(root, "00")),
                  host_syncs_per_chunk=host_reads() / -(-n // chunk), launches=launches,
                  launches_per_scan={k: v / n for k, v in launches.items()})
    loop_free = make_longrun_engine(device=dev)
    loop_free.loop_cfg = loop_free.loop_cfg._replace(radius=0.0)
    result["loop_free"] = drive_kitti(loop_free, root, "00", scan_capacity=32768, chunk=chunk,
                                      progress=False)
    print("  " + json.dumps(result))
    lf = result["loop_free"]
    slid = [a for a in result["loop_audit"] if a["t_err_m"] > 5.0]
    print(f"  long-run: {out['scans_per_sec']} scans/s, ATE {out.get('ate_m')} m, keyframe ATE "
          f"{out.get('kf_ate_m')} m, RPE(1 s) {out.get('rpe_1s_m')} m, {out['n_loops']} loops "
          f"({len(slid)} off by more than 5 m against ground truth), {out['n_keyframes']} "
          f"keyframes, {out['n_solves']} solves; loop-free {lf['scans_per_sec']} scans/s, ATE "
          f"{lf.get('ate_m')} m, keyframe ATE {lf.get('kf_ate_m')} m "
          f"(accuracy reference, JAX engine on a TPU: ATE 3.3519 m, keyframe ATE 3.2462 m, "
          f"2 loops, 574 keyframes; loop-free 3.56 m)")
    _fail("KITTI long-run", {
        "every pose finite": _finite(engine) and _finite(loop_free),
        "ground truth read": "ate_m" in out and "ate_m" in lf,
        "loop-free ATE <= 10 m": lf.get("ate_m", np.inf) <= 10.0,
        "ATE <= 20 m (regression guard; the 10 m target is unmet (ROADMAP Queue 3 fault 1))":
            out.get("ate_m", np.inf) <= 20.0,
        "at least one verification": result["verifications"] >= 1,
        "nearest_neighbors, gather_rows, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments",
                                      "insert_claim")) > 0,
    })
    return result, engine


def export_phase(engine, out_dir: Path) -> dict:
    """``save_results`` of the long run; the files checked against the
    engine: PCD ``POINTS`` = the assembled map's size = the points read
    back, KITTI rows = keyframes, the bundle's keys and shapes."""
    from fastliosam_tpu_torch.io.pcd import read_pcd
    from fastliosam_tpu_torch.io.poses import read_kitti_poses
    from fastliosam_tpu_torch.runtime import save_results

    t0 = time.perf_counter()
    paths = save_results(engine, str(out_dir), "00")
    export_s = time.perf_counter() - t0
    n_kf = engine.kf.n
    header = {}
    with open(paths["map_pcd"], "rb") as f:
        for line in f:  # the header ends at its DATA line
            key, _, val = line.decode().strip().partition(" ")
            header[key] = val
            if key == "DATA":
                break
    points = int(header["POINTS"])
    map_size = len(engine.assemble_map(voxel=0.3))
    bundle = np.load(paths["keyframes"])
    shapes = {k: list(bundle[k].shape) for k in bundle.files}
    meta = json.loads(Path(paths["meta"]).read_text())
    result = {"export_s": export_s, "pcd_points": points, "map_size": map_size,
              "kitti_rows": len(read_kitti_poses(paths["kitti"])), "keyframes": n_kf,
              "bundle_shapes": shapes, "files": sorted(Path(p).name for p in paths.values())}
    print("  " + json.dumps(result))
    _fail("export", {
        "PCD POINTS = the map's size": points == map_size == len(read_pcd(paths["map_pcd"])),
        "KITTI rows = keyframes": result["kitti_rows"] == n_kf,
        "bundle keys": set(bundle.files) == {"poses", "stamps", "clouds", "masks"},
        "bundle shapes": shapes["poses"] == [n_kf, 4, 4] and shapes["stamps"] == [n_kf]
        and shapes["clouds"][:1] == [n_kf] and shapes["masks"] == shapes["clouds"][:2],
        "meta": meta["n_keyframes"] == n_kf and meta["n_scans"] == engine.scan_count,
    })
    return result, paths


def _drive_span(engine, stage, c0: int, c1: int, chunk: int, dt: float):
    """Scans [c0, c1) through ``drive_kitti``'s staging and deferred chunk
    loop, then ``finish()``."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(stage, c0, min(chunk, c1 - c0))
        for c in range(c0, c1, chunk):
            scans, imus, stamps = fut.result()
            if c + chunk < c1:
                fut = pool.submit(stage, c + chunk, min(chunk, c1 - c - chunk))
            engine.process_chunk_deferred(scans, imus, stamps, dt)
        engine.finish()


def resume_phase(dev, root: str, ckpt: Path, split: int = 300, end: int = 400, chunk: int = 5):
    """A long-run engine drives scans [0, split) and saves a checkpoint; it
    and a fresh engine restored from that checkpoint then drive [split,
    end) through the same staging code: bit-identical realtime
    trajectories, keyframe poses and loop pairs."""
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.runtime import load_checkpoint, save_checkpoint
    from fastliosam_tpu_torch.runtime.drivers import kitti_stager
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_longrun_engine

    seq = KittiSequence(root, "00")
    dt = float(np.median(np.diff(np.asarray(seq.times, np.float64))))
    t0 = time.perf_counter()

    def run():
        first = make_longrun_engine(device=dev)
        _drive_span(first, kitti_stager(first, seq, 32768, chunk), 0, split, chunk, dt)
        save_checkpoint(first, str(ckpt))
        _drive_span(first, kitti_stager(first, seq, 32768, chunk), split, end, chunk, dt)
        restored = load_checkpoint(make_longrun_engine(device=dev), str(ckpt))
        _drive_span(restored, kitti_stager(restored, seq, 32768, chunk), split, end, chunk, dt)
        return first, restored

    (first, restored), launches = _launch_counts(run)
    same = {
        "realtime trajectories bit-identical": np.array_equal(np.stack(first.realtime_traj),
                                                              np.stack(restored.realtime_traj)),
        "keyframe poses bit-identical": np.array_equal(first.keyframe_poses(),
                                                       restored.keyframe_poses()),
        "loop pairs equal": first.loop_pairs == restored.loop_pairs,
        "every pose finite": _finite(restored),
    }
    result = {"split": split, "end": end, "seconds": time.perf_counter() - t0,
              "checkpoint_mb": ckpt.stat().st_size / 2**20, "keyframes": restored.kf.n,
              "loop_pairs": list(restored.loop_pairs), "solves": restored.solve_count,
              "launches": launches, **same}
    print("  " + json.dumps(result))
    _fail("resume", same)
    return result


def _kitti_scan(seq, i: int, dev, cap: int = 32768):
    """Scan ``i`` as ``scripts/localize.py`` stages it: xyz and azimuth
    times padded to ``cap``, masked."""
    from fastliosam_tpu_torch.scripts.run_slam import padded_scan

    xyz, _, toff = seq.scan(i)
    return padded_scan(xyz, toff, cap, dev)


def _perturbed(pose, metres: float = 1.0, yaw_deg: float = 5.0):
    """``pose`` moved by ``metres`` (along (0.8, 0.6, 0)) and turned by
    ``yaw_deg`` about z."""
    a = np.deg2rad(yaw_deg)
    d = np.eye(4, dtype=np.float32)
    d[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    d[:3, 3] = np.array([0.8, 0.6, 0.0]) * metres
    return (pose @ d).astype(np.float32)


def localize_phase(dev, root: str, bundle: str, ref_pose, n_scans: int = 200):
    """``MapLocalizer`` on the long run's bundle (2^19 slots, the
    localizer's defaults): ``global_init`` on scan 0 from its pose in the
    map perturbed by 1 m and 5 degrees of yaw, then ``process`` on scans
    0..n_scans-1 with the empty IMU batch of ``scripts/localize.py``."""
    import torch

    from fastliosam_tpu_torch.eval import align_umeyama
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import ImuBatch, OdomConfig
    from fastliosam_tpu_torch.runtime import MapLocalizer

    seq = KittiSequence(root, "00")
    no_imu = ImuBatch(torch.full((8,), 1e9, device=dev), torch.zeros((8, 3), device=dev),
                      torch.zeros((8, 3), device=dev),
                      torch.zeros((8,), dtype=torch.bool, device=dev))

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc = MapLocalizer(bundle, map_cfg=VoxelMapConfig(capacity=1 << 19),
                           odom_cfg=OdomConfig(), device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fitness = loc.global_init(_kitti_scan(seq, 0, dev), _perturbed(ref_pose))
        poses, matched = [], []
        t_prev = float(seq.times[0]) - 0.1
        t1 = time.perf_counter()
        for i in range(n_scans):
            stamp = float(seq.times[i])
            T, n = loc.process(_kitti_scan(seq, i, dev), no_imu, max(stamp - t_prev, 0.05))
            poses.append(T)
            matched.append(n)
            t_prev = stamp
        return loc, build_s, fitness, np.stack(poses), matched, time.perf_counter() - t1

    (loc, build_s, fitness, poses, matched, steps_s), launches = _launch_counts(run)
    est = poses[:, :3, 3]
    gt = seq.gt_poses()[:n_scans, :3, 3]
    _, R, t = align_umeyama(est, gt)
    ate = float(np.sqrt(np.mean(np.sum((est @ R.T + t - gt) ** 2, axis=1))))
    result = {"scans": n_scans, "map_build_s": build_s,
              "map_voxels": int((loc.vmap.fp != 0).sum()), "global_init_fitness": fitness,
              "matched_min": int(min(matched)), "matched_mean": float(np.mean(matched)),
              "matched": matched, "ate_m": ate, "steps_per_s": n_scans / steps_s,
              "launches": launches}
    print("  " + json.dumps(result))
    print(f"  localize: map build {build_s:.3f} s, global-init fitness {fitness:.4f}, matched "
          f"{min(matched)}..{max(matched)} per scan, localized ATE {ate:.4f} m over {n_scans} "
          f"scans (no IMU, no motion model: the JAX step's behaviour)")
    _fail("localize", {
        "every pose finite": bool(np.all(np.isfinite(poses))),
        "every step matched points": min(matched) > 0,
        "nearest_neighbors, gather_rows, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments",
                                      "insert_claim")) > 0,
    })
    return result, loc


def localizer_kernel_inputs(dev, bundle: str, loc, root: str, ref_pose, batch: int = 65536):
    """The localizer's kernel inputs at their own shapes: the map of
    ``build_map_from_keyframes`` after half its batches and the next
    65,536-point batch (the insert), the slots that insert gives (the
    plane refresh's reads of the (2^19, 10) moments and (2^19, 3)
    coordinates), and ``global_init``'s first ICP query: the 8192
    downsampled points of scan 0 at the perturbed guess against the
    finished map's (2^19,) voxel centroids."""
    import torch

    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.map import insert, make_map, occupied_centroids
    from fastliosam_tpu_torch.runtime.localizer import keyframe_world_points

    cfg = loc.map_cfg
    flat, fmask = keyframe_world_points(bundle)
    half = (len(flat) // batch // 2) * batch
    m = make_map(cfg, dev)
    for s in range(0, half, batch):
        m, _ = insert(m, cfg, torch.from_numpy(flat[s: s + batch]).to(dev),
                      torch.from_numpy(fmask[s: s + batch]).to(dev))
    xyz = torch.from_numpy(flat[half: half + batch]).to(dev)
    mask = torch.from_numpy(fmask[half: half + batch]).to(dev)
    seq = KittiSequence(root, "00")
    scan = _kitti_scan(seq, 0, dev)
    ds = voxel_downsample(Cloud(scan.xyz, scan.mask), loc.odom_cfg.filter_size_surf)
    guess = torch.from_numpy(_perturbed(ref_pose)).to(dev)
    src = (ds.xyz[:8192] @ guess[:3, :3].T + guess[:3, 3]).contiguous()
    dst, occ = occupied_centroids(loc.vmap, cfg)
    return {"map": m, "cfg": cfg, "xyz": xyz, "mask": mask,
            "nn": (src, dst.contiguous(), occ.contiguous())}


def check_localizer_shapes(dev, inp, reps: int = 10) -> dict:
    """Each kernel against its plain version at the localizer's shapes,
    timed beside the plain version, a one-call PyTorch yardstick and the
    bound. Returns ``{kernel: record}``."""
    import torch

    from fastliosam_tpu_torch.ops import gather_cuda, insert_cuda, nn_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    out = {}
    # the insert: 65,536 points into the half-built 2^19-slot map
    m, cfg, xyz, mask = inp["map"], inp["cfg"], inp["xyz"], inp["mask"]
    rounds = max(cfg.insert_probes, cfg.claim_probes)
    args = (m.fp, m.coords, m.moments, xyz, mask, cfg.voxel_size, rounds,
            cfg.max_points_per_voxel)
    got = insert_cuda.insert_claim_cuda(*args)
    want = insert_cuda.insert_claim_ref(*args)
    torch.cuda.synchronize()
    assigned = want[2] < cfg.capacity
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]) and torch.equal(got[4], want[4])
            and torch.equal(got[3][assigned].view(torch.int32),
                            want[3][assigned].view(torch.int32))):
        raise AssertionError("insert_claim at the localizer's shape: kernel and plain differ")
    fresh = iter([(m.fp.clone(), m.coords.clone()) for _ in range(reps + 3)])
    ms = device_ms(lambda: insert_cuda.insert_claim_into(*next(fresh), *args[2:]), [()] * reps)
    plain_ms = device_ms(lambda: insert_cuda.insert_claim_ref(*args), [()] * 3)
    nbytes = _insert_bytes(m.fp.cpu().numpy(), cfg, xyz, mask, got[2], rounds)
    blocks, per_thread = insert_cuda.insert_claim_grid(xyz.shape[0], dev)
    out["insert_claim"] = {
        "shape": f"{xyz.shape[0]} points into the 2^19-slot localizer map after half its "
                 f"batches, {rounds} rounds", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "grid_blocks": blocks, "points_per_thread": per_thread,
        "dropped": int(got[4]), "new_voxels": int((got[0] != 0).sum() - (m.fp != 0).sum())}
    # the plane refresh's reads after that insert, at its slots
    sl = got[2]
    for name, table in (("moments", m.moments), ("coords", m.coords)):
        g = gather_cuda.gather_rows_cuda(table, sl)
        w = gather_cuda.gather_rows_ref(table, sl)
        torch.cuda.synchronize()
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"gather_rows {name} at the localizer's shape: differ")
        c, d = table.shape
        clamped = sl.clamp(max=c - 1)
        nb = _gather_bytes(sl.cpu().numpy(), d, c)
        out[f"gather_rows_{name}"] = {
            "shape": f"({c},{d}) x {sl.shape[0]} int64", "max_abs_err": 0.0,
            "ms": device_ms(lambda: gather_cuda.gather_rows_cuda(table, sl), [()] * reps),
            "plain_ms": device_ms(lambda: gather_cuda.gather_rows_ref(table, sl), [()] * reps),
            "bound_ms": nb / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": device_ms(lambda: torch.index_select(table, 0, clamped), [()] * reps)}
    # the NN: global_init's ICP query against the map's voxel centroids
    src, dst, occ = inp["nn"]
    k_idx, k_d2 = nn_cuda.nearest_neighbors_cuda(src, dst, occ)
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(src, dst, occ)
    torch.cuda.synchronize()
    # both compute d2 = |s|^2 + |d|^2 - 2 s.d in float32, summed in other
    # orders: with map coordinates of ~100 m the expansion's own rounding
    # is a few ulps of |s|^2 + |d|^2 (~1e4 m^2), far above rtol 1e-5 of
    # the O(1) m^2 distances, so the tolerance is 4 ulps of that sum
    # (indices may differ only where the two candidates' d2 agree as well)
    mag = (src ** 2).sum(-1) + (dst[r_idx.long()] ** 2).sum(-1)
    tol = 1e-5 * r_d2.abs() + 4 * 2.0 ** -23 * mag
    if not bool(((k_d2 - r_d2).abs() <= tol).all()):
        raise AssertionError("nn at the localizer's shape: d2 differs")
    diff = k_idx != r_idx
    if bool(diff.any()):
        s = src[diff]
        dk = ((s - dst[k_idx[diff].long()]) ** 2).sum(-1)
        dr = ((s - dst[r_idx[diff].long()]) ** 2).sum(-1)
        if not bool(((dk - dr).abs() <= tol[diff]).all()):
            raise AssertionError("nn at the localizer's shape: an index differs (not a tie)")
    n, mm = src.shape[0], dst.shape[0]

    def library():  # one cdist + masked min over 8192 x 2^19 distances (17 GB)
        d = torch.cdist(src, dst)
        return d.masked_fill_(~occ[None, :], float("inf")).min(dim=1)

    valid = int(occ.sum())
    t_ops = 8.0 * n * valid / H100_F32_FLOPS * 1e3
    t_bytes = (n * 12 + mm * 12 + mm + n * 8) / H100_BYTES_PER_S * 1e3
    slices, slice_len = nn_cuda.slice_plan(n, mm)
    out["nearest_neighbors"] = {
        "shape": f"{n} x {mm} ({valid} occupied voxels)",
        "max_abs_err": float((k_d2 - r_d2).abs().max()), "ties": int(diff.sum()),
        "tolerance": "1e-5 |d2| + 4 ulp(|s|^2 + |d|^2)",
        "ms": device_ms(lambda: nn_cuda.nearest_neighbors_cuda(src, dst, occ), [()] * reps),
        "plain_ms": device_ms(lambda: nn_cuda.nearest_neighbors_ref(src, dst, occ), [()] * 2),
        "library_ms": device_ms(library, [()] * 2),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "slices": slices, "slice_len": slice_len}
    for name, rec in out.items():
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        print(f"  {name} at {rec['shape']}: equal to the plain version, kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, library {lib}, bound {rec['bound_ms']:.5f} ms")
    return out


def kitti_phase(dev, root: str, chunk: int = 5) -> dict:
    """The dataset entry point at the bench's width and depth: the long
    run, its export, the resume and the relocalization, and the kernels at
    the localizer's shapes."""
    out_dir = ROOT / "build" / "kitti_export"
    print(f"  long-run (drive_kitti, chunk {chunk}, q16):")
    longrun, engine = kitti_longrun_phase(dev, root, chunk)
    print("  export (save_results):")
    export, paths = export_phase(engine, out_dir)
    ref_pose = np.asarray(engine.realtime_traj[0])
    del engine
    print("  resume (save_checkpoint / load_checkpoint):")
    resume = resume_phase(dev, root, out_dir / "resume_ckpt.npz", chunk=chunk)
    print("  localize (MapLocalizer):")
    localize, loc = localize_phase(dev, root, paths["keyframes"], ref_pose)
    print("  kernels at the localizer's shapes:")
    shapes = check_localizer_shapes(
        dev, localizer_kernel_inputs(dev, paths["keyframes"], loc, root, ref_pose))
    return {"longrun": longrun, "export": export, "resume": resume, "localize": localize,
            "kernel_shapes": shapes}


# ---------------------------------------------------------------------------
# bag phase: the ROS-bag entry point (run_slam --dataset bag) at Ouster OS1-64
# width, and the MulRan and Newer College readers over the same recording
# ---------------------------------------------------------------------------
BAG_PRESET = "newer-college2020"
OS1_64 = (1024, 64)  # azimuths x rings: 65,536 points a scan
BAG_SHORT_SCANS = 50  # the MulRan and Newer College runs
# ATE gates (m): the figure-8 gate, which holds for the bag run while the
# JAX package on the CPU reads <= 0.05 m at 512 x 64 over the same 150
# scans (it read 0.0358 m; tests/test_torch_longrun.py), and for the MulRan
# run with GPS the larger of 0.10 m and twice JAX's reading there (0.0344 m)
BAG_ATE_GATE = 0.10
MULRAN_ATE_GATE = max(0.10, 2 * 0.0344)


def bag_feed(n_scans: int = 150, seed: int = 11) -> str:
    """The figure-8 recording (``sim/writers.py: render_figure8``: the
    loop feed of phases 4-7, started from rest) at OS1-64 geometry in the
    ``newer-college2020`` preset's LiDAR frame, written under build/ as
    the Ouster driver publishes it: ``figure8.bag`` (all scans; IMU at
    100 Hz, NavSatFix at 1 Hz), ``figure8_short.bag`` and
    ``registered_poses.csv`` (the first ``BAG_SHORT_SCANS`` scans, for the
    Newer College reader), ``mulran/`` (the same scans as a MulRan
    directory, GPS at 10 Hz) and ``truth.npz``. The recording's clock
    starts at 1000 s (``writers.T0_NS``), not at a Unix epoch as a real
    bag's does: both engines keep keyframe stamps in float32, so at an
    epoch no loop is ever tried and the bag phase's loop gate could not
    hold (ROADMAP Queue 3 fault 3, queued). Runs in a worker process at
    nice 10 (it takes minutes of host time); kept when complete."""
    import os
    import shutil

    from fastliosam_tpu_torch.io.presets import PRESETS
    from fastliosam_tpu_torch.sim import writers

    os.nice(10)
    out = ROOT / "build" / f"chip_smoke_bag_{n_scans}_{seed}_{OS1_64[0]}x{OS1_64[1]}"
    if out.exists():
        return str(out)
    tmp = out.with_name(out.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    pre = PRESETS[BAG_PRESET]
    data = writers.render_figure8(n_scans, pre, *OS1_64, seed=seed)
    writers.write_bag(str(tmp / "figure8.bag"), data, pre, *OS1_64)
    writers.write_bag(str(tmp / "figure8_short.bag"), data, pre, *OS1_64,
                      n_scans=BAG_SHORT_SCANS)
    writers.write_gt_csv(str(tmp / "registered_poses.csv"), data, n_scans=BAG_SHORT_SCANS)
    writers.write_mulran(str(tmp / "mulran"), data, *OS1_64, pre.extrinsic_R, pre.extrinsic_T,
                         n_scans=BAG_SHORT_SCANS)
    np.savez(tmp / "truth.npz", gt_p=np.stack([g[1] for g in data["gt"]]))
    tmp.rename(out)
    return str(out)


def _cli_run(argv):
    """``run_slam.run(argv)`` (the body of its ``main``) with every
    kernel's launch count set to 0 just before and the host reads counted:
    returns the engine, the drive's host seconds, the host reads and the
    launch counts."""
    from fastliosam_tpu_torch.scripts import run_slam
    from fastliosam_tpu_torch.utils import host_reads, reset_host_reads

    def drive():
        reset_host_reads()
        engine, drive_s = run_slam.run(argv)
        return engine, drive_s, host_reads()

    (engine, drive_s, reads), launches = _launch_counts(drive)
    return engine, drive_s, reads, launches


def _cli_result(engine, drive_s, reads, launches, gt_p) -> dict:
    from fastliosam_tpu_torch.eval import ate_rmse

    rt = np.stack(engine.realtime_traj)
    n = len(rt)
    return {
        "scans": n, "scans_per_s": n / drive_s, "keyframes": engine.kf.n,
        "loops": len(engine.loop_pairs), "verifications": len(engine.loop_attempts),
        "solves": engine.solve_count, "gps_factors": int(engine.graph.n_gps),
        "ate_m": ate_rmse(rt[:, :3, 3], gt_p[:n], align=True),
        "host_reads_per_scan": reads / n, "launches": launches,
        "launches_per_scan": {k: v / n for k, v in launches.items()},
        "finite": _finite(engine), "loop_pairs": [list(map(int, p)) for p in engine.loop_pairs],
    }


def _decoded_equal(short_bag: str) -> dict:
    """The Newer College reader's scans and IMU against ``BagSequence``'s
    on the same bag: xyz, intensity and stamps bit for bit, the IMU as
    float32 (the reader keeps float64, the preset stream float32), point
    times within one float32 step of the 0.1 s sweep (the reader scales
    in float32, the preset stream in float64)."""
    from fastliosam_tpu_torch.io.newer_college import NewerCollegeSequence
    from fastliosam_tpu_torch.io.presets import PRESETS, BagSequence

    nc = list(NewerCollegeSequence(bags=short_bag).stream())
    bs = [e for e in BagSequence(short_bag, PRESETS[BAG_PRESET]).stream() if e[0] != "gps"]
    ok = len(nc) == len(bs)
    dt_max, n_scans = 0.0, 0
    for (k1, s1, p1), (k2, s2, p2) in zip(nc, bs):
        ok = ok and k1 == k2 and s1 == s2
        if not ok:
            break
        if k1 == "scan":
            n_scans += 1
            ok = np.array_equal(p1[0], p2[0]) and np.array_equal(p1[1], p2[1])
            dt_max = max(dt_max, float(np.abs(p1[2].astype(np.float64) - p2[2]).max()))
        else:
            ok = all(np.array_equal(np.float32(a), np.float32(b)) for a, b in zip(p1, p2))
    return {"equal": bool(ok and dt_max <= float(np.spacing(np.float32(0.1)))),
            "events": len(nc), "scans": n_scans,
            "max_point_time_diff_s": dt_max}


def bag_phase(dev, feed_dir: str) -> dict:
    """The ROS-bag entry point through the port's CLI (``run_slam.run``,
    the body of ``run_slam.main``) on the card: ``--dataset bag --preset
    newer-college2020`` over the 150-scan OS1-64 recording at the default
    131,072-point scan capacity, 8192 iEKF points, a 2^19-slot map and
    loops at 10 m / 4 s (GPS off: the fixes are decoded, not used), twice,
    each from a freshly built engine; the replay is traced with
    ``torch.profiler``. Gates: the two runs bit-identical (trajectories and
    loop pairs), ATE < ``BAG_ATE_GATE`` (Umeyama-aligned: the CLI starts at
    the identity), a loop verification (possible only because the
    recording's clock starts at 1000 s: see :func:`bag_feed`), every pose
    finite and
    merged_moments, insert_claim, gather_rows and nearest_neighbors
    launched. Then ``--dataset mulran --use-gps`` over the first 50 scans'
    MulRan directory (GPS factors > 0, ATE < ``MULRAN_ATE_GATE``) and
    ``--dataset newer-college --gt-csv`` over their bag (the decoded scans
    and IMU those of ``BagSequence``; finite poses; its ATE printed, not
    gated: that path applies no extrinsic, as the JAX script's)."""
    import torch

    d = Path(feed_dir)
    gt_p = np.load(d / "truth.npz")["gt_p"]
    out = ROOT / "build" / "bag_runs"
    argv = ["--dataset", "bag", "--preset", BAG_PRESET, "--root", str(d / "figure8.bag"),
            "--num-ds-points", "8192", "--map-capacity-log2", "19", "--loop-radius", "10",
            "--loop-time-gap", "4", "--out", str(out / "bag")]
    print(f"  bag: run_slam {' '.join(argv)}")
    engine, drive_s, reads, launches = _cli_run(argv)
    bag = _cli_result(engine, drive_s, reads, launches, gt_p)
    first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
    del engine
    prof, t_prof = _start_profile()
    engine, _, _, _ = _cli_run(argv)
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    bag["replay_bit_identical"] = _replay(engine, first)
    bag["device_ops_per_scan"] = profile_summary(
        prof, time.perf_counter() - t_prof, bag["scans"], top=6)["device_ops_per_scan"]
    del engine
    print("  bag: " + json.dumps(bag))
    _fail("bag phase, bag", {
        "150 scans": bag["scans"] == len(gt_p),
        "every pose finite": bag["finite"],
        f"ATE < {BAG_ATE_GATE} m": bag["ate_m"] < BAG_ATE_GATE,
        "at least one verification": bag["verifications"] >= 1,
        "replay bit-identical": bag["replay_bit_identical"],
        "merged_moments, insert_claim, gather_rows and nearest_neighbors launched":
            min(launches[k] for k in ("merged_moments", "insert_claim", "gather_rows",
                                      "nearest_neighbors")) > 0,
    })

    argv = ["--dataset", "mulran", "--root", str(d / "mulran"), "--use-gps",
            "--num-ds-points", "8192", "--map-capacity-log2", "19", "--out", str(out / "mulran")]
    print(f"  mulran: run_slam {' '.join(argv)}")
    mulran = _cli_result(*_cli_run(argv), gt_p)
    print("  mulran: " + json.dumps(mulran))
    _fail("bag phase, mulran", {
        "50 scans": mulran["scans"] == BAG_SHORT_SCANS,
        "every pose finite": mulran["finite"],
        "GPS factors > 0": mulran["gps_factors"] > 0,
        f"ATE < {MULRAN_ATE_GATE} m": mulran["ate_m"] < MULRAN_ATE_GATE,
    })

    argv = ["--dataset", "newer-college", "--root", str(d / "figure8_short.bag"),
            "--gt-csv", str(d / "registered_poses.csv"), "--num-ds-points", "8192",
            "--map-capacity-log2", "19", "--out", str(out / "newer_college")]
    print(f"  newer college: run_slam {' '.join(argv)}")
    engine, *rest = _cli_run(argv)
    nc = _cli_result(engine, *rest, gt_p)
    nc["decoded"] = _decoded_equal(str(d / "figure8_short.bag"))
    from fastliosam_tpu_torch.io.newer_college import NewerCollegeSequence

    gt_csv = NewerCollegeSequence(bags=str(d / "figure8_short.bag"),
                                  gt_csv=str(d / "registered_poses.csv")).gt
    nc["gt_csv_rows"] = len(gt_csv["stamps"])
    nc["gt_csv_max_diff_m"] = float(np.abs(gt_csv["poses"][:, :3, 3]
                                           - gt_p[:BAG_SHORT_SCANS]).max())
    del engine
    print("  newer college: " + json.dumps(nc))
    print(f"  ATE (Umeyama-aligned, m): bag {bag['ate_m']:.4f} (gate {BAG_ATE_GATE}), MulRan "
          f"with GPS {mulran['ate_m']:.4f} (gate {MULRAN_ATE_GATE}), Newer College "
          f"{nc['ate_m']:.4f} (not gated: no extrinsic applied)")
    _fail("bag phase, newer college", {
        "50 scans": nc["scans"] == BAG_SHORT_SCANS,
        "every pose finite": nc["finite"],
        "decoded scans and IMU equal BagSequence's": nc["decoded"]["equal"],
        "ground-truth csv read": nc["gt_csv_rows"] == BAG_SHORT_SCANS
        and nc["gt_csv_max_diff_m"] < 1e-6,
    })
    return {"bag": bag, "mulran": mulran, "newer_college": nc}


# ---------------------------------------------------------------------------
# batched phase (eval/batch_eval.py: batched_rollout)
# ---------------------------------------------------------------------------
BATCH_LANES = 8
BATCH_SCANS = 75
BATCH_STRIDE = 10  # lane b runs scans [10 b, 10 b + 75) of the figure-8 feed
BATCH_TRACED = 15  # the replay's last steps, traced
BATCH_CACHED_SCANS = 20
# each lane's ATE (m) in the JAX package's odom_rollout of its window at this
# width, on the CPU (tests/test_torch_batch_eval.py::test_figure8_windows_jax_reference);
# from scan 0 the reference reads 0.02 m, as the per-scan phase, but three windows
# started mid-path read 0.11-0.18 m in the reference itself, so each lane is held to
# max(0.10 m, its window's reading + 1 cm). The cause is the empty map a window
# starts from, not the filter's start state: merged3 matches under 100 points in
# scan 1 against a one-scan map, and on the map built from scan 0 a fresh filter
# reads 0.02 m on those windows in both packages
# (tests/test_torch_batch_eval.py::test_figure8_windows_drift_source)
BATCH_JAX_ATE_M = (0.0198, 0.1114, 0.1686, 0.0641, 0.1578, 0.0697, 0.0539, 0.0169)
BATCH_CACHED_JAX_ATE_M = (0.0638, 0.0380, 0.0676, 0.0184, 0.0325, 0.0257, 0.1782, 0.0093)
BATCH_ATE_GATE, BATCH_ATE_MARGIN = 0.10, 0.01
BATCH_VS_UNBATCHED_M = 5e-3  # over the first 4 scans: tests/test_batch_eval.py's bound
BATCH_KERNEL_LANES = (8, 32)  # the insert's lane counts; the association's 8 and a ragged 3


def batch_inputs(dev, feed, firsts, n_scans: int):
    """The windows ``[f, f + n_scans)`` of the feed stacked lane by lane on
    the card, ``(Scan, ImuBatch)`` with ``(B, S, ...)`` members, and their
    ground-truth positions ``(B, S, 3)``."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan

    def stack(key):
        return torch.from_numpy(np.stack([feed[key][f:f + n_scans] for f in firsts])).to(dev)

    return (Scan(stack("xyz"), stack("toff"), stack("mask")),
            ImuBatch(stack("imu_t"), stack("imu_g"), stack("imu_a"), stack("imu_m")),
            np.stack([feed["gt_p"][f:f + n_scans] for f in firsts]))


def batch_states(dev, feed, firsts, cfg, map_cfg):
    """``init_odom(..., lanes=B)`` with lane b at the ground truth's pose and
    velocity where its window starts (the end of scan ``f - 1``; the feed
    starts at t = 0)."""
    import torch

    from fastliosam_tpu_torch.odom import init_odom

    traj = figure8_traj()
    t0 = [float(feed["stamps"][f] - feed["stamps"][0]) for f in firsts]
    R = np.stack([traj.pose(t)[0] for t in t0]).astype(np.float32)
    p = np.stack([traj.pose(t)[1] for t in t0]).astype(np.float32)
    v = np.stack([traj.velocity(t) for t in t0]).astype(np.float32)
    st = init_odom(map_cfg, cfg, device=dev, lanes=len(firsts))
    return st._replace(nav=st.nav._replace(
        R=torch.from_numpy(R).to(dev), p=torch.from_numpy(p).to(dev),
        v=torch.from_numpy(v).to(dev)))


def _window(tree, k0: int, k1: int):
    """Scans ``[k0, k1)`` of every lane of a ``(B, S, ...)`` stack."""
    return type(tree)(*(t[:, k0:k1] for t in tree))


def _lane_ate(p, gt) -> np.ndarray:
    return np.sqrt(np.mean(np.sum((p - gt) ** 2, axis=-1), axis=-1))


def _same(a: dict, b: dict, lanes_a=slice(None), lanes_b=slice(None)) -> bool:
    """Bit-identical poses and match counts of the given lanes."""
    import torch

    return all(torch.equal(a[k][lanes_a], b[k][lanes_b]) for k in ("R", "p", "n_matched"))


def batched_phase(dev, feed, floor) -> dict:
    """``batched_rollout`` at the per-scan phase's width (8 lanes x 75
    scans, lane b over scans [10 b, 10 b + 75) from the ground truth there):
    each lane's ATE, the matches a scan, the replay (its last steps traced),
    lane isolation, lane 0 against the unbatched ``odom_rollout``, the map
    kernels' launches a step at 1 lane and at 8, and a cached-mode batch
    (8 lanes x 20 scans); then the lane kernels at the rollout's maps
    (``check_lane_kernels``)."""
    import torch

    from fastliosam_tpu_torch.eval.batch_eval import batched_rollout
    from fastliosam_tpu_torch.odom import ImuBatch, Scan, init_odom, odom_rollout
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev)
    cfg, map_cfg = engine.odom_cfg, engine.map_cfg
    del engine
    dt = float(feed["scan_dt"])
    n_scans = min(BATCH_SCANS, len(feed["stamps"]) - BATCH_STRIDE * (BATCH_LANES - 1))
    firsts = [BATCH_STRIDE * b for b in range(BATCH_LANES)]
    scans, imus, gt = batch_inputs(dev, feed, firsts, n_scans)

    def roll(states, sc, im, cfg_=cfg):
        return batched_rollout(states, sc, im, dt, cfg_, map_cfg, device=dev)

    def fresh(fs=firsts, cfg_=cfg):
        return batch_states(dev, feed, fs, cfg_, map_cfg)

    roll(fresh(), _window(scans, 0, 3), _window(imus, 0, 3))  # warm-up: allocator, cuBLAS
    states = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    (fin, aux), launches = _launch_counts(lambda: roll(states, scans, imus))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    p, matched = aux["p"].cpu().numpy(), aux["n_matched"].cpu().numpy()
    ate = _lane_ate(p, gt)

    # the replay, its last steps traced (tracing changes no result)
    split = n_scans - BATCH_TRACED
    st2, first = roll(fresh(), _window(scans, 0, split), _window(imus, 0, split))
    prof, t_prof = _start_profile()
    fin2, last = roll(st2, _window(scans, split, n_scans), _window(imus, split, n_scans))
    torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t_prof
    prof.__exit__(None, None, None)
    print(f"  traced: the replay's last {BATCH_TRACED} batched steps "
          f"({BATCH_LANES} lanes each)")
    prof_sum = profile_summary(prof, prof_wall, BATCH_TRACED)
    replay = {k: torch.cat([first[k], last[k]], 1) for k in ("R", "p", "n_matched")}
    replay_ok = _same(replay, aux) and all(torch.equal(a, b) for a, b in zip(fin2.vmap, fin.vmap))

    # lane isolation: lane 7 carries lane 0's window
    iso_firsts = firsts[:-1] + [firsts[0]]
    iso_scans, iso_imus, _ = batch_inputs(dev, feed, iso_firsts, n_scans)
    _, iso = roll(fresh(iso_firsts), iso_scans, iso_imus)
    last_lane = BATCH_LANES - 1
    iso_others = _same(iso, aux, slice(0, last_lane), slice(0, last_lane))
    iso_copy = _same(iso, iso, slice(last_lane, None), slice(0, 1))

    # launches a step at 1 lane, over the first 5 scans of lane 0's window
    one_scans = 5
    one_sc = Scan(*(t[:1, :one_scans] for t in scans))
    one_im = ImuBatch(*(t[:1, :one_scans] for t in imus))
    _, one = _launch_counts(lambda: roll(fresh(firsts[:1]), one_sc, one_im))
    per_step = {k: {"lanes_8": launches[k] / n_scans, "lanes_1": one[k] / one_scans}
                for k in ("merged_moments", "insert_claim")}

    # lane 0 against the unbatched rollout of its window
    st1 = init_odom(map_cfg, cfg, device=dev)
    nav0 = fresh(firsts[:1]).nav
    st1 = st1._replace(nav=type(st1.nav)(*(t[0] for t in nav0)))
    _, ref = odom_rollout(st1, Scan(*(t[0] for t in scans)), ImuBatch(*(t[0] for t in imus)),
                          dt, cfg, map_cfg, device=dev)
    diff = np.abs(p[0] - ref["p"].cpu().numpy()).max(axis=-1)

    # the cached query mode: its two lane kernels on the rollout's path
    ccfg = cfg._replace(query_mode="cached")
    c_scans, c_imus, c_gt = batch_inputs(dev, feed, firsts, BATCH_CACHED_SCANS)
    (_, c_aux), c_launches = _launch_counts(
        lambda: roll(fresh(cfg_=ccfg), c_scans, c_imus, ccfg))
    c_ate = _lane_ate(c_aux["p"].cpu().numpy(), c_gt)
    lanes = len(firsts)
    gate = np.maximum(BATCH_ATE_GATE, np.asarray(BATCH_JAX_ATE_M[:lanes]) + BATCH_ATE_MARGIN)
    c_gate = np.maximum(BATCH_ATE_GATE,
                        np.asarray(BATCH_CACHED_JAX_ATE_M[:lanes]) + BATCH_ATE_MARGIN)

    result = {
        "lanes": BATCH_LANES, "scans": n_scans, "wall_s": wall,
        "lane_scans_per_s": BATCH_LANES * n_scans / wall,
        "ate_m": ate.tolist(), "ate_gate_m": gate.tolist(), "jax_cpu_ate_m": BATCH_JAX_ATE_M,
        "min_matched_from_scan3": matched[:, 3:].min(axis=1).tolist(),
        "replay_bit_identical": replay_ok,
        "isolation_lanes_0_6_unchanged": iso_others, "isolation_lane7_equals_lane0": iso_copy,
        "lane0_vs_unbatched_first4_m": float(diff[:4].max()),
        "lane0_vs_unbatched_window_m": float(diff.max()),
        "launches": launches, "launches_per_step": per_step,
        "device_ops_per_step": prof_sum["device_ops_per_scan"],
        "device_idle_share": prof_sum["device_idle_share"],
        "max_memory_allocated_bytes": int(peak),
        "cached": {"scans": BATCH_CACHED_SCANS, "ate_m": c_ate.tolist(),
                   "ate_gate_m": c_gate.tolist(), "jax_cpu_ate_m": BATCH_CACHED_JAX_ATE_M,
                   "launches": c_launches},
    }
    print("  " + json.dumps(result))
    print(f"  {BATCH_LANES} lanes x {n_scans} scans: {result['lane_scans_per_s']:.2f} lane-scans/s "
          f"({wall:.3f} s), ATE per lane {np.round(ate, 4).tolist()} m (JAX on the CPU "
          f"{list(BATCH_JAX_ATE_M)}; gates {np.round(gate, 4).tolist()}), "
          f"lane 0 against the unbatched rollout {result['lane0_vs_unbatched_first4_m']:.3g} m over "
          f"4 scans, {result['lane0_vs_unbatched_window_m']:.3g} m over the window; "
          f"{result['device_ops_per_step']:.0f} device ops a batched step, device idle "
          f"{result['device_idle_share']:.1%}; peak memory {peak / 2**30:.3f} GiB; "
          f"cached mode ATE per lane {np.round(c_ate, 4).tolist()} m (JAX on the CPU "
          f"{list(BATCH_CACHED_JAX_ATE_M)})")
    _fail("batched phase", {
        "every pose finite": bool(np.all(np.isfinite(p))),
        f"ATE < max({BATCH_ATE_GATE} m, the reference's + {BATCH_ATE_MARGIN} m) in every lane":
            bool(np.all(ate < gate)),
        "n_matched > 500 a scan in every lane from scan 3 on": bool(matched[:, 3:].min() > 500),
        "replay bit-identical": replay_ok,
        "lanes 0-6 bit-identical with lane 7 changed": iso_others,
        "lane 7 bit-identical with lane 0 on lane 0's window": iso_copy,
        f"lane 0 within {BATCH_VS_UNBATCHED_M} m of the unbatched rollout over 4 scans":
            result["lane0_vs_unbatched_first4_m"] <= BATCH_VS_UNBATCHED_M,
        "merged_moments and insert_claim launched": min(launches["merged_moments"],
                                                        launches["insert_claim"]) > 0,
        "merged_moments and insert_claim launch as often a step at 8 lanes as at 1":
            all(v["lanes_8"] == v["lanes_1"] for v in per_step.values()),
        "cached mode: query_cached, gather_rows and insert_claim launched":
            min(c_launches[k] for k in ("query_cached", "gather_rows", "insert_claim")) > 0,
        "cached mode: ATE < max(0.10 m, the reference's + 0.01 m) in every lane":
            bool(np.all(c_ate < c_gate)),
    })
    result["kernels"] = check_lane_kernels(dev, feed, fin, aux, cfg, map_cfg, firsts, floor)
    return result


def _lane_queries(dev, feed, aux, firsts, back: int, n: int = 8192, seed: int = 0):
    """``(B, n, 3)`` queries: ``n`` points of scan ``f + S - 1 - back`` of
    each lane's window at the lane's pose of that scan (world frame, not
    deskewed), as its iEKF queries them."""
    import torch

    rng = np.random.default_rng(seed + back)
    k = aux["p"].shape[1] - 1 - back
    out = []
    for b, f in enumerate(firsts):
        keep = np.nonzero(feed["mask"][f + k])[0]
        pick = torch.from_numpy(np.sort(rng.choice(keep, n, replace=False))).to(dev)
        xyz = torch.from_numpy(feed["xyz"][f + k]).to(dev)[pick]
        out.append(xyz @ aux["R"][b, k].T + aux["p"][b, k])
    return torch.stack(out).contiguous()


def _lane_downsampled(dev, feed, aux, firsts, back: int, budget: int = 8192):
    """Each lane's scan ``f + S - 1 - back`` downsampled as the odometry
    does and placed at the lane's pose: ``(xyz (B, budget, 3), mask)``."""
    import torch

    k = aux["p"].shape[1] - 1 - back
    pts, masks = [], []
    for b, f in enumerate(firsts):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = aux["R"][b, k].cpu().numpy(), aux["p"][b, k].cpu().numpy()
        xyz, mask = _downsampled_world(feed, f + k, pose, dev, budget)
        pts.append(xyz)
        masks.append(mask)
    return torch.stack(pts).contiguous(), torch.stack(masks).contiguous()


def check_lane_kernels(dev, feed, fin, aux, cfg, map_cfg, firsts, floor, reps: int = 5) -> dict:
    """The map kernels at the batched rollout's lane shapes, each bit for
    bit against its lane-batched plain version AND, lane by lane, against
    the unbatched kernel on that lane's table alone: ``merged_moments`` on
    the 8 lanes' 2^19-slot maps after the rollout (8 x 8192 queries, merged3
    pools, 2 probes; and a ragged 3 lanes x 5000), ``insert_claim`` of 8 x
    8192 and 32 x 8192 downsampled points (the 8 maps four times over; 2
    rounds, one cooperative launch), ``query_cached`` on the maps with their
    planes fitted and ``gather_rows`` of the moment rows at the insert's
    slots (beside ``torch.gather`` of the same rows, its library call). Each
    timed over ``reps`` fresh input sets as the other kernels are, beside
    the timing floor and its HBM byte bound."""
    import torch

    from fastliosam_tpu_torch.core import voxel
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import assoc_cuda, gather_cuda, insert_cuda, query_cuda
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes
    from fastliosam_tpu_torch.utils.timing import device_ms

    m = fin.vmap
    c, vs, probes = map_cfg.capacity, map_cfg.voxel_size, map_cfg.query_probes
    rounds = max(map_cfg.insert_probes, map_cfg.claim_probes)
    maxp = map_cfg.max_points_per_voxel
    lanes = m.fp.shape[0]
    fp_np = m.fp.cpu().numpy()
    floor_ms = floor["132_blocks"]
    out = {}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def equal(a, b):
        return torch.equal(bits(a), bits(b))

    def record(name, shape, ms, plain_ms, nbytes, library_ms=None, **extra):
        bound = nbytes / H100_BYTES_PER_S * 1e3
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  {name} at {shape}: equal to its plain version and, lane by lane, to the "
              f"unbatched kernel; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
              f"bound {bound:.5f} ms ({nbytes:.0f} HBM bytes), floor {floor_ms:.4f} ms"
              + "".join(f", {k} {v}" for k, v in extra.items()))
        return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
                "timing_floor_ms": floor_ms, **extra}

    # -- the association: 8 lanes x 8192 queries, 3 pools, 2 probes; ragged 3 x 5000
    sets = []
    for back in range(reps):
        xyz = _lane_queries(dev, feed, aux, firsts, back)
        coords0, pools = vh.merged3_pools(xyz, vs)
        sets.append((pools, coords0, torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)))
    args, tail = (m.fp, m.moments), (vs, probes)
    for pools, coords0, mask in sets:
        got = assoc_cuda.merged_moments_cuda(*args, pools, coords0, mask, *tail)
        want = assoc_cuda.merged_moments_ref(*args, pools, coords0, mask, *tail)
        lane = [assoc_cuda.merged_moments_cuda(m.fp[b], m.moments[b], pools[:, b].contiguous(),
                                               coords0[b], mask[b], *tail) for b in range(lanes)]
        rag = (slice(0, 3), slice(0, 5000))
        r_pools, r_c0, r_mask = (pools[(slice(None),) + rag].contiguous(),
                                 coords0[rag].contiguous(), mask[rag].contiguous())
        r_got = assoc_cuda.merged_moments_cuda(m.fp[:3], m.moments[:3], r_pools, r_c0, r_mask,
                                               *tail)
        r_want = assoc_cuda.merged_moments_ref(m.fp[:3], m.moments[:3], r_pools, r_c0, r_mask,
                                               *tail)
        torch.cuda.synchronize()
        if not (equal(got, want) and all(equal(got[b], lane[b]) for b in range(lanes))
                and equal(r_got, r_want) and equal(r_got, got[:3, :5000])):
            raise AssertionError("merged_moments at lanes: kernel, plain version and the "
                                 "unbatched kernel per lane differ")
    ms = device_ms(lambda p, c0, k: assoc_cuda.merged_moments_cuda(*args, p, c0, k, *tail), sets)
    plain_ms = device_ms(lambda p, c0, k: assoc_cuda.merged_moments_ref(*args, p, c0, k, *tail),
                         sets)
    nbytes = []
    for pools, coords0, mask in sets:
        h0 = voxel.hash_slot(pools, c).to(torch.int64).cpu().numpy()  # (P, B, n)
        want = voxel.fingerprint(pools).cpu().numpy()
        base = (np.arange(lanes) * c)[None, :, None, None]
        cand = ((h0[..., None] + np.arange(probes)) & (c - 1)) + base  # global slots
        hit = fp_np.reshape(-1)[cand] == want[..., None]
        anyhit = hit.any(-1)
        found = cand[anyhit, hit[anyhit].argmax(-1)]
        n_q = coords0.shape[0] * coords0.shape[1]
        nbytes.append(sector_bytes(cand.reshape(-1), 1) + sector_bytes(found, 10)
                      + pools.numel() * 4 + coords0.numel() * 4 + n_q + n_q * 13 * 4)
    out["merged_moments"] = record(
        "merged_moments", f"{lanes} lanes x 8192 queries x 3 pools x {probes} probes "
        "(and a ragged 3 lanes x 5000)", ms, plain_ms, float(np.mean(nbytes)))

    # -- the insert: 8 and 32 lanes x 8192 points, one cooperative launch each
    pts = [_lane_downsampled(dev, feed, aux, firsts, back) for back in range(reps)]
    for n_lanes in BATCH_KERNEL_LANES:
        tile = n_lanes // lanes
        fp, coords, moments = (torch.cat([t] * tile) for t in (m.fp, m.coords, m.moments))
        # lanes past the 8th take later scans of their lane's window
        lane_sets = []
        for back in range(reps):
            xyz = torch.cat([pts[(back + k) % reps][0] for k in range(tile)]).contiguous()
            mask = torch.cat([pts[(back + k) % reps][1] for k in range(tile)]).contiguous()
            lane_sets.append((xyz, mask))
        blocks, per_thread = insert_cuda.insert_claim_grid(n_lanes * 8192, dev)
        for xyz, mask in lane_sets:
            got = insert_cuda.insert_claim_cuda(fp, coords, moments, xyz, mask, vs, rounds, maxp)
            want = insert_cuda.insert_claim_ref(fp, coords, moments, xyz, mask, vs, rounds, maxp)
            assigned = want[2] < c
            ok = (equal(got[0], want[0]) and equal(got[1], want[1]) and equal(got[2], want[2])
                  and equal(got[4], want[4])
                  and equal(got[3][assigned], want[3][assigned]))
            for b in range(n_lanes):
                one = insert_cuda.insert_claim_cuda(fp[b], coords[b], moments[b], xyz[b],
                                                    mask[b], vs, rounds, maxp)
                ok = ok and (equal(got[0][b], one[0]) and equal(got[1][b], one[1])
                             and equal(got[2][b], one[2]) and equal(got[4][b], one[4])
                             and equal(got[3][b][assigned[b]], one[3][assigned[b]]))
            torch.cuda.synchronize()
            if not ok:
                raise AssertionError(f"insert_claim at {n_lanes} lanes: kernel, plain version "
                                     "and the unbatched kernel per lane differ")
        copies = iter([(fp.clone(), coords.clone()) for _ in range(reps + 3)])
        ms = device_ms(lambda x, k: insert_cuda.insert_claim_into(*next(copies), moments, x, k,
                                                                  vs, rounds, maxp), lane_sets)
        plain_ms = device_ms(lambda x, k: insert_cuda.insert_claim_ref(
            fp, coords, moments, x, k, vs, rounds, maxp), lane_sets)
        nbytes = []
        for xyz, mask in lane_sets:
            sl = insert_cuda.insert_claim_cuda(fp, coords, moments, xyz, mask, vs, rounds,
                                               maxp)[2]
            nbytes.append(sum(_insert_bytes(fp_np[b % lanes], map_cfg, xyz[b], mask[b], sl[b],
                                            rounds) for b in range(n_lanes)))
        key = "insert_claim" if n_lanes == lanes else f"insert_claim_{n_lanes}_lanes"
        out[key] = record("insert_claim", f"{n_lanes} lanes x 8192 points, {rounds} rounds",
                          ms, plain_ms, float(np.mean(nbytes)),
                          grid=f"{blocks} x 256 threads, {per_thread} point(s) a thread")
    out["insert_claim"]["at_32_lanes"] = out.pop(f"insert_claim_{BATCH_KERNEL_LANES[1]}_lanes")

    # -- the cached mode's two: the query on the maps with planes fitted, the
    # plane refresh's gather of the moment rows at the insert's slots
    lane_maps = [_cached_map(vh.VoxelMap(*(t[b] for t in m)), map_cfg) for b in range(lanes)]
    cm = vh.VoxelMap(*(torch.stack(f) for f in zip(*lane_maps)))
    q_sets = [(_lane_queries(dev, feed, aux, firsts, back),) for back in range(reps)]
    qargs = (cm.fp, cm.normal, cm.d, cm.plane_valid)
    ones = torch.ones((lanes, 8192), dtype=torch.bool, device=dev)
    for (xyz,) in q_sets:
        got = query_cuda.query_cached_cuda(*qargs, xyz, ones, vs, probes)
        want = query_cuda.query_cached_ref(*qargs, xyz, ones, vs, probes)
        ok = all(equal(a, b) for a, b in zip(got, want))
        for b in range(lanes):
            one = query_cuda.query_cached_cuda(cm.fp[b], cm.normal[b], cm.d[b],
                                               cm.plane_valid[b], xyz[b], ones[b], vs, probes)
            ok = ok and all(equal(a[b], o) for a, o in zip(got, one))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError("query_cached at lanes: kernel, plain version and the "
                                 "unbatched kernel per lane differ")
    ms = device_ms(lambda x: query_cuda.query_cached_cuda(*qargs, x, ones, vs, probes), q_sets)
    plain_ms = device_ms(lambda x: query_cuda.query_cached_ref(*qargs, x, ones, vs, probes),
                         q_sets)
    nbytes = float(np.mean([sum(_query_bytes(cm.fp[b], map_cfg, xyz[b], ones[b])
                                for b in range(lanes)) for (xyz,) in q_sets]))
    out["query_cached"] = record("query_cached", f"{lanes} lanes x 8192 queries, {probes} probes",
                                 ms, plain_ms, nbytes)
    g_sets = [(insert_cuda.insert_claim_cuda(m.fp, m.coords, m.moments, x, k, vs, rounds,
                                             maxp)[2],) for x, k in pts]
    for (sl,) in g_sets:
        got = gather_cuda.gather_rows_cuda(m.moments, sl, lane_major=True)
        want = gather_cuda.gather_rows_ref(m.moments, sl, lane_major=True)
        ok = equal(got, want) and all(
            equal(got[b], gather_cuda.gather_rows_cuda(m.moments[b], sl[b])) for b in range(lanes))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError("gather_rows at lanes: kernel, plain version and the unbatched "
                                 "kernel per lane differ")
    ms = device_ms(lambda s: gather_cuda.gather_rows_cuda(m.moments, s, lane_major=True), g_sets)
    plain_ms = device_ms(lambda s: gather_cuda.gather_rows_ref(m.moments, s, lane_major=True),
                         g_sets)
    # the library's one call for the same rows: torch.gather along each lane's
    # slot dim, reading the slots clamped to C - 1 beforehand (the drop slot C
    # reads row C - 1, as the kernel's index rule does)
    wide = [(s.clamp(max=c - 1)[..., None].expand(-1, -1, m.moments.shape[-1]),)
            for (s,) in g_sets]
    for (s,), (i,) in zip(g_sets, wide):
        if not equal(torch.gather(m.moments, 1, i),
                     gather_cuda.gather_rows_cuda(m.moments, s, lane_major=True)):
            raise AssertionError("gather_rows at lanes: torch.gather reads other rows")
    library_ms = device_ms(lambda i: torch.gather(m.moments, 1, i), wide)
    nbytes = float(np.mean([
        sector_bytes((np.clip(s.cpu().numpy(), 0, c - 1) + (np.arange(lanes) * c)[:, None]), 10)
        + s.numel() * (8 + 40) for (s,) in g_sets]))
    out["gather_rows"] = record("gather_rows", f"({lanes}, 2^{c.bit_length() - 1}, 10) moment "
                                f"rows x ({lanes}, 8192) int64 slots, lane-major", ms, plain_ms,
                                nbytes, library_ms=library_ms)
    return out


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
    ap.add_argument("--corridor-scans", type=int, default=200,
                    help="GPS corridor scans (the bench runs 400; cut to keep the script "
                    "inside its time)")
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

    # the KITTI sequence (~1000 s of host time) is written by its own
    # worker processes from the start, while every earlier phase runs
    kitti_pool = ThreadPoolExecutor(max_workers=1)
    kitti_job = kitti_pool.submit(kitti_feed)
    # the feeds take minutes of host time: two worker processes make them
    # while the kernels build and the kernel phase runs; the bag phase's
    # recording follows in one of them at nice 10 (as the KITTI generators
    # run) while the engine phases run, and the pool is shut down once it
    # is made (more worker processes at once took the 8-core host down)
    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        fig8_job = pool.submit(figure8_feed, args.scans)
        corridor_job = pool.submit(corridor_feed, args.corridor_scans)
        bag_job = pool.submit(bag_feed, args.scans)

        t0 = time.perf_counter()
        build.build(build.sources())
        print(f"build: {len(build.sources())} source(s) in {time.perf_counter() - t0:.1f} s")
        for name, log in sorted(build.build_logs.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}.cu: {line.strip()}")

        with geometry_precision():
            print("kernel phase:")
            floor = {f"{b}_blocks": launch_floor_ms(b) for b in (1, 132)}
            print(f"  timing floor: an empty kernel (csrc/empty.cu) timed as the kernels are: "
                  f"1 block {floor['1_blocks']:.4f} ms, 132 blocks {floor['132_blocks']:.4f} ms")
            kernels = {"nearest_neighbors": check_nn(dev, args.seed)}
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
            print("kernel phase, row gather, association and insert (on the figure-8 map):")
            fig8_map = figure8_map(dev, fig8)
            kernels["gather_rows"], gather_cases = check_gather(dev, args.seed, *fig8_map[3:])
            kernels["merged_moments"] = check_assoc(dev, fig8, fig8_map)
            kernels["insert_claim"] = check_insert(dev, fig8, fig8_map)
            kernels["query_cached"] = check_query(dev, fig8, fig8_map)
            del fig8_map
            print("per-scan phase (SlamEngine.process):")
            per_scan = per_scan_phase(dev, fig8)
            print(f"chunked phase (SlamEngine.process_chunk_deferred, chunk {args.chunk}):")
            chunked = chunked_phase(dev, fig8, args.chunk)
            print(f"GPS phase (corridor, SlamEngine.process_chunk, chunk {args.chunk}):")
            gps = gps_phase(dev, corridor, args.chunk)
            print("modes phase (cached + point-to-plane per scan; merged2 + multi-start chunked):")
            modes = modes_phase(dev, fig8, args.chunk)
            t0 = time.perf_counter()
            kitti_root, kitti_s = kitti_job.result()
            kitti_pool.shutdown()
            print(f"KITTI phase ({KITTI_SCANS} scans generated in {kitti_s:.1f} s, "
                  f"{time.perf_counter() - t0:.1f} s more to wait for):")
            kitti = kitti_phase(dev, kitti_root, args.chunk)
            kitti["feed_s"] = kitti_s
            t0 = time.perf_counter()
            bag_dir = bag_job.result()
            print(f"bag phase (run_slam --dataset bag|mulran|newer-college, {OS1_64[0]} x "
                  f"{OS1_64[1]} rays; {time.perf_counter() - t0:.1f} s more to wait for the "
                  f"recording):")
            bag = bag_phase(dev, bag_dir)
            print(f"batched phase (eval/batch_eval.py: batched_rollout, {BATCH_LANES} lanes x "
                  f"{BATCH_SCANS} figure-8 scans):")
            batched = batched_phase(dev, fig8, floor)
            if args.profile_scans > 0:
                print(f"profile (SlamEngine.process, last {args.profile_scans} scans):")
                per_scan["profile"] = profile_phase(dev, fig8, args.profile_scans)
    finally:
        pool.shutdown(cancel_futures=True)

    paths = {"per_scan": per_scan["launches"], "chunked": chunked["launches"],
             "gps": gps["launches"], "exp_gather": exp_launches,
             **{f"modes_{k}": r["launches"] for k, r in modes.items()},
             "kitti_longrun": kitti["longrun"]["launches"],
             "kitti_resume": kitti["resume"]["launches"],
             "kitti_localize": kitti["localize"]["launches"],
             **{k: r["launches"] for k, r in bag.items()},
             "batched": batched["launches"], "batched_cached": batched["cached"]["launches"]}
    shapes = kitti["kernel_shapes"]
    at_localizer = {"nearest_neighbors": shapes["nearest_neighbors"],
                    "insert_claim": shapes["insert_claim"],
                    "gather_rows": {k: shapes[f"gather_rows_{k}"] for k in ("moments", "coords")}}
    line = {"kernels": [], "timing_floor_ms": floor}
    for mod in KERNEL_MODULES:
        rec = dict(mod.KERNEL)
        name = rec["name"]
        rec["launches"] = sum(p[name] for p in paths.values())
        rec["launches_by_path"] = {k: p[name] for k, p in paths.items()}
        rec.update(kernels[name])
        if name in at_localizer:
            rec["at_localizer_shape"] = at_localizer[name]
        if name in batched["kernels"]:
            rec["at_lanes"] = batched["kernels"][name]
        line["kernels"].append(rec)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card_line(), "kernels": line["kernels"], "gather_cases": gather_cases,
             "exp_gather": exp_recs, "per_scan": per_scan, "chunked": chunked, "gps": gps,
             "modes": modes, "kitti": kitti, "bag": bag, "batched": batched,
             "timing_floor_ms": floor,
             "total_s": time.perf_counter() - t_start},
            indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
