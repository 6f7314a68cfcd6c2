#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastliosam_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds and runs there.

    python3 chip_smoke.py [--scans 150] [--corridor-scans 200] [--out results.json]
                          [--profile-scans N]

Phases, each of which fails the script (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi); the two sim feeds start
     generating in two worker processes (they take ~1-2 minutes of host
     time and are cached under build/), and the KITTI sequence of phase 7
     in its own worker processes;
  2. build every CUDA kernel of the package from ``fastliosam_tpu_torch/csrc``
     (one nvcc per source, all started together) into ``build/kernels/``;
  3. kernel phase: each kernel against its plain PyTorch version on the card
     at the main path's shapes plus ragged ones (the gathers, the
     association and the insert bit for bit; the nearest neighbours also
     on ties planted across its destination slices, and twice for
     identical words), timed with CUDA events around back-to-back device
     work (fresh indices or queries; ``utils/timing.py``) beside the
     plain version, a one-call PyTorch yardstick that the port never calls
     (where one exists), and its bound; then the gather experiment entry
     point (``fastliosam_tpu_torch.scripts.exp_gather``), the path of
     ``take_along_axis``, with its random-read ceiling probe; the row
     gather (``gather_rows``), the association kernel (``merged_moments``)
     and the map insert's kernel (``insert_claim``) are checked once the
     figure-8 feed is made: the gather on the loop closure's plane-refresh
     reads of submaps around the engine's keyframes after 30 scans, the
     other two on the engine's own 2^19-slot map after 20 scans (the
     insert also on a tight table that drops points and on an evicted map);
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
  7. KITTI phase, the dataset entry point at the bench's width and depth
     (``bench.py: bench_kitti_longrun``): ``drive_kitti`` over the
     1160-scan synthetic KITTI circuit read by the native reader (q16
     upload, chunk 5, deferred), with a loop audit against ground truth,
     and the same run loop-free and with the raw float upload;
     ``save_results`` with its files checked;
     a checkpoint at scan 300 that a restored engine must continue over
     scans 300-400 bit for bit with the engine that saved it;
     ``MapLocalizer`` on the exported bundle (global init from a pose
     perturbed by 1 m and 5 degrees, 200 scans, every step matching
     points); and the NN, insert and row gather against their plain
     versions at the localizer's shapes (8192 x 2^19, 65,536 points, (2^19,
     10|3) x 65,536), printed under ``at_localizer_shape``.
Every kernel's launch count is set to 0 just before each path and read
just after; each kernel must have launched on its path (the nearest
neighbours and the row gather (the loop closure's plane refresh) on the
loop-closing phases 4 and 5, the association and the insert on 4-6,
all four on the KITTI long run and the localizer, take_along_axis on the
experiment entry point). Phases 4-6 report the
insert's, the association's and the row gather's launches per scan, and
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


def check_gather(dev, seed: int, plane_sets):
    """The row gather against its plain version, bit for bit, at the shapes
    the main path gives it: the loop closure's plane refresh
    (``map/voxel_hash.py: _fit_planes`` on the throwaway map of
    ``loop/closure.py: _dst_surfel_map``), which reads the (2^14, 10)
    moments and the (2^14, 3) int32 voxel coordinates at the 16,384 int64
    slots of the submap's insert (``plane_sets``, one set per submap); and
    a ragged 1000 x 3 case with a found-mask and negative and out-of-range
    indices. Each is timed over its sets beside the plain version and
    (unmasked) ``torch.index_select`` (experiments A and B's shapes are
    timed by the experiment entry point). Returns the record of the moment read (the
    kernels line) and every case's record."""
    import torch

    from fastliosam_tpu_torch.ops import gather_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    rng = np.random.default_rng(seed)
    ragged = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(1000, 3),
                                           dtype=np.int64).astype(np.int32)).to(dev)
    cases = {  # name: [(table, idx, valid)] with fresh indices per set
        "plane_moments": [(mom, sl, None) for mom, _, sl in plane_sets],
        "plane_coords": [(crd, sl, None) for _, crd, sl in plane_sets],
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
            # reads the slots clamped to C - 1 beforehand: the same rows
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
    main = {k: records["plane_moments"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms")}
    return main, records


def plane_refresh_sets(dev, engine, n_sets: int = 10):
    """The inputs of the loop closure's plane refresh, as
    ``loop/closure.py: _dst_surfel_map`` makes them: the submap
    (``build_submap``) around each of up to ``n_sets`` of the engine's
    keyframes (from the middle of its store) inserted into a throwaway
    2^14-slot map; ``(moments (2^14, 10), coords (2^14, 3), sl (16,384,)
    int64)`` each, the tables after the insert and the slots it gave."""
    from fastliosam_tpu_torch.loop.closure import build_submap
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda

    lc, kf = engine.loop_cfg, engine.kf
    cfg = vh.VoxelMapConfig(capacity=1 << 14, voxel_size=lc.aniso_voxel, min_points=5)
    lo = max(0, (kf.n - n_sets) // 2)
    out = []
    for centre in range(lo, min(kf.n, lo + n_sets)):
        dst, mask = build_submap(kf.clouds, kf.masks, engine.graph.poses,
                                 engine.graph.kf_valid, centre, lc)
        dst, mask = dst.contiguous(), mask.contiguous()
        empty = vh.make_map(cfg, dev)
        sl = insert_cuda.insert_claim(
            empty.fp, empty.coords, empty.moments, dst, mask, cfg.voxel_size,
            max(cfg.insert_probes, cfg.claim_probes), cfg.max_points_per_voxel)[2]
        m, _ = vh.insert(empty, cfg, dst, mask, refresh_planes=False)
        out.append((m.moments, m.coords, sl))
    return out


def figure8_map(dev, feed, n_map_scans: int = 20, n_more: int = 10):
    """The engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``SlamEngine.process``, 2 probes), its config, the engine's poses of
    the first ``n_map_scans + n_more`` scans (a second run from
    ``reset()``, which replays the first bit for bit) and the plane-refresh
    inputs of loop-closure submaps around its keyframes then
    (``plane_refresh_sets``)."""
    engine = make_engine(dev)
    run_engine(engine, feed, dev, n_map_scans)
    m = type(engine.odom.vmap)(*(t.clone() for t in engine.odom.vmap))
    run_engine(engine, feed, dev, n_map_scans + n_more)
    return (m, engine.map_cfg, np.stack(engine.realtime_traj).astype(np.float32),
            plane_refresh_sets(dev, engine))


def check_assoc(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The association kernel against its plain version, bit for bit: the
    engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``figure8_map``), queried with 8192 points of each of its last
    ``reps`` scans at the engine's poses (world frame, not deskewed), in the
    merged3 pools (3 per query). Timed over those fresh query sets beside
    the plain version. Returns the record (the kernels line)."""
    import torch

    from fastliosam_tpu_torch.core import voxel
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import assoc_cuda
    from fastliosam_tpu_torch.scripts.exp_gather import sector_bytes
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, _ = fig8
    rng = np.random.default_rng(n_map_scans)
    sets, nbytes = [], []
    fp_np = m.fp.cpu().numpy()
    for k in range(n_map_scans - reps, n_map_scans):
        # scan k's points at the engine's pose of scan k, as its iEKF queries them
        pose = torch.from_numpy(traj[k]).to(dev)
        keep = np.nonzero(feed["mask"][k])[0]
        pick = torch.from_numpy(np.sort(rng.choice(keep, 8192, replace=False))).to(dev)
        xyz = torch.from_numpy(feed["xyz"][k]).to(dev)[pick] @ pose[:3, :3].T + pose[:3, 3]
        coords0, pools = vh.merged3_pools(xyz, cfg.voxel_size)
        mask = torch.ones(8192, dtype=torch.bool, device=dev)
        sets.append((pools, coords0, mask))
        # HBM bytes: the probed fingerprint sectors and the found rows'
        # sectors (distinct), the coordinates and mask read, the output
        h0 = voxel.hash_slot(pools, cfg.capacity).to(torch.int64).cpu().numpy().reshape(-1)
        want = voxel.fingerprint(pools).cpu().numpy().reshape(-1)
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

    m, cfg, traj, _ = fig8
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
    print(f"  insert_claim: equal on the figure-8 map ({reps} scans, "
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
    plain_ms = device_ms(lambda x, k: insert_cuda.insert_claim_ref(
        m.fp, m.coords, m.moments, x, k, vs, rounds, maxp), sets)
    blocks, per_thread = insert_cuda.insert_claim_grid(sets[0][0].shape[0], dev)
    sync_ms = {s: device_ms(lambda b, s=s: insert_cuda.grid_sync_probe(b, s, dev),
                            [(blocks,)] * reps) for s in (0, 2 * rounds)}
    per_sync = (sync_ms[2 * rounds] - sync_ms[0]) / (2 * rounds)
    fp_np = m.fp.cpu().numpy()
    nbytes = [_insert_bytes(fp_np, cfg, xyz, mask, insert_cuda.insert_claim_cuda(
        m.fp, m.coords, m.moments, xyz, mask, vs, rounds, maxp)[2], rounds)
        for xyz, mask in sets]
    bound_ms = float(np.mean(nbytes)) / H100_BYTES_PER_S * 1e3
    print(f"  insert_claim 8192 points, 2^19-slot map, {rounds} rounds: kernel {ms:.4f} ms "
          f"(1 round {times[1]:.4f}, 4 rounds {times[4]:.4f}), whole call with its table "
          f"copies {call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({np.mean(nbytes):.0f} HBM bytes); grid {blocks} x 256 threads, {per_thread} "
          f"point(s) a thread: a grid barrier {per_sync * 1e3:.2f} us "
          f"({2 * rounds} barriers = {2 * rounds * per_sync / ms:.0%} of the kernel), "
          f"an empty cooperative launch {sync_ms[0]:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "library_note": "none: no PyTorch call probes and claims a hash table",
            "ms_by_rounds": times, "call_ms": call_ms, "grid_blocks": blocks,
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
        "nearest_neighbors, gather_rows, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "gather_rows", "merged_moments",
                                      "insert_claim")) > 0,
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
    50 m, written as KITTI .bin files under build/ (kept when complete).
    Builds the native reader first. Returns the root and the seconds it
    took."""
    import os

    from fastliosam_tpu_torch.io.native import native_available
    from fastliosam_tpu_torch.scripts import make_kitti_synth

    t0 = time.perf_counter()
    # 4 worker processes at nice 10, which they inherit from this thread:
    # they leave the card's feeder process and the machine's own services
    # their cores (6-7 generators busy from the start took an 8-core host
    # down twice)
    os.nice(10)
    native_available()
    root = ROOT / "build" / f"kitti_synth_{KITTI_SCANS}"
    done = root / "poses" / "00.txt"
    if not done.exists():
        make_kitti_synth.generate(str(root), "00", n_scans=KITTI_SCANS, progress=False,
                                  workers=4)
    return str(root), time.perf_counter() - t0


def make_longrun_engine(dev):
    """The bench's circuit long-run engine (``bench.py:
    _make_longrun_engine``): the loop-closing pipeline of ``make_engine``
    with FoV-sliding eviction (det_range 60 m every 50 scans), 1024
    keyframes / 2048 between / 64 GPS, LM 8 iterations, chain-aware GNC on
    loop factors, loops accepted below fitness 0.5 with information capped
    at 1 m."""
    from fastliosam_tpu_torch.loop import LoopConfig
    from fastliosam_tpu_torch.odom import OdomConfig
    from fastliosam_tpu_torch.pgo import PoseGraphConfig

    engine = make_engine(dev)
    engine.odom_cfg = OdomConfig(point_filter_num=1, blind=1.0, filter_size_surf=0.5,
                                 num_ds_points=8192, det_range=60.0, evict_every=50,
                                 query_mode="merged3")
    engine.pgo_cfg = PoseGraphConfig(max_keyframes=1024, max_between=2048, max_gps=64,
                                     lm_iters=8, loop_gnc_barc=2.0, gnc_hop_trans_var=0.1)
    engine.loop_cfg = LoopConfig(radius=10.0, time_gap=4.0, num_submap_keyframes=5,
                                 voxel_res=0.3, submap_points=16384, icp_score_threshold=0.5,
                                 max_sqrt_info=1.0)
    engine.reset()  # the stores and the graph at the new capacities
    return engine


def _finite(engine) -> bool:
    return bool(np.all(np.isfinite(np.stack(engine.realtime_traj)))
                and np.all(np.isfinite(engine.keyframe_poses())))


def loop_audit(engine, seq) -> list:
    """Each accepted loop against ground truth: the translation error of
    its measured relative pose (``t_err``), the true distance between the
    two keyframes and the error left after the solve."""
    gt = seq.gt_poses()
    times = np.asarray(seq.times, np.float64)
    idx = np.clip(np.searchsorted(times, engine.keyframe_stamps().astype(np.float64)), 0,
                  len(times) - 1)
    kf = engine.keyframe_poses()
    out = []
    for (q, c), rel, fit in zip(engine.loop_pairs, engine.loop_rels, engine.loop_fitness):
        true = np.linalg.inv(gt[idx[q]]) @ gt[idx[c]]
        solved = np.linalg.inv(kf[q]) @ kf[c]
        out.append({"pair": [q, c], "fitness": fit,
                    "t_err_m": float(np.linalg.norm(rel[:3, 3] - true[:3, 3])),
                    "true_dist_m": float(np.linalg.norm(true[:3, 3])),
                    "solved_err_m": float(np.linalg.norm(solved[:3, 3] - true[:3, 3]))})
    return out


def kitti_longrun_phase(dev, root: str, chunk: int = 5):
    """``drive_kitti`` over the whole sequence at the bench's width and
    depth (``bench.py: bench_kitti_longrun``), q16 upload: the bench's
    configuration, then the same run loop-free (the odometry alone, the
    radius of loop candidates set to 0), then the bench's configuration
    with the raw float upload (``upload="f32"``: inputs that differ from
    q16's by at most 1/512 m, which shows how far the accepted loops move
    the result). Gates: every pose finite, the loop-free realtime ATE <=
    10 m (JAX on a TPU: 3.56 m) and the bench configuration's <= 20 m
    (its loop trust is chaotic on this feed: the JAX engine gives 3.35 m
    on a TPU and 7.41 m on the CPU, and 31 m with the spec's 35 m radius;
    PERF.md), every kernel of the path launched."""
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.io.native import native_available
    from fastliosam_tpu_torch.runtime.drivers import drive_kitti
    from fastliosam_tpu_torch.utils import host_reads, reset_host_reads

    if not native_available():
        raise AssertionError("KITTI phase: the native reader did not build (g++)")
    engine = make_longrun_engine(dev)
    reset_host_reads()
    out, launches = _launch_counts(lambda: drive_kitti(
        engine, root, "00", scan_capacity=32768, chunk=chunk, progress=False))
    n = out["n_scans"]
    result = dict(out, chunk=chunk, upload="q16", scan_capacity=32768,
                  verifications=len(engine.loop_attempts),
                  loop_audit=loop_audit(engine, KittiSequence(root, "00")),
                  host_syncs_per_chunk=host_reads() / -(-n // chunk), launches=launches,
                  launches_per_scan={k: v / n for k, v in launches.items()})
    loop_free = make_longrun_engine(dev)
    loop_free.loop_cfg = loop_free.loop_cfg._replace(radius=0.0)
    result["loop_free"] = drive_kitti(loop_free, root, "00", scan_capacity=32768, chunk=chunk,
                                      progress=False)
    f32 = make_longrun_engine(dev)
    result["f32_upload"] = dict(
        drive_kitti(f32, root, "00", scan_capacity=32768, chunk=chunk, upload="f32",
                    progress=False),
        verifications=len(f32.loop_attempts))
    print("  " + json.dumps(result))
    lf, fl = result["loop_free"], result["f32_upload"]
    slid = [a for a in result["loop_audit"] if a["t_err_m"] > 5.0]
    print(f"  long-run: {out['scans_per_sec']} scans/s, ATE {out.get('ate_m')} m, keyframe ATE "
          f"{out.get('kf_ate_m')} m, RPE(1 s) {out.get('rpe_1s_m')} m, {out['n_loops']} loops "
          f"({len(slid)} off by more than 5 m against ground truth), {out['n_keyframes']} "
          f"keyframes, {out['n_solves']} solves; loop-free {lf['scans_per_sec']} scans/s, ATE "
          f"{lf.get('ate_m')} m, keyframe ATE {lf.get('kf_ate_m')} m; f32 upload ATE "
          f"{fl.get('ate_m')} m, {fl['n_loops']} loops of {fl['verifications']} verifications "
          f"(accuracy reference, JAX engine on a TPU: ATE 3.3519 m, keyframe ATE 3.2462 m, "
          f"2 loops, 574 keyframes; loop-free 3.56 m)")
    _fail("KITTI long-run", {
        "every pose finite": _finite(engine) and _finite(loop_free) and _finite(f32),
        "ground truth read": "ate_m" in out and "ate_m" in lf,
        "loop-free ATE <= 10 m": lf.get("ate_m", np.inf) <= 10.0,
        "ATE <= 20 m": out.get("ate_m", np.inf) <= 20.0,
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

    seq = KittiSequence(root, "00")
    dt = float(np.median(np.diff(np.asarray(seq.times, np.float64))))
    t0 = time.perf_counter()

    def run():
        first = make_longrun_engine(dev)
        _drive_span(first, kitti_stager(first, seq, 32768, chunk), 0, split, chunk, dt)
        save_checkpoint(first, str(ckpt))
        _drive_span(first, kitti_stager(first, seq, 32768, chunk), split, end, chunk, dt)
        restored = load_checkpoint(make_longrun_engine(dev), str(ckpt))
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
        kernels["gather_rows"], gather_cases = check_gather(dev, args.seed, fig8_map[3])
        kernels["merged_moments"] = check_assoc(dev, fig8, fig8_map)
        kernels["insert_claim"] = check_insert(dev, fig8, fig8_map)
        del fig8_map
        print("per-scan phase (SlamEngine.process):")
        per_scan = per_scan_phase(dev, fig8)
        print(f"chunked phase (SlamEngine.process_chunk_deferred, chunk {args.chunk}):")
        chunked = chunked_phase(dev, fig8, args.chunk)
        print(f"GPS phase (corridor, SlamEngine.process_chunk, chunk {args.chunk}):")
        gps = gps_phase(dev, corridor, args.chunk)
        t0 = time.perf_counter()
        kitti_root, kitti_s = kitti_job.result()
        kitti_pool.shutdown()
        print(f"KITTI phase ({KITTI_SCANS} scans generated in {kitti_s:.1f} s, "
              f"{time.perf_counter() - t0:.1f} s more to wait for):")
        kitti = kitti_phase(dev, kitti_root, args.chunk)
        kitti["feed_s"] = kitti_s
        if args.profile_scans > 0:
            print(f"profile (SlamEngine.process, last {args.profile_scans} scans):")
            per_scan["profile"] = profile_phase(dev, fig8, args.profile_scans)

    paths = {"per_scan": per_scan["launches"], "chunked": chunked["launches"],
             "gps": gps["launches"], "exp_gather": exp_launches,
             "kitti_longrun": kitti["longrun"]["launches"],
             "kitti_resume": kitti["resume"]["launches"],
             "kitti_localize": kitti["localize"]["launches"]}
    shapes = kitti["kernel_shapes"]
    at_localizer = {"nearest_neighbors": shapes["nearest_neighbors"],
                    "insert_claim": shapes["insert_claim"],
                    "gather_rows": {k: shapes[f"gather_rows_{k}"] for k in ("moments", "coords")}}
    line = {"kernels": []}
    for mod in KERNEL_MODULES:
        rec = dict(mod.KERNEL)
        name = rec["name"]
        rec["launches"] = sum(p[name] for p in paths.values())
        rec["launches_by_path"] = {k: p[name] for k, p in paths.items()}
        rec.update(kernels[name])
        if name in at_localizer:
            rec["at_localizer_shape"] = at_localizer[name]
        line["kernels"].append(rec)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card_line(), "kernels": line["kernels"], "gather_cases": gather_cases,
             "exp_gather": exp_recs, "per_scan": per_scan, "chunked": chunked, "gps": gps,
             "kitti": kitti,
             "total_s": time.perf_counter() - t_start},
            indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
