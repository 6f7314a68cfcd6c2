"""The k-NN kernel's two routes (``csrc/knn.cu``, ``ops/kneighbors_cuda.py``)
on hazard inputs, their crossover, and the grid's target occupancy.

    python -m fastliosam_tpu_torch.scripts.exp_knn [--device cuda] [--out FILE] [--library-map PCD]

1. Hazards (:func:`hazard_sets`): points on cell faces and a hair off them,
   exact ties across cells, far outliers, one dense cell of duplicates, the
   2D ICP's z = 0 plane, queries that are not the destinations (some far
   from them), k = M - 1, georeferenced coordinates, k above 32. Each set
   goes through both routes (brute force and the grid search, whatever its
   size), each held against the plain version bit for bit (d2 as int64
   bits, and indices).
2. Crossover: N = M destinations of a LiDAR-like street
   (:func:`surface_cloud`) from 256 to 131,072, at k = 20 with self
   excluded (the SOR's use) and at k = 1 on the z = 0 plane against a
   shifted copy (the ICP's use), both routes timed as chip_smoke.py times
   kernels (``utils/timing.py: device_ms``). Prints the least M from which
   the grid route is faster at every larger M measured: the dispatch's
   ``GRID_MIN_DST``.
3. Occupancy and probe budget: the grid route at 65,536 and 348,097 street
   points (k = 20) and at 65,536 plane points (k = 1) for each occupancy
   target (``cell_grid.OCCUPANCY`` is the default), then at 348,097 street
   points for each probe budget (``kneighbors_cuda.PROBE_BUDGET`` is the
   default), with its pair tests and cell probes a query and the queries
   rescued.
4. Profile: the grid route at 65,536 and 348,097 street points (k = 20)
   under ``torch.profiler``, device time by kernel (the index build, the
   sort, the search, the rescue pass).

On the CPU (``--device cpu``) only the hazards run, through the plain
version; nothing is timed. Prints one JSON line a record.

With ``--library-map PCD`` (card only) the script does nothing else: it
times ``knn``'s one-call PyTorch yardstick, ``cdist`` + ``topk`` (k = 20,
self excluded: the SOR's call), over every query row of that map against
all of its points, in row blocks of 512 MiB of distances
(:func:`run_library_map`).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import cell_grid, kneighbors_cuda
from ..utils.device import resolve_device
from ..utils.timing import card_line, device_ms

CROSSOVER_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)
OCCUPANCY_TARGETS = (0.25, 0.5, 1.0, 2.0, 4.0)
PROBE_BUDGETS = (27, 125, 343, 1000, 4096)


def surface_cloud(n: int, seed: int = 0) -> np.ndarray:
    """``(n, 3)`` float64 points of a LiDAR-like street: ground, two
    facades and poles, denser near the sensor's path (x = 0), 2 cm noise,
    1% scattered outliers and 0.1% far ones."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(4, size=n, p=[0.55, 0.3, 0.139, 0.011])
    r = np.abs(rng.standard_cauchy(n)) * 4 + 0.5  # range from the path
    side = rng.choice([-1.0, 1.0], n)
    along = rng.uniform(-60, 60, n)
    pts = np.empty((n, 3))
    g = kind == 0  # ground
    pts[g] = np.column_stack([np.clip(side[g] * r[g], -11.9, 11.9), along[g], np.zeros(g.sum())])
    w = kind == 1  # facades at x = +-12
    pts[w] = np.column_stack([side[w] * 12.0, along[w], np.clip(r[w] * 0.5, 0, 9)])
    p = kind == 2  # poles every 10 m
    pole = np.round(along[p] / 10) * 10
    ang = rng.uniform(0, 2 * np.pi, p.sum())
    pts[p] = np.column_stack([side[p] * 8 + 0.1 * np.cos(ang), pole + 0.1 * np.sin(ang),
                              rng.uniform(0, 6, p.sum())])
    o = kind == 3  # outliers, a tenth of them far away
    far = rng.uniform(size=o.sum()) < 0.1
    pts[o] = rng.uniform([-15, -65, -2], [15, 65, 12], (o.sum(), 3))
    pts[np.flatnonzero(o)[far]] += rng.choice([-1.0, 1.0], (far.sum(), 3)) * 80.0
    return pts + rng.normal(size=(n, 3)) * 0.02


def plane_cloud(n: int, seed: int = 0) -> np.ndarray:
    """``(n, 3)`` points of a 2D trajectory-like curve on z = 0."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40 * np.pi, n))
    xy = np.column_stack([30 * np.sin(t / 7), 15 * np.sin(2 * t / 7)]) + rng.normal(size=(n, 2))
    return np.column_stack([xy, np.zeros(n)])


def hazard_sets(seed: int = 0, scale: float = 1.0):
    """``[(name, src, dst, k, exclude_self)]`` of float64 arrays (``src is
    dst`` where self is excluded); ``scale`` shrinks the point counts."""
    rng = np.random.default_rng(seed)

    def count(n):
        return max(40, int(n * scale))

    sets = []
    # lattices a power of two apart, shuffled, in a box whose corners make
    # the fine cell edge h = 2^-18: every lattice plane then lies on a cell
    # face (or every other one) at the levels their occupancy picks, and
    # equal distances cross the faces; copies one ulp off the faces; the
    # corners are far outliers
    side = ((1 << cell_grid.FINE_BITS) - 4) * 2.0**-18
    corners = np.array([[0.0, 0.0, 0.0], [side, side, side]])

    def lattice(n, spacing):
        pts = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
        return rng.permutation(pts * spacing + 0.5)

    lat = lattice(max(6, round(10 * scale ** (1 / 3))), 2.0**-6)
    off = rng.choice([-np.inf, np.inf], (len(lat) // 4, 3))
    faces = np.vstack([corners, lat, np.nextafter(lat[: len(off)], off)])
    sets.append(("faces", faces, faces, 20, True))
    grid = np.vstack([corners, lattice(12, 2.0**-4)])
    # k = 28 picks cells 4 spacings wide: from a query 2 spacings inside a
    # cell, the face lies 2 away, and the 28th neighbour is one of the six
    # at exactly that distance, three of them beyond the faces (on them)
    sets.append(("ties_across_cells", grid, grid, 28, True))
    sets.append(("ties_across_cells_k5", grid, grid, 5, True))
    # a dense blob and far outliers
    blob = np.vstack([rng.normal(size=(count(4000), 3)) * 0.3,
                      rng.uniform(-100, 100, size=(20, 3))])
    sets.append(("outliers", blob, blob, 20, True))
    # one dense cell: exact duplicates and a cloud of 1e-9 m
    dup = np.vstack([np.tile([[1.5, -2.25, 0.75]], (count(2500), 1)),
                     [1.5, -2.25, 0.75] + rng.normal(size=(count(500), 3)) * 1e-9])
    sets.append(("one_cell", dup, dup, 32, True))
    # the 2D ICP: queries a rotated, shifted copy on z = 0
    plane = plane_cloud(count(8192), seed)
    c, s = np.cos(0.05), np.sin(0.05)
    moved = plane @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]).T + [1.2, -1.6, 0.0]
    sets.append(("plane_z0", np.ascontiguousarray(moved[: count(4000)]), plane, 1, False))
    sets.append(("plane_z0_k4", np.ascontiguousarray(moved[: count(4000)]), plane, 4, False))
    # queries that are not the destinations, some a kilometre away
    street = surface_cloud(count(6000), seed)
    queries = np.vstack([street[: count(800)] + rng.normal(size=(count(800), 3)) * 0.3,
                         rng.uniform(-1000, 1000, size=(40, 3))])
    sets.append(("src_not_dst", queries, street, 8, False))
    # every other point
    few = surface_cloud(600, seed + 1)
    sets.append(("k_m_minus_1", few, few, len(few) - 1, True))
    # georeferenced coordinates (UTM-sized)
    geo = street + [512345.25, 4180123.5, 31.0]
    sets.append(("georeferenced", geo, geo, 20, True))
    # k above 32 (the row list) on the street
    big = surface_cloud(count(20000), seed + 2)
    for k in (33, 50, 100):
        sets.append((f"street_k{k}", big, big, k, True))
    return sets


def _bits_equal(a, b) -> bool:
    return bool(torch.equal(a[0].view(torch.int64), b[0].view(torch.int64))
                and torch.equal(a[1], b[1]))


def grid_stats(n: int, m: int, stats, index) -> dict:
    """A grid call's counters (``kneighbors_cuda._knn_grid``'s ``stats`` and
    ``index``): the queries rescued, pair tests (the rescue pass's M a query
    included) and cell probes a query, the level and its cells."""
    rescued, pairs, probes = stats.tolist()
    return {"rescued": rescued, "pairs_per_query": (pairs + rescued * m) / n,
            "probes_per_query": probes / n, "level": int(index.iparams[6]),
            "cells": int(index.n_cells), "h": float(index.fparams[0])}


def run_hazards(dev, sets=None, print_fn=print) -> list[dict]:
    """Every hazard set through both routes against the plain version."""
    out = []
    for name, src_np, dst_np, k, excl in sets if sets is not None else hazard_sets():
        dst = torch.from_numpy(np.ascontiguousarray(dst_np)).to(dev)
        src = dst if src_np is dst_np else torch.from_numpy(np.ascontiguousarray(src_np)).to(dev)
        want = kneighbors_cuda.knn_ref(src, dst, k, excl)
        rec = {"hazard": name, "n": src.shape[0], "m": dst.shape[0], "k": k,
               "exclude_self": excl}
        if dev.type == "cuda":
            rec["brute_equal"] = _bits_equal(kneighbors_cuda._knn_brute(src, dst, k, excl), want)
            d2, idx, stats, index = kneighbors_cuda._knn_grid(src, dst, k, excl)
            rec["grid_equal"] = _bits_equal((d2, idx), want)
            rec.update(grid_stats(src.shape[0], dst.shape[0], stats, index))
            rec["dispatch_equal"] = _bits_equal(kneighbors_cuda.knn(src, dst, k, excl), want)
        print_fn(json.dumps(rec))
        out.append(rec)
    return out


def _time_routes(src, dst, k, excl, reps: int) -> dict:
    brute = device_ms(lambda: kneighbors_cuda._knn_brute(src, dst, k, excl), [()] * reps)
    grid = device_ms(lambda: kneighbors_cuda._knn_grid(src, dst, k, excl), [()] * reps)
    _, _, stats, index = kneighbors_cuda._knn_grid(src, dst, k, excl)
    return {"brute_ms": brute, "grid_ms": grid,
            **grid_stats(src.shape[0], dst.shape[0], stats, index)}


def run_crossover(dev, reps: int, print_fn=print) -> int:
    """Both routes at each size; returns the least size from which the grid
    route wins at every larger size of both uses."""
    wins = {}
    for m in CROSSOVER_SIZES:
        street = torch.from_numpy(surface_cloud(m, 3)).to(dev)
        plane = plane_cloud(m, 4)
        c, s = np.cos(0.05), np.sin(0.05)
        moved = plane @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]).T + [1.2, -1.6, 0.0]
        cases = {"sor_k20": (street, street, 20, True),
                 "icp_k1": (torch.from_numpy(moved).to(dev), torch.from_numpy(plane).to(dev),
                            1, False)}
        for use, (src, dst, k, excl) in cases.items():
            if not _bits_equal(kneighbors_cuda._knn_brute(src, dst, k, excl),
                               kneighbors_cuda._knn_grid(src, dst, k, excl)[:2]):
                raise AssertionError(f"routes differ at {use}, m = {m}")
            rec = {"crossover": use, "m": m, "k": k, **_time_routes(src, dst, k, excl, reps)}
            wins.setdefault(m, []).append(rec["grid_ms"] < rec["brute_ms"])
            print_fn(json.dumps(rec))
    cross = None
    for m in reversed(CROSSOVER_SIZES):
        if not all(wins[m]):
            break
        cross = m
    print_fn(json.dumps({"crossover_min_dst": cross}))
    return cross


def run_occupancy(dev, reps: int, print_fn=print) -> list[dict]:
    """The grid route at each occupancy target, then at each probe budget."""
    out = []

    def one(pts, k, use, **knobs):
        def call():
            return kneighbors_cuda._knn_grid(pts, pts, k, True, **knobs)

        ms = device_ms(call, [()] * reps)
        rec = {"use": use, **knobs, "m": pts.shape[0], "k": k, "grid_ms": ms,
               **grid_stats(len(pts), len(pts), *call()[2:])}
        print_fn(json.dumps(rec))
        out.append(rec)

    for m, use in ((65536, "sor_k20"), (348097, "sor_k20"), (65536, "plane_k1")):
        pts = torch.from_numpy(surface_cloud(m, 5) if use == "sor_k20"
                               else plane_cloud(m, 6)).to(dev)
        for target in OCCUPANCY_TARGETS:
            one(pts, 20 if use == "sor_k20" else 1, use, occupancy=target)
    street = torch.from_numpy(surface_cloud(348097, 5)).to(dev)
    for budget in PROBE_BUDGETS:
        one(street, 20, "sor_k20", probe_budget=budget)
    return out


def run_profile(dev, reps: int = 3, top: int = 12, print_fn=print) -> list[dict]:
    """Device time a call by kernel name, over ``reps`` grid-route calls."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    for m in (65536, 348097):
        pts = torch.from_numpy(surface_cloud(m, 5)).to(dev)
        _, _, stats, index = kneighbors_cuda._knn_grid(pts, pts, 20, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kneighbors_cuda._knn_grid(pts, pts, 20, True)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                rows.append((us / reps / 1e3, e.key[:60], e.count // reps))
        rows.sort(reverse=True)
        rec = {"profile_m": m, "k": 20, "device_ms_total": sum(r[0] for r in rows),
               "by_kernel": [{"ms": ms, "name": name, "calls": c} for ms, name, c in rows[:top]],
               **grid_stats(m, m, stats, index)}
        print_fn(json.dumps(rec))
        out.append(rec)
    return out


def library_block_rows(m: int) -> int:
    """Query rows a ``cdist`` block of :func:`library_knn` holds: 2^26
    distances (512 MiB of float64) against ``m`` destinations."""
    return max(1, (1 << 26) // m)


def library_knn(src, dst, k: int, exclude_self: bool):
    """The one-call PyTorch yardstick of ``knn`` (the port never calls it):
    ``cdist`` (no matrix-product expansion) and ``topk`` over blocks of
    :func:`library_block_rows` query rows. Returns the last block's
    ``(d2, idx)``."""
    rows = library_block_rows(dst.shape[0])
    out = None
    for s in range(0, src.shape[0], rows):
        e = min(s + rows, src.shape[0])
        d = torch.cdist(src[s:e], dst, compute_mode="donot_use_mm_for_euclid_dist")
        if exclude_self:
            r = torch.arange(s, e, device=src.device)
            d[r - s, r] = float("inf")
        out = torch.topk(d, k, dim=1, largest=False)
    return out


def run_library_map(dev, pcd: str, k: int = 20, print_fn=print) -> dict:
    """The yardstick over every query row of a whole map (the SOR's call:
    all points against all, self excluded): one block to warm it, then one
    timed pass between two CUDA events."""
    from ..io.pcd import read_pcd, xyz_of

    xyz = torch.from_numpy(np.ascontiguousarray(xyz_of(read_pcd(pcd)), np.float64)).to(dev)
    m = xyz.shape[0]
    rows = library_block_rows(m)
    library_knn(xyz[:rows], xyz, k, True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    library_knn(xyz, xyz, k, True)
    end.record()
    torch.cuda.synchronize()
    rec = {"library_map": pcd, "shape": [m, m, k], "exclude_self": True,
           "block_rows": rows, "blocks": -(-m // rows), "library_ms": start.elapsed_time(end)}
    print_fn(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="also write every record as JSON here")
    ap.add_argument("--library-map", metavar="PCD",
                    help="only time cdist + topk (k = 20, self excluded) over every row of "
                         "this map (card only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    records = {}
    if dev.type == "cuda":  # the card's name and power limit
        records["card"] = card_line()
        print(records["card"])
    if args.library_map:
        if dev.type != "cuda":
            ap.error("--library-map times the card: it needs CUDA")
        records["library_map"] = run_library_map(dev, args.library_map)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
        return 0
    records["hazards"] = run_hazards(dev)
    if dev.type == "cuda":
        records["crossover"] = run_crossover(dev, args.reps)
        records["occupancy"] = run_occupancy(dev, args.reps)
        records["profile"] = run_profile(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    bad = [r["hazard"] for r in records["hazards"]
           if not all(r.get(key, True) for key in ("brute_equal", "grid_equal", "dispatch_equal"))]
    if bad:
        print(f"routes differ from the plain version on: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
