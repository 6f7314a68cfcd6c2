"""Dense against PCG for the pose-graph solve (port of
``scripts/bench_pgo_crossover.py``): sweep keyframe counts, time the LM
solve with each linear stage, and report where the dense Cholesky stops
beating matrix-free PCG, the data behind
``PoseGraphConfig.linear_solver="auto"`` (PCG in both packages).

    python -m fastliosam_tpu_torch.scripts.bench_pgo_crossover [--sizes 512 1024 2048 4096]
        [--pcg-iters 96] [--lm-iters 6] [--reps 3] [--device cpu] [--out FILE]

For each K and each of ``dense`` / ``pcg`` on the graph of
``bench_scaling.build_graph``: one warm solve, then ``--reps`` solves on
the host clock, each ending in ``torch.cuda.synchronize()``
(``{mode}_ms``, their mean, and ``{mode}_ms_each``). Beside the JAX
script's keys (``{mode}_ms``, ``{mode}_cost``, ``dense_over_pcg``) it
reports the starting cost, the relative gap of the two final costs, and on
the card the device operations of one solve (``torch.profiler``: a PCG
solve is thousands of small launches) with their summed device time, the
peak device memory of a solve (``torch.cuda.max_memory_allocated``) and the
card's name and power limit. Only ``torch.cuda.OutOfMemoryError`` is
caught and recorded (``{mode}_error``), as the JAX script records an OOM;
any other error fails the script. Prints one JSON line a size, then the
whole record. On the CPU (``--device cpu``) nothing device-side is
measured (those keys are null).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..pgo import PoseGraphConfig, graph_cost, solve
from ..utils.device import resolve_device
from ..utils.timing import card_line, device_activity
from .bench_scaling import build_graph

MODES = ("dense", "pcg")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_solve(g, cfg, dev, reps: int) -> dict:
    """One warm solve, ``reps`` timed ones (the peak device memory read
    over them) and on the card one traced. Returns the cost and the
    readings."""
    cuda = dev.type == "cuda"
    _, cost = solve(g, cfg, device=dev)  # warm: allocator, cuSOLVER / cuBLAS handles
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    each = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, cost = solve(g, cfg, device=dev)
        _sync(dev)
        each.append((time.perf_counter() - t0) * 1e3)
    rec = {"ms": sum(each) / len(each), "ms_each": each, "cost": float(cost),
           "device_ops": None, "device_busy_ms": None, "peak_gib": None}
    if cuda:
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        _, act = device_activity(lambda: solve(g, cfg, device=dev))
        rec.update(act)
    return rec


def sweep(sizes, dev, lm_iters: int = 6, pcg_iters: int = 96, reps: int = 3,
          print_fn=print) -> list:
    """One row a keyframe count (see the module docstring)."""
    rows = []
    for K in sizes:
        row = {"keyframes": K}
        for mode in MODES:
            cfg = PoseGraphConfig(max_keyframes=K, max_between=2 * K, max_gps=8,
                                  lm_iters=lm_iters, pcg_iters=pcg_iters, linear_solver=mode)
            g = build_graph(cfg, K, device=dev)
            row.setdefault("start_cost", float(graph_cost(g, cfg, g.poses[0])))
            try:
                rec = time_solve(g, cfg, dev, reps)
            except torch.cuda.OutOfMemoryError as e:  # dense at large K on a small card
                row[f"{mode}_ms"] = None
                row[f"{mode}_error"] = str(e)[:120]
                del g
                torch.cuda.empty_cache()
                continue
            row.update({f"{mode}_{k}": v for k, v in rec.items()})
        if row.get("dense_ms") and row.get("pcg_ms"):
            row["dense_over_pcg"] = row["dense_ms"] / row["pcg_ms"]
            row["cost_gap_rel"] = ((row["pcg_cost"] - row["dense_cost"])
                                   / max(abs(row["dense_cost"]), 1e-30))
        print_fn(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[512, 1024, 2048, 4096])
    ap.add_argument("--pcg-iters", type=int, default=96)
    ap.add_argument("--lm-iters", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else None
    if card:
        print(card)
    rows = sweep(args.sizes, dev, args.lm_iters, args.pcg_iters, args.reps,
                 print_fn=lambda line: print(line, file=sys.stderr))
    record = {"metric": "pgo_dense_vs_pcg_crossover", "device": dev.type, "card": card,
              "lm_iters": args.lm_iters, "pcg_iters": args.pcg_iters, "reps": args.reps,
              "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
