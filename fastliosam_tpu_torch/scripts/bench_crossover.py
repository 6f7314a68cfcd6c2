"""Per-stage sharded-against-single crossover table (port of
``scripts/bench_crossover.py``).

For four sharded stages (the loop-candidate search, the submap gather, the
pose-graph PCG solve, the slot-sharded voxel-map query; the JAX docstring
also names the point-sharded ICP, which its code does not sweep) sweep the
problem size K and the rank count, and record where the sharded program
comes within 1.2x of its single twin. Ranks are processes of
``torch.distributed`` (``scripts/_ranks.py``), one world of ``max(--devices)``
ranks, each count the subgroup of its first n ranks; the single twin runs on
rank 0 with no mesh, on its own device, while the other ranks wait at a
barrier.

    python -m fastliosam_tpu_torch.scripts.bench_crossover [--sizes 1024 4096 16384]
        [--devices 1 2 8] [--cpu N] [--out FILE]

The port runs on the card(s) by default, rank r on ``cuda:{r % cards}``
(NCCL with a card a rank, gloo when ranks share one); ``--cpu N`` runs N
gloo ranks on the CPU. The JAX script defaults to ``--cpu 8`` (8 virtual
CPU devices), but a port entry point runs on the card unless asked for the
CPU. A count above ``--cpu N`` is skipped, as the JAX script skips a count
above its devices.

Each stage's inputs are the JAX script's draws from one
``default_rng(0)``, in its order: a fresh draw for the single twin and for
each rank count. Every rank makes every draw, those of runs it takes no part
in included, so the inputs stay JAX's bit for bit. ``timeit`` is JAX's: one
warm call, then ``reps`` calls and one device sync after the loop, on rank
0's host clock (a sharded run from a barrier of its mesh). The JSON keeps
JAX's keys (``host_cores``, ``backend``, ``stages``; a row ``K``,
``single_ms``, ``sharded_ms``, ``collective_bytes`` (JAX's formulas of
the payload a call, kept as they are), ``within_1p2x``) and adds the card,
the rank layout, rank 0's seconds in the sweeps (``rank_s``, by stage
``stage_s``), and a row's kernel launches (``single_launches``: rank 0's
over the twin's warm and timed calls, its map insert included;
``sharded_launches``: each rank's) and rank 0's collectives a sharded call.

When ranks share a device every gloo collective goes through host memory
(~4 ms on one card whatever its size), so the sharded-to-single ratio
measures the overhead of the sharding machinery, not what crosses a link
between cards.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import _ranks

P = 1024  # submap gather: points a keyframe cloud
N_SUB = 5
N_Q = 8192  # voxel query: points
STAGES = ("loop_detect", "submap_gather", "pgo_solve", "voxel_query")


def draw(stage: str, rng, K: int):
    """One run's inputs of ``stage`` at size ``K`` from the shared
    generator, as the JAX script draws them (the PGO stage draws nothing
    from it: ``build_graph`` has its own)."""
    if stage == "loop_detect":  # keyframe positions
        return rng.uniform(-500, 500, (K, 3)).astype(np.float32)
    if stage == "submap_gather":  # keyframe clouds
        return rng.normal(size=(K, P, 3)).astype(np.float32)
    if stage == "voxel_query":  # a ground patch: inserted, then queried
        return np.stack([rng.uniform(-40, 40, N_Q), rng.uniform(-40, 40, N_Q),
                         0.05 * rng.standard_normal(N_Q)], 1).astype(np.float32)
    return None


def timeit(f, dev, reps=10, group=None):
    """Milliseconds a call: a warm call, then ``reps`` calls and one sync
    (from a barrier of ``group`` when given)."""
    f()
    _ranks.sync(dev)
    if group is not None:
        torch.distributed.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    _ranks.sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _single(rank: int, dev, f, reps: int):
    """Rank 0 times the single twin's call ``f()`` (the set-up already
    done); the other ranks wait at a barrier. Rank 0's record, or None."""
    rec = None
    if rank == 0:
        before = _ranks.launches()
        ms = timeit(f(), dev, reps)
        rec = {"ms": ms, "launches": _ranks.launches_since(before)}
    torch.distributed.barrier()
    return rec


def _sharded(mesh, dev, f, reps: int):
    """The mesh's ranks time the sharded call ``f(mesh)()``; the ranks
    outside it wait at a barrier of the world."""
    rec = None
    if mesh is not None:
        before = _ranks.launches()
        call = f(mesh)
        mesh.reset_counts()  # the calls' collectives, not the set-up's
        ms = timeit(call, dev, reps, mesh.group)
        rec = {"ms": ms, "launches": _ranks.launches_since(before),
               "collectives_per_call": mesh.collectives / (reps + 1)}
    torch.distributed.barrier()
    return rec


def rank_stages(args) -> dict:
    """One rank's part of the whole table: ``{stage: [{K, single,
    sharded: {n: record}}]}`` (the records this rank timed)."""
    from ..loop.closure import LoopConfig, build_submap
    from ..loop.detect import fetch_closest_keyframe_idx
    from ..map import VoxelMapConfig, insert, make_map
    from ..map.voxel_hash import query_planes_merged3
    from ..parallel import (detect_sharded, gather_submap_sharded, insert_sharded,
                            make_map_sharded, query_planes_merged3_sharded, solve_sharded)
    from ..parallel.distributed import rank_device
    from ..parallel.mesh import shard_leading
    from ..pgo import PoseGraphConfig, solve
    from .bench_scaling import build_graph

    t_rank = time.perf_counter()
    dev = rank_device()
    rank = torch.distributed.get_rank()
    counts = [n for n in args.devices if n <= args.n_all]
    by_n = _ranks.meshes(counts)
    rng = np.random.default_rng(0)

    def up(a):
        return torch.from_numpy(a).to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bool, device=dev)

    # each stage: (single twin, sharded program), each from (K, inputs) to
    # the set-up that returns the call timed
    def det_single(K, p):
        pos, stv = up(p), up((np.arange(K) * 0.5).astype(np.float32))
        return lambda: fetch_closest_keyframe_idx(pos, stv, ones(K), K - 1, 35.0, 30.0)

    def det_sharded(K, p, mesh):
        pos, stv = up(p), up((np.arange(K) * 0.5).astype(np.float32))
        # engine fast path: the query row passed replicated (no broadcast psum)
        qrow = torch.cat([pos[K - 1], stv[K - 1:K]])
        pl, sl, vl = (shard_leading(mesh, t) for t in (pos, stv, ones(K)))
        return lambda: detect_sharded(pl, sl, vl, K - 1, 35.0, 30.0, mesh, query_row=qrow)

    def sub_single(K, c):
        cfg = LoopConfig(num_submap_keyframes=N_SUB, submap_points=4096)
        clouds = up(c)
        poses = torch.eye(4, dtype=torch.float32, device=dev).expand(K, 4, 4)
        return lambda: build_submap(clouds, ones(K, P), poses, ones(K), K // 2, cfg)

    def sub_sharded(K, c, mesh):
        clouds, masks = shard_leading(mesh, up(c)), shard_leading(mesh, ones(K, P))
        return lambda: gather_submap_sharded(clouds, masks, K // 2, N_SUB, mesh)

    def pgo_graph(K):
        cfg = PoseGraphConfig(max_keyframes=K, max_between=2 * K, max_gps=8, lm_iters=4,
                              pcg_iters=64)
        return build_graph(cfg, K, device=dev), cfg

    def pgo_single(K, _):
        g, cfg = pgo_graph(K)
        return lambda: solve(g, cfg, device=dev)

    def pgo_sharded(K, _, mesh):
        g, cfg = pgo_graph(K)
        return lambda: solve_sharded(g, cfg, mesh)

    def vm_cfg(K):
        return VoxelMapConfig(capacity=1 << max(14, int(np.log2(K)) + 5), voxel_size=0.5,
                              min_points=5)

    def vmq_single(K, p):
        cfg, pts, msk = vm_cfg(K), up(p), ones(N_Q)
        m, _ = insert(make_map(cfg, device=dev), cfg, pts, msk, refresh_planes=False)
        return lambda: query_planes_merged3(m, cfg, pts, msk)

    def vmq_sharded(K, p, mesh):
        cfg, pts, msk = vm_cfg(K), up(p), ones(N_Q)
        m, _ = insert_sharded(make_map_sharded(cfg, mesh), cfg, pts, msk, mesh)
        return lambda: query_planes_merged3_sharded(m, cfg, pts, msk, mesh)

    programs = {"loop_detect": (det_single, det_sharded),
                "submap_gather": (sub_single, sub_sharded),
                "pgo_solve": (pgo_single, pgo_sharded),
                "voxel_query": (vmq_single, vmq_sharded)}
    out = {"rank": rank, "dist_backend": torch.distributed.get_backend(), "stages": {},
           "stage_s": {}}
    for stage in STAGES:
        t_stage = time.perf_counter()
        single, sharded = programs[stage]
        reps = 3 if stage == "pgo_solve" else 10
        rows = out["stages"][stage] = []
        for K in args.sizes:
            inp = draw(stage, rng, K)  # every rank draws, in the JAX script's order
            row = {"K": K, "single": _single(rank, dev, lambda: single(K, inp), reps),
                   "sharded": {}}
            for n in counts:
                inp = draw(stage, rng, K)
                row["sharded"][str(n)] = _sharded(
                    by_n[n], dev, lambda mesh: sharded(K, inp, mesh), reps)
            rows.append(row)
        out["stage_s"][stage] = time.perf_counter() - t_stage
    out["rank_s"] = time.perf_counter() - t_rank
    return out


# JAX's analytic collective payload a call, bytes
PAYLOAD = {
    "loop_detect": lambda K, devices: 4 * 4 + 2 * 4 * max(devices),  # qrow psum + packed gather
    "submap_gather": lambda K, devices: (2 * N_SUB + 1) * P * 3 * 4 + (2 * N_SUB + 1) * P * 4,
    "pgo_solve": lambda K, devices: 4 * 64 * (K * 6 * 4 + 8),  # per LM: pcg_iters psums of (K,6)
    "voxel_query": lambda K, devices: 3 * (N_Q * 4 + N_Q * 10 * 4),  # pmin + psum per stencil
}


def assemble(args, ranks: list, lay: dict, card) -> dict:
    """The JSON record from every rank's :func:`rank_stages`."""
    results = {"host_cores": os.cpu_count(), "backend": "cpu" if args.cpu else "cuda",
               "card": card, "dist_backend": ranks[0]["dist_backend"], **lay,
               "rank_s": ranks[0]["rank_s"], "stage_s": ranks[0]["stage_s"],
               "ranks_s": dict(_ranks.LAST_RUN_S), "stages": {}}
    for stage, rows0 in ranks[0]["stages"].items():
        rows = []
        for i, r0 in enumerate(rows0):
            K = r0["K"]
            row = {"K": K, "single_ms": round(r0["single"]["ms"], 3), "sharded_ms": {},
                   "single_launches": r0["single"]["launches"], "sharded_launches": {},
                   "collectives_per_call": {}}
            for n, rec in r0["sharded"].items():
                row["sharded_ms"][n] = round(rec["ms"], 3)
                row["sharded_launches"][n] = [
                    r["stages"][stage][i]["sharded"][n]["launches"] for r in ranks[:int(n)]]
                row["collectives_per_call"][n] = rec["collectives_per_call"]
            row["collective_bytes"] = PAYLOAD[stage](K, args.devices)
            rows.append(row)
            print(f"[{stage}] K={K}: single {r0['single']['ms']:.3f} ms, sharded "
                  f"{row['sharded_ms']} (collective {row['collective_bytes']} B)",
                  file=sys.stderr, flush=True)
        results["stages"][stage] = rows
    # crossover summary: the rank counts where sharded <= 1.2x single
    for stage, rows in results["stages"].items():
        for row in rows:
            ok = [int(n) for n, ms in row["sharded_ms"].items()
                  if ms <= 1.2 * row["single_ms"]]
            row["within_1p2x"] = sorted(ok)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="N gloo ranks on the CPU (default: the card(s))")
    ap.add_argument("--sizes", type=int, nargs="*", default=[1024, 4096, 16384])
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 8])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if _ranks.under_torchrun():
        args.n_all = _ranks.torchrun_world()
    elif args.cpu:
        args.n_all = args.cpu
    else:
        _ranks.layout(1, False)  # no CUDA: raises
        args.n_all = max(args.devices)  # ranks may share a card
    world = max(n for n in args.devices if n <= args.n_all)
    lay = _ranks.layout(world, bool(args.cpu))
    card = None
    if not args.cpu and int(os.environ.get("RANK", "0")) == 0:
        from ..utils.timing import card_line

        card = card_line()
        print(card)
    ranks = _ranks.run(rank_stages, args, world, bool(args.cpu))
    if ranks is None:  # a torchrun rank but 0
        return 0
    results = assemble(args, ranks, lay, card)
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
