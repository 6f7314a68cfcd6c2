"""Scaling harness (port of ``scripts/bench_scaling.py``): the factor-sharded
pose-graph solve, the point-sharded loop ICP and the keyframe-sharded loop
search over 1..N ranks of ``torch.distributed``, one process a rank
(``scripts/_ranks.py``), where the JAX script drives N devices from one
process. ``build_graph`` (a noisy ring of ``K`` keyframes) is also the input
of ``bench_pgo_crossover.py``.

    python -m fastliosam_tpu_torch.scripts.bench_scaling [--keyframes 2048]
        [--what pgo|loop|all] [--icp-points 16384] [--devices 1 2 4 8]
        [--cpu N] [--out FILE]
    torchrun --nproc-per-node 4 -m fastliosam_tpu_torch.scripts.bench_scaling

Without ``--cpu`` the ranks run on the card(s), rank r on ``cuda:{r %
cards}``: NCCL with a card a rank, gloo when ranks share a card. ``--cpu
N`` runs N gloo ranks on the CPU (the JAX script's N virtual CPU devices).
One world of ``max(--devices)`` ranks runs every count as the subgroup of
its first n ranks. Default sweep: 1, 2, 4, ... up to N with ``--cpu N``,
else up to the cards' count.

Each timer runs the JAX timer's inputs and repetitions: one warm call, then
3 (solve, ICP) or 20 (search) timed calls, each ending in
``torch.cuda.synchronize`` on the rank's device (JAX: ``block_until_ready``
a call), on rank 0's host clock after a barrier of the mesh. The JSON
keeps the JAX script's keys (``keyframes``, ``icp_points``, ``backend``,
``virtual_devices``, ``host_cores``, ``pgo_solve`` / ``loop_icp`` /
``loop_detect`` rows of ``devices``, ``ms``, ``speedup``, ``efficiency``)
and adds ``cards``, ``ranks_per_card``, ``dist_backend``, ``card``, rank
0's seconds in the sweeps (``rank_s``, by stage ``stage_s``), the start
cost of the whole graph (``pgo_start_cost``) and, a row, the timer's
result on every rank of the mesh (``aux``: the solve's cost, the ICP's
fitness, the candidate index), each rank's kernel launches and rank 0's
collectives a call; a solve row also the cost its sharded sums start
from (``start_cost``, no LM step) and the largest distance of its solved
positions from the first count's (``pose_dev_m``) and from the start
(``pose_step_m``). ``build_graph``'s
poses satisfy every factor, so its costs are float32 rounding of the
residuals, and the device's sums in another order (another rank count,
batch size or card) give other roundings.

When ranks share a device (the CPU, or several ranks on one card) they
share its cores or its queue, and every gloo collective goes through host
memory (~4 ms on one card whatever its size): the efficiencies then
measure the overhead of the sharding machinery, not scaling.
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

REPS = {"pgo": 3, "loop-icp": 3, "detect": 20}


def build_graph(cfg, K, seed=0, device=None):
    """A ``PoseGraph`` of ``K`` poses on a circle of 0.5 m steps with 2 cm
    of translation noise a step (numpy's draws from ``seed``, as the JAX
    harness draws them), ``K - 1`` odometry factors and the loop ``K - 1 ->
    0``. ``device`` as :func:`pgo.from_arrays` (``None`` means ``cuda``)."""
    from ..pgo import from_arrays

    rng = np.random.default_rng(seed)
    a = 2 * np.pi / K
    ca, sa = np.cos(a), np.sin(a)
    step_T = np.eye(4, dtype=np.float32)
    step_T[:2, :2] = [[ca, -sa], [sa, ca]]
    step_T[0, 3] = 0.5
    poses = [np.eye(4, dtype=np.float32)]
    rels = []
    for _ in range(1, K):
        noise = np.eye(4, dtype=np.float32)
        noise[:3, 3] = rng.normal(size=3) * 0.02
        rel = step_T @ noise
        poses.append(poses[-1] @ rel)
        rels.append(rel)
    bt_i = np.arange(K - 1)
    bt_j = np.arange(1, K)
    si = np.tile(np.asarray([10.0] * 3 + [100.0] * 3, np.float32), (K - 1, 1))
    bt_i = np.append(bt_i, K - 1)
    bt_j = np.append(bt_j, 0)
    rels.append(np.linalg.inv(poses[-1]).astype(np.float32))
    si = np.vstack([si, np.asarray([[100.0] * 3 + [1000.0] * 3], np.float32)])
    return from_arrays(
        cfg, np.stack(poses), bt_i=bt_i, bt_j=bt_j, bt_rel=np.stack(rels),
        bt_sqrt_info=si, device=device,
    )


def _timed(mesh, call, reps: int) -> float:
    """Mean seconds of ``reps`` calls of ``call`` after a warm one, each
    ending in a device sync, from a barrier of the mesh."""
    call()
    _ranks.sync(mesh.device)
    torch.distributed.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
        _ranks.sync(mesh.device)
    return (time.perf_counter() - t0) / reps


def time_solve(g, cfg, mesh, keep=None):
    """The factor-sharded LM / PCG solve of the whole graph ``g``; returns
    ``(seconds, cost)``. With ``keep`` (a dict) the last solve's poses go
    to ``keep["poses"]``."""
    from ..parallel import solve_sharded

    out = {}

    def call():
        out["g"], out["cost"] = solve_sharded(g, cfg, mesh)

    dt = _timed(mesh, call, REPS["pgo"])
    if keep is not None:
        keep["poses"] = out["g"].poses
    return dt, float(out["cost"])


def time_loop_icp(n_pts, mesh):
    """Point-axis-sharded loop-verification ICP (16k submaps, 50 iters);
    returns ``(seconds, fitness)``."""
    from ..parallel import icp_align_sharded
    from ..parallel.mesh import shard_leading

    rng = np.random.default_rng(1)
    base = rng.uniform(-40, 40, size=(n_pts, 3)).astype(np.float32)
    base[:, 2] = np.sin(base[:, 0] * 0.3) + 0.1 * base[:, 1]
    dev = mesh.device
    src = torch.from_numpy(base + np.array([1.5, -1.0, 0.3], np.float32)).to(dev)
    dst = torch.from_numpy(base).to(dev)
    mask = torch.ones((n_pts,), dtype=torch.bool, device=dev)
    src_l, mask_l = shard_leading(mesh, src), shard_leading(mesh, mask)
    out = {}

    def call():
        out["fit"] = icp_align_sharded(src_l, mask_l, dst, mask, mesh, max_iterations=50,
                                       max_corr_dist=52.5)[1]

    dt = _timed(mesh, call, REPS["loop-icp"])
    return dt, float(out["fit"])


def time_detect(K, mesh):
    """Keyframe-axis-sharded loop-candidate search over K keyframes;
    returns ``(seconds, index)``."""
    from ..parallel import detect_sharded
    from ..parallel.mesh import shard_leading

    rng = np.random.default_rng(2)
    dev = mesh.device
    pos = torch.from_numpy(rng.uniform(-500, 500, size=(K, 3)).astype(np.float32)).to(dev)
    stamps = torch.from_numpy((np.arange(K) * 0.5).astype(np.float32)).to(dev)
    valid = torch.ones((K,), dtype=torch.bool, device=dev)
    pos_l, st_l, va_l = (shard_leading(mesh, t) for t in (pos, stamps, valid))
    out = {}

    def call():
        out["i"] = detect_sharded(pos_l, st_l, va_l, K - 1, radius=35.0, time_gap=30.0,
                                  mesh=mesh)[0]

    dt = _timed(mesh, call, REPS["detect"])
    return dt, int(out["i"])


def _stages(args) -> list:
    st = []
    if args.what in ("pgo", "all"):
        st.append(("pgo_solve", "pgo"))
    if args.what in ("loop", "all"):
        st += [("loop_icp", "loop-icp"), ("loop_detect", "detect")]
    return st


def rank_sweeps(args) -> dict:
    """One rank's part of every sweep: for each stage and rank count, the
    mesh's ranks run the timer and the others wait at a barrier of the
    world. Returns this rank's ``{stage: {n: record}}``."""
    from ..parallel import solve_sharded
    from ..parallel.distributed import rank_device
    from ..pgo import PoseGraphConfig, graph_cost

    t_rank = time.perf_counter()
    dev = rank_device()
    by_n = _ranks.meshes(args.sweep)
    K = args.keyframes
    cfg = PoseGraphConfig(max_keyframes=K, max_between=2 * K, max_gps=8, lm_iters=4,
                          pcg_iters=64)
    g = build_graph(cfg, K, device=dev)
    solved = {}
    timers = {
        "pgo": lambda mesh: time_solve(g, cfg, mesh, solved),
        "loop-icp": lambda mesh: time_loop_icp(args.icp_points, mesh),
        "detect": lambda mesh: time_detect(max(K, 4096), mesh),
    }
    out = {"rank": torch.distributed.get_rank(), "device": str(dev),
           "pgo_start_cost": float(graph_cost(g, cfg, g.poses[0])), "stages": {},
           "stage_s": {}}
    first_poses = None
    for key, label in _stages(args):
        recs = out["stages"][key] = {}
        t_stage = time.perf_counter()
        for n in args.sweep:
            mesh = by_n[n]
            if mesh is not None:
                before = _ranks.launches()
                mesh.reset_counts()
                dt, aux = timers[label](mesh)
                rec = recs[str(n)] = {
                    "s": dt, "aux": aux, "launches": _ranks.launches_since(before),
                    "collectives_per_call": mesh.collectives / (REPS[label] + 1)}
                if label == "pgo":
                    # the cost this count's sharded sums start from (no LM step),
                    # and the solved poses against the first count's
                    rec["start_cost"] = float(solve_sharded(g, cfg._replace(lm_iters=0),
                                                            mesh)[1])
                    p = solved["poses"][:, :3, 3]
                    first_poses = p if first_poses is None else first_poses
                    rec["pose_dev_m"] = float(torch.max(torch.abs(p - first_poses)))
                    rec["pose_step_m"] = float(torch.max(torch.abs(p - g.poses[:, :3, 3])))
            torch.distributed.barrier()
        out["stage_s"][key] = time.perf_counter() - t_stage
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def assemble(args, ranks: list, lay: dict, card) -> dict:
    """The JSON record from every rank's :func:`rank_sweeps`."""
    out = {
        "keyframes": args.keyframes,
        "icp_points": args.icp_points,
        "backend": "cpu" if args.cpu else "cuda",
        "virtual_devices": lay["virtual_devices"],
        "host_cores": os.cpu_count(),
        "cards": lay["cards"],
        "ranks_per_card": lay["ranks_per_card"],
        "dist_backend": ranks[0]["dist_backend"],
        "card": card,
        "pgo_start_cost": ranks[0]["pgo_start_cost"],
        "rank_s": ranks[0]["rank_s"],
        "stage_s": ranks[0]["stage_s"],
        "ranks_s": dict(_ranks.LAST_RUN_S),
    }
    for key, label in _stages(args):
        rows = []
        t1 = None
        for n in args.sweep:
            recs = [r["stages"][key][str(n)] for r in ranks[:n]]
            dt = recs[0]["s"]
            if t1 is None:
                t1 = dt
            eff = t1 / (dt * n)
            rows.append({"devices": n, "ms": round(dt * 1e3, 2),
                         "speedup": round(t1 / dt, 3), "efficiency": round(eff, 3),
                         "aux": recs[0]["aux"], "aux_by_rank": [r["aux"] for r in recs],
                         "launches_by_rank": [r["launches"] for r in recs],
                         "collectives_per_call": recs[0]["collectives_per_call"],
                         **{k: recs[0][k] for k in ("start_cost", "pose_dev_m", "pose_step_m")
                            if k in recs[0]}})
            print(f"  [{label}] {n} dev: {dt*1e3:8.2f} ms  "
                  f"speedup {t1/dt:5.2f}x  efficiency {eff:.2f}", file=sys.stderr)
        out[key] = rows
    return out


def _rank_entry(args) -> dict:
    rec = rank_sweeps(args)
    rec["dist_backend"] = torch.distributed.get_backend()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keyframes", type=int, default=2048)
    ap.add_argument("--what", choices=("pgo", "loop", "all"), default="all")
    ap.add_argument("--icp-points", type=int, default=16384)
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="rank counts to sweep (default: 1,2,4,... up to --cpu N or the cards)")
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="N gloo ranks on the CPU (default: the card(s))")
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args(argv)

    if _ranks.under_torchrun():
        n_all = _ranks.torchrun_world()
    elif args.cpu:
        n_all = args.cpu
    else:
        n_all = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _ranks.layout(1, False)  # no CUDA: raises
    if args.devices:
        bad = [d for d in args.devices if d > n_all]
        if bad and (args.cpu or _ranks.under_torchrun()):
            ap.error(f"requested {max(bad)} ranks but only {n_all} exist")
        args.sweep = list(args.devices)  # on the card(s) ranks may share a card
    else:
        args.sweep = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_all]
    world = max(args.sweep)
    lay = _ranks.layout(world, bool(args.cpu))
    card = None
    if not args.cpu and int(os.environ.get("RANK", "0")) == 0:
        from ..utils.timing import card_line

        card = card_line()
        print(card)
    ranks = _ranks.run(_rank_entry, args, world, bool(args.cpu))
    if ranks is None:  # a torchrun rank but 0
        return 0
    out = assemble(args, ranks, lay, card)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
