"""Loop-trust sweep over the synthetic KITTI circuits, with a per-loop
audit against ground truth (port of ``scripts/exp_loop_trust.py``).

Each spec drives ``drive_kitti`` over the 1160-scan circuit of one world
through the bench's long-run engine (:func:`make_longrun_engine`, the
port's copy of ``bench.py: _make_longrun_engine``, which ``chip_smoke.py``
uses too) with one loop-trust setting, and
prints one JSON record: realtime and keyframe ATE, RPE, loops,
verifications and the translation error of every accepted loop.

    python -m fastliosam_tpu_torch.scripts.exp_loop_trust \\
        canyon,1.0,0.0,,,0.5,1 canyon,1.0,0.0,,,0.5,5 rich,1.0,0.0,,,0.5,5 \\
        --out out/loop_trust.jsonl

A spec is ``world,cap,gnc[,radius,time_gap,thresh,multistart]`` as in the
JAX script (an empty field keeps its default): ``world`` is ``canyon`` (the
bench's long-run feed: loops at 10 m / 4 s) or ``rich`` (the feature-rich
world of ``bench.py: bench_kitti_rich``: the reference's 35 m / 30 s);
``cap`` the translation sqrt-info cap (``LoopConfig.max_sqrt_info``),
``gnc`` the loop-factor GNC barrier (0 keeps the engine's 2.0), ``thresh``
the fitness acceptance (default 1.5), ``multistart`` the coarse ICP starts.
The circuits are written under ``build/`` on first use by
``make_kitti_synth`` (:data:`GEN_WORKERS` processes at nice 10, in the
background while earlier specs run).

:func:`longrun_oracle` is the bench's oracle experiment (``bench.py:
bench_longrun_oracle``) on an engine that has already driven the circuit
loop-free: ground-truth loop factors and one deep batch solve.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
LONGRUN_SCANS = 1160  # the bench's circuit long run (bench.py: LONGRUN_SCANS)
RAW_PTS = 32768  # the bench's scan capacity (bench.py: RAW_PTS)
WORLDS = {"canyon": ROOT / "build" / f"kitti_synth_{LONGRUN_SCANS}",
          "rich": ROOT / "build" / f"kitti_synth_rich_{LONGRUN_SCANS}"}
# processes writing a circuit: four finish one in ~5 min beside a running
# engine on the card machine's 8 cores; more lost that machine
GEN_WORKERS = 4


def ensure_longrun_dataset(world: str = "canyon") -> str:
    """The 1160-scan circuit of ``world`` (``make_kitti_synth.generate``,
    2048 x 16 rays to 50 m; ``rich`` without the featureless canyon),
    written when it is not complete (its poses file is written last).
    Returns its root."""
    from . import make_kitti_synth

    root = WORLDS[world]
    velo = root / "sequences" / "00" / "velodyne"
    n_bins = len(list(velo.glob("*.bin"))) if velo.is_dir() else 0
    if n_bins != LONGRUN_SCANS or not (root / "poses" / "00.txt").exists():
        make_kitti_synth.generate(str(root), "00", n_scans=LONGRUN_SCANS, progress=False,
                                  rich=(world == "rich"), workers=GEN_WORKERS)
    return str(root)


def make_bench_engine(device=None, max_kf: int = 128, max_between: int = 256,
                      max_gps: int = 64, chunk: int = 5, mesh=None):
    """The bench's loop-closing pipeline (``eval/feeds.py: make_engine_for``,
    the port of ``bench.py: make_engine_for``): 8192 iEKF points, merged3, a
    2^19-slot map with 2 probes, loops at 10 m / 4 s over 16,384-point
    submaps, keyframes every metre; with ``mesh``, in mesh mode
    (``parallel``) on the rank's device."""
    from ..eval.feeds import make_engine_for

    return make_engine_for(None, chunk=chunk, max_kf=max_kf, max_between=max_between,
                           max_gps=max_gps, device=device, mesh=mesh)


def make_longrun_engine(loop_cfg=None, device=None):
    """The bench's circuit long-run engine (``bench.py:
    _make_longrun_engine``): :func:`make_bench_engine` with FoV-sliding
    eviction (det_range 60 m every 50 scans), 1024 keyframes / 2048 between
    / 64 GPS, LM 8 iterations, chain-aware GNC on loop factors; by default
    loops at 10 m / 4 s accepted below fitness 0.5 with information capped
    at 1 m."""
    from ..loop import LoopConfig
    from ..odom import OdomConfig
    from ..pgo import PoseGraphConfig

    engine = make_bench_engine(device)
    engine.odom_cfg = OdomConfig(point_filter_num=1, blind=1.0, filter_size_surf=0.5,
                                 num_ds_points=8192, det_range=60.0, evict_every=50,
                                 query_mode="merged3")
    engine.pgo_cfg = PoseGraphConfig(max_keyframes=1024, max_between=2048, max_gps=64,
                                     lm_iters=8, loop_gnc_barc=2.0, gnc_hop_trans_var=0.1)
    engine.loop_cfg = loop_cfg or LoopConfig(
        radius=10.0, time_gap=4.0, num_submap_keyframes=5, voxel_res=0.3,
        submap_points=16384, icp_score_threshold=0.5, max_sqrt_info=1.0)
    engine.reset()  # the stores and the graph at the new capacities
    return engine


# the oracle's injected loops (bench.py: bench_longrun_oracle): the shipped
# gating, the exact ground-truth relative pose at a fixed information
ORACLE_RADIUS_M, ORACLE_TIME_GAP_S = 10.0, 4.0
ORACLE_SQRT_INFO = [100.0] * 3 + [1000.0] * 3


def oracle_loops(kf_stamps, scan_times, gt):
    """The oracle's ground-truth loops: each keyframe's scan (its stamp to
    the nearest 0.1 s from the first scan time), and for each keyframe the
    nearest earlier keyframe within ``ORACLE_RADIUS_M`` and more than
    ``ORACLE_TIME_GAP_S`` before it, with their true relative pose. Returns
    ``(li, lj, lrel, pos_gt)``: query and candidate indices, ``(L, 4, 4)``
    relative poses and the keyframes' true positions."""
    kf_st = np.asarray(kf_stamps, np.float64)
    times = np.asarray(scan_times, np.float64)
    scan_of_kf = np.clip(np.round((kf_st - times[0]) / 0.1).astype(int), 0, len(times) - 1)
    Tgt = gt[scan_of_kf]
    pos_gt = Tgt[:, :3, 3]
    li, lj, lrel = [], [], []
    for i in range(len(kf_st)):
        d = np.linalg.norm(pos_gt[:i] - pos_gt[i], axis=1)
        ok = np.where((d < ORACLE_RADIUS_M) & (kf_st[i] - kf_st[:i] > ORACLE_TIME_GAP_S))[0]
        if len(ok):
            j = int(ok[np.argmin(d[ok])])
            li.append(i)
            lj.append(j)
            lrel.append(np.linalg.inv(Tgt[i]) @ Tgt[j])
    return li, lj, np.asarray(lrel, np.float32).reshape(-1, 4, 4), pos_gt


def longrun_oracle(engine, root, save_to=None) -> dict:
    """The oracle experiment of ``bench.py: bench_longrun_oracle`` on an
    engine that has driven the circuit at ``root`` loop-free: the
    odometry graph plus :func:`oracle_loops` at sqrt-info
    ``ORACLE_SQRT_INFO``, solved once at 32 LM / 768 PCG iterations with
    plain L2 loop factors (no GNC); the keyframe ATE (Umeyama-aligned)
    before and after. The floor the odometry chain and the solver reach
    when every loop is perfect. Returns the bench's keys (unrounded) and
    the solve's seconds, from and to a drained device queue. ``save_to``,
    if given, is an ``.npz`` path for the solved graph's inputs (the
    keyframe poses and every factor), the solve's configuration (JSON),
    the solved and true keyframe positions."""
    import torch

    from ..eval import align_umeyama
    from ..io import KittiSequence
    from ..pgo import from_arrays, solve
    from ..utils import host_read

    seq = KittiSequence(str(root), "00")
    n = engine.kf.n
    g = engine.graph
    n_bt = engine._n_bt_host
    kf_st, poses0, bt_i, bt_j, bt_rel, bt_si = host_read(
        engine.kf.stamps[:n], g.poses[: max(n, 1)], g.bt_i[:n_bt], g.bt_j[:n_bt],
        g.bt_rel[:n_bt], g.bt_sqrt_info[:n_bt])
    li, lj, lrel, pos_gt = oracle_loops(kf_st, seq.times, seq.gt_poses())
    si_loop = np.tile(np.asarray([ORACLE_SQRT_INFO], np.float32), (len(li), 1))
    cfg = engine.pgo_cfg._replace(lm_iters=32, pcg_iters=768, loop_gnc_barc=0.0)
    factors = {"bt_i": np.concatenate([bt_i, li]).astype(np.int32),
               "bt_j": np.concatenate([bt_j, lj]).astype(np.int32),
               "bt_rel": np.concatenate([bt_rel, lrel]),
               "bt_sqrt_info": np.concatenate([bt_si, si_loop])}
    g_or = from_arrays(cfg, poses0, **factors, device=engine.device)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    g_or, _ = solve(g_or, cfg, device=engine.device)
    est = host_read(g_or.poses[:n, :3, 3])
    solve_s = time.perf_counter() - t0

    def kf_ate(e):
        _, R, t = align_umeyama(e, pos_gt)
        e = e @ R.T + t
        return float(np.sqrt(np.mean(np.sum((e - pos_gt) ** 2, axis=1))))

    if save_to is not None:
        np.savez_compressed(save_to, poses0=poses0[:n], **factors, n_odom=n_bt,
                            cfg=json.dumps(cfg._asdict()), solved_xyz=est, pos_gt=pos_gt)
    return {"oracle_loops_injected": len(li),
            "oracle_odom_kf_ate_m": kf_ate(poses0[:n, :3, 3]),
            "oracle_solved_kf_ate_m": kf_ate(est), "oracle_solve_s": solve_s}


def loop_audit(engine, seq) -> list:
    """Each accepted loop against ground truth: the translation error of
    its measured relative pose (``t_err_m``) and its rotation error, the
    true distance between the two keyframes and the error left after the
    solve."""
    gt = seq.gt_poses()
    times = np.asarray(seq.times, np.float64)
    idx = np.clip(np.searchsorted(times, engine.keyframe_stamps().astype(np.float64)), 0,
                  len(times) - 1)
    kf = engine.keyframe_poses()
    out = []
    for (q, c), rel, fit in zip(engine.loop_pairs, engine.loop_rels, engine.loop_fitness):
        true = np.linalg.inv(gt[idx[q]]) @ gt[idx[c]]
        solved = np.linalg.inv(kf[q]) @ kf[c]
        d = np.linalg.inv(rel) @ true
        out.append({"pair": [q, c], "fitness": fit,
                    "t_err_m": float(np.linalg.norm(rel[:3, 3] - true[:3, 3])),
                    "rot_err_deg": float(np.degrees(np.arccos(np.clip(
                        (np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))),
                    "true_dist_m": float(np.linalg.norm(true[:3, 3])),
                    "solved_err_m": float(np.linalg.norm(solved[:3, 3] - true[:3, 3]))})
    return out


def loop_config(world: str, cap: float, multistart: int = 1, radius=None, time_gap=None,
                thresh: float = 1.5):
    """The JAX script's loop configuration of a spec."""
    from ..loop import LoopConfig

    near = (35.0, 30.0) if world == "rich" else (10.0, 4.0)
    return LoopConfig(radius=radius or near[0], time_gap=time_gap or near[1],
                      num_submap_keyframes=5, voxel_res=0.3, submap_points=16384,
                      max_sqrt_info=cap, icp_multistart=multistart,
                      icp_score_threshold=thresh)


def run(world: str, cap: float, multistart: int = 1, gnc: float = 0.0, radius=None,
        time_gap=None, thresh: float = 1.5, root=None, device=None) -> dict:
    """One spec over the circuit of ``world`` (at ``root``, else made)."""
    from ..io import KittiSequence
    from ..runtime.drivers import drive_kitti
    from ..utils import host_reads, reset_host_reads

    root = root or ensure_longrun_dataset(world)
    loop_cfg = loop_config(world, cap, multistart, radius, time_gap, thresh)
    engine = make_longrun_engine(loop_cfg, device)
    if gnc > 0.0:
        # hop variance at the circuit feeds' measured LiDAR-only drift rate
        # (the JAX script's note: ~0.1 m² a hop, not the reference's 0.01)
        engine.pgo_cfg = engine.pgo_cfg._replace(loop_gnc_barc=gnc, lm_iters=8,
                                                 gnc_hop_trans_var=0.1)
        engine.reset()
    reset_host_reads()
    t0 = time.perf_counter()
    out = drive_kitti(engine, root, "00", scan_capacity=RAW_PTS, chunk=5, progress=False)
    audit = loop_audit(engine, KittiSequence(root, "00"))
    te = [a["t_err_m"] for a in audit]
    return {
        "world": world, "cap": cap, "multistart": multistart, "gnc": gnc,
        "radius": loop_cfg.radius, "time_gap": loop_cfg.time_gap, "thresh": thresh,
        "ate_m": out.get("ate_m"), "kf_ate_m": out.get("kf_ate_m"),
        "rpe_1s_m": out.get("rpe_1s_m"), "n_loops": out["n_loops"],
        "n_keyframes": out["n_keyframes"], "n_solves": out["n_solves"],
        "n_attempts": len(engine.loop_attempts), "scans_per_sec": out["scans_per_sec"],
        "host_reads": host_reads(), "seconds": time.perf_counter() - t0,
        "loop_te_med_m": float(np.median(te)) if te else None,
        "loop_te_max_m": float(np.max(te)) if te else None,
        "loop_te_p90_m": float(np.percentile(te, 90)) if te else None,
        "loops": audit,
    }


def _parse(spec: str) -> dict:
    f = spec.split(",")
    opt = lambda i, cast, default: cast(f[i]) if len(f) > i and f[i] else default  # noqa: E731
    return dict(world=f[0], cap=float(f[1]), gnc=opt(2, float, 0.0), radius=opt(3, float, None),
                time_gap=opt(4, float, None), thresh=opt(5, float, 1.5),
                multistart=opt(6, int, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("specs", nargs="*", default=["canyon,0.0,0.0"],
                    help="world,cap,gnc[,radius,time_gap,thresh,multistart]")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", type=Path, help="also append each record here (JSON lines)")
    args = ap.parse_args(argv)
    specs = [_parse(s) for s in args.specs]
    for s in specs:
        if s["world"] not in WORLDS:
            raise SystemExit(f"unknown world {s['world']!r} (canyon, rich)")

    # the circuits are written one after another by a worker thread whose
    # generator processes inherit its nice value: they leave the engine's
    # process its core
    with ThreadPoolExecutor(max_workers=1, initializer=os.nice, initargs=(10,)) as pool:
        feeds = {w: pool.submit(ensure_longrun_dataset, w)
                 for w in dict.fromkeys(s["world"] for s in specs)}
        for s in specs:
            root = feeds[s["world"]].result()
            rec = run(**s, root=root, device=args.device)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with args.out.open("a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
