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
    """The bench's loop-closing pipeline (``bench.py: make_engine_for``):
    8192 iEKF points, merged3, a 2^19-slot map with 2 probes, loops at
    10 m / 4 s over 16,384-point submaps, keyframes every metre; with
    ``mesh``, in mesh mode (``parallel``) on the rank's device."""
    from ..loop import LoopConfig
    from ..map import VoxelMapConfig
    from ..odom import OdomConfig
    from ..pgo import PoseGraphConfig
    from ..runtime import EngineConfig, SlamEngine

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
        mesh=mesh,
        device=device,
    )


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
