"""Pipeline-parallel overlap measurement (port of
``scripts/bench_pp_overlap.py``): how much loop-ICP verification time is
hidden by running it on a second card while the odometry keeps running on
the first (the engine's ``EngineConfig.loop_device``).

    python -m fastliosam_tpu_torch.scripts.bench_pp_overlap [--n-chunks 12]
        [--chunk 5] [--pts 4096] [--submap 8192] [--cpu N] [--out FILE]

The JAX script's programs on its inputs: ``odom/pipeline.py: odom_rollout``
over a chunk of ``--chunk`` scans of ``--pts`` uniform random points (no
IMU: every sample masked) into a 2^16-slot map on ``cuda:0``, and
``loop/closure.py: verify_loop(..., device=...)`` of keyframe 7 against
keyframe 0 of 8 random keyframe clouds, as the engine's verification runs
it. A run dispatches one chunk and one verification a chunk and reads the
previous verification's flag on the host each chunk, as the engine does;
it is timed on the host clock from and to drained device queues.
``same_device_s``: verification on ``cuda:0`` (the best of 3 runs);
``split_device_s``: on ``cuda:1`` (best of 3); ``odom_only_s``: the
chunks alone. Nothing adds a thread or a stream: the eager port issues
every launch from the one host thread, as the JAX engine does.

The split needs two CUDA devices. With one card, or with ``--cpu N`` (the
CPU, whatever N), ``split_device_s``, ``verify_cost_hidden_frac`` and
``speedup`` are ``null`` and ``split`` says why; the split is never run on
the same card, another stream or the CPU in its place. Beside the JAX
script's keys the JSON has each run's verification flags
(``accepted_by_run``), the kernel launches of the odometry and of the
verifications (each over the runs' chunks) and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# the JAX script's configurations (bench_pp_overlap.py:61-95)
MAP_CFG = dict(capacity=1 << 16, voxel_size=0.4, min_points=4)
ODOM_CFG = dict(point_filter_num=1, blind=0.5, filter_size_surf=0.3, num_ds_points=2048,
                det_range=100.0, evict_every=10_000)
N_KF = 8
QUERY, CAND = 7, 0
SCAN_DT = float(np.float32(0.1))
IMU_CAP = 8


def loop_cfg_kwargs(submap: int) -> dict:
    return dict(num_submap_keyframes=2, submap_points=submap, max_iterations=30, nn_chunk=1024)


def draws(chunk: int, pts: int, submap: int):
    """The JAX script's draws from ``default_rng(0)``, in its order: the
    chunk's ``(chunk, pts, 3)`` scans (z folded to ``|z| / 10``) and the
    ``(8, submap / 2, 3)`` keyframe clouds."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-20, 20, size=(chunk, pts, 3)).astype(np.float32)
    xyz[..., 2] = np.abs(xyz[..., 2]) * 0.1
    kf_clouds = rng.uniform(-15, 15, size=(N_KF, submap // 2, 3)).astype(np.float32)
    return xyz, kf_clouds


def imu_arrays(chunk: int) -> dict:
    """The JAX script's IMU batches: stamps 1e9, zero rates and forces,
    every sample masked."""
    return {"stamps": np.full((chunk, IMU_CAP), 1e9, np.float32),
            "gyro": np.zeros((chunk, IMU_CAP, 3), np.float32),
            "acc": np.zeros((chunk, IMU_CAP, 3), np.float32),
            "mask": np.zeros((chunk, IMU_CAP), bool)}


def programs(chunk: int, pts: int, submap: int, odom_dev, counts=None) -> dict:
    """The odometry chunk (``roll(state)``), a fresh state (``init()``) and
    the verification on a device (``verify(device)``: ``verify_loop``'s
    ``(rel, sqrt_info, accepted, fitness)``), on the script's inputs. The
    inputs live on ``odom_dev``, as the JAX script's committed arrays live
    on device 0. With ``counts`` each call adds its kernel launches to
    ``counts["odometry"]`` or ``counts["verification"]``."""
    from ..loop import LoopConfig, verify_loop
    from ..map import VoxelMapConfig
    from ..odom import ImuBatch, OdomConfig, Scan, init_odom
    from ..odom.pipeline import odom_rollout
    from ..ops import KERNEL_MODULES

    map_cfg = VoxelMapConfig(**MAP_CFG)
    odom_cfg = OdomConfig(**ODOM_CFG)
    loop_cfg = LoopConfig(**loop_cfg_kwargs(submap))
    xyz, kf = draws(chunk, pts, submap)
    scans = Scan(xyz=torch.from_numpy(xyz).to(odom_dev),
                 t_offset=torch.zeros((chunk, pts), dtype=torch.float32, device=odom_dev),
                 mask=torch.ones((chunk, pts), dtype=torch.bool, device=odom_dev))
    imus = ImuBatch(**{k: torch.from_numpy(v).to(odom_dev) for k, v in imu_arrays(chunk).items()})
    kf_clouds = torch.from_numpy(kf).to(odom_dev)
    kf_masks = torch.ones(kf.shape[:2], dtype=torch.bool, device=odom_dev)
    poses = torch.eye(4, dtype=torch.float32, device=odom_dev).expand(N_KF, 4, 4)
    valid = torch.ones((N_KF,), dtype=torch.bool, device=odom_dev)

    def counted(part, fn):
        if counts is None:
            return fn()
        before = [m.launches for m in KERNEL_MODULES]
        out = fn()
        acc = counts.setdefault(part, {})
        for m, b in zip(KERNEL_MODULES, before):
            if m.launches > b:
                acc[m.KERNEL["name"]] = acc.get(m.KERNEL["name"], 0) + m.launches - b
        return out

    def roll(st):
        return counted("odometry", lambda: odom_rollout(
            st, scans, imus, SCAN_DT, odom_cfg, map_cfg, device=odom_dev)[0])

    def verify(device):
        return counted("verification", lambda: verify_loop(
            kf_clouds, kf_masks, poses, valid, QUERY, CAND, loop_cfg, device=device))

    return {"roll": roll, "verify": verify,
            "init": lambda: init_odom(map_cfg, odom_cfg, device=odom_dev)}


def _sync(*devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(prog, odom_dev, verify_dev, n_chunks: int):
    """One timed run: ``n_chunks`` odometry chunks, a verification
    dispatched after each, the previous flag read on the host each chunk.
    Returns ``(seconds, every chunk's flag)``."""
    from ..utils.sync import host_read

    st = prog["roll"](prog["init"]())  # warm state
    _sync(odom_dev, verify_dev)
    t0 = time.perf_counter()
    outs, flags = [], []
    for _ in range(n_chunks):
        st = prog["roll"](st)  # dispatch odometry
        outs.append(prog["verify"](verify_dev))  # dispatch verification
        # the host reads only the previous verification's flag, as the engine
        if len(outs) > 1:
            flags.append(bool(host_read(outs[-2][2])))
    _sync(odom_dev, verify_dev)
    seconds = time.perf_counter() - t0
    flags.append(bool(host_read(outs[-1][2])))
    return seconds, flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="run on the CPU (the JAX script's N virtual devices; the split is "
                    "not run there)")
    ap.add_argument("--n-chunks", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=5)
    ap.add_argument("--pts", type=int, default=4096)
    ap.add_argument("--submap", type=int, default=8192)
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device
    from ..utils.precision import geometry_precision

    dev = resolve_device("cpu" if args.cpu else None)
    card, split_dev, why = None, None, None
    if dev.type == "cuda":
        from ..ops import build
        from ..utils.timing import card_line

        card = card_line()
        print(card)
        build.build(build.sources())  # before the warm runs, not inside them
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            split_dev = torch.device("cuda", 1)
        else:
            why = f"needs 2 CUDA devices, found {n_cards}"
    else:
        why = "--cpu: the split needs 2 CUDA devices"

    counts = {}
    with geometry_precision():
        prog = programs(args.chunk, args.pts, args.submap, dev, counts)
        devs = [dev] + ([split_dev] if split_dev is not None else [])
        for d in devs:  # warm both verification devices and the odometry
            run(prog, dev, d, 2)
        counts.clear()
        same = [run(prog, dev, dev, args.n_chunks) for _ in range(3)]
        split = [run(prog, dev, split_dev, args.n_chunks) for _ in range(3)] if split_dev else []
        # the stage costs alone
        st = prog["roll"](prog["init"]())
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.n_chunks):
            st = prog["roll"](st)
        _sync(dev)
        t_odom = time.perf_counter() - t0

    t_same = min(s for s, _ in same)
    rec = {"metric": "pp_loop_overlap", "backend": dev.type, "n_chunks": args.n_chunks,
           "odom_only_s": round(t_odom, 3), "same_device_s": round(t_same, 3),
           "split_device_s": None, "verify_cost_hidden_frac": None, "speedup": None}
    if split:
        t_split = min(s for s, _ in split)
        hidden = (t_same - t_split) / max(t_same - t_odom, 1e-9)
        rec.update({"split_device_s": round(t_split, 3),
                    "verify_cost_hidden_frac": round(hidden, 3),
                    "speedup": round(t_same / t_split, 3)})
    else:
        rec["split"] = why
    rec.update({"card": card, "chunk": args.chunk, "pts": args.pts, "submap": args.submap,
                "accepted_by_run": {"same_device": [f for _, f in same],
                                    "split_device": [f for _, f in split]},
                "launches": counts})
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
