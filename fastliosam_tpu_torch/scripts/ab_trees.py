"""Device operations and kernel launches per scan of two source trees, in
turns on one card: the per-scan and chunked engine paths of each tree's
``chip_smoke.py`` over the same figure-8 feed.

    python -m fastliosam_tpu_torch.scripts.ab_trees --tree parent=PATH --tree this=. \\
        [--order parent,this,this,parent] [--scans 150] [--window 50] [--out ab.json]

Each turn runs in a process of its own from its tree's root (the trees'
packages share a name), builds that tree's kernels and drives the
``make_engine``, ``run_engine`` and ``run_chunks`` of its ``chip_smoke.py``:
the per-scan path (``SlamEngine.process``, after a 12-scan warm-up) and the
chunked path (``process_chunk_deferred``, chunk 5). For each path it
reports device operations per scan over the last ``window`` scans traced
with ``torch.profiler`` (every kernel, copy and fill the device ran),
every kernel module's launches per scan over the whole run, ATE at full
precision, keyframes and loop pairs. Scans/s of a traced run is printed
but is no speed measure: the trace slows the host. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


class _Window:
    """Trace calls ``[start, stop)`` of an engine method with
    ``torch.profiler``, wrapping it on the instance."""

    def __init__(self, engine, method: str, start: int, stop: int):
        self.engine, self.method, self.start, self.stop = engine, method, start, stop
        self.calls, self.prof, self.wall_s = 0, None, 0.0
        fn = getattr(engine, method)

        def call(*args, **kwargs):
            import torch
            from torch.profiler import ProfilerActivity, profile

            if self.calls == self.start:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls += 1
            if self.calls == self.stop:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
                self.wall_s = time.perf_counter() - self.t0
            return out

        setattr(engine, method, call)

    def close(self):
        delattr(self.engine, self.method)  # back to the class's method


def turn(root: str, feed_path: str, window: int, chunk: int = 5) -> dict:
    """One tree's run of both paths (in this process, from ``root``)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from fastliosam_tpu_torch.ops import KERNEL_MODULES, build
    from fastliosam_tpu_torch.utils import geometry_precision

    build.build(build.sources())
    dev = torch.device("cuda", 0)
    feed = cs.load_feed(feed_path)
    n_scans = len(feed["stamps"])
    out = {"root": root, "card": cs.card_line()}
    with geometry_precision():
        for path in ("per_scan", "chunked"):
            per_scan = path == "per_scan"
            engine = cs.make_engine(dev, chunk=chunk)
            if per_scan:
                cs.run_engine(engine, feed, dev, min(12, n_scans))  # warm-up
            calls = n_scans if per_scan else n_scans // chunk
            per_call = 1 if per_scan else chunk
            w = _Window(engine, "process" if per_scan else "process_chunk_deferred",
                        calls - window // per_call, calls)
            for mod in KERNEL_MODULES:
                mod.reset_launches()
            t0 = time.perf_counter()
            if per_scan:
                cs.run_engine(engine, feed, dev, n_scans)
                scans = n_scans
            else:
                scans = cs.run_chunks(engine, feed, dev, chunk, deferred=True)["scans"]
            wall = time.perf_counter() - t0
            w.close()
            traced = cs.profile_summary(w.prof, w.wall_s, (w.stop - w.start) * per_call, top=8)
            out[path] = {
                "scans": scans,
                "device_ops_per_scan": traced["device_ops_per_scan"],
                "device_ms_per_scan": 1e3 * traced["device_busy_s"] / traced["window_scans"],
                "launches_per_scan": {mod.KERNEL["name"]: mod.launches / scans
                                      for mod in KERNEL_MODULES},
                "scans_per_s_traced_run": scans / wall,
                "ate_m": cs._ate(engine, feed),
                "keyframes": int(engine.kf.n),
                "loop_pairs": [list(p) for p in engine.loop_pairs],
                "traj_sum": float(np.stack(engine.realtime_traj).astype(np.float64).sum()),
            }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a source tree (give two)")
    ap.add_argument("--order", help="comma-separated tree names, e.g. a,b,b,a")
    ap.add_argument("--scans", type=int, default=150, help="figure-8 scans")
    ap.add_argument("--window", type=int, default=50, help="traced scans at the end")
    ap.add_argument("--out", type=Path, help="also write the turns as JSON here")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one turn, from this root
    ap.add_argument("--feed", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.turn:
        print(json.dumps(turn(args.turn, args.feed, args.window)))
        return 0

    import chip_smoke as cs  # this tree's, from the working directory

    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    feed = str(Path(cs.figure8_feed(args.scans)).resolve())
    turns = []
    for name in order:
        root = str(Path(trees[name]).resolve())
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn", root, "--feed", feed,
             "--window", str(args.window)],
            cwd=root, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"turn {name} failed (exit {proc.returncode})")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"] = name
        turns.append(rec)
        for path in ("per_scan", "chunked"):
            r = rec[path]
            lps = ", ".join(f"{k} {v:.2f}" for k, v in r["launches_per_scan"].items())
            print(f"{name:8s} {path:9s} device ops/scan {r['device_ops_per_scan']:.1f}, "
                  f"device ms/scan {r['device_ms_per_scan']:.3f}, launches/scan: {lps}; "
                  f"ATE {r['ate_m']!r} m, {r['keyframes']} keyframes, loops {r['loop_pairs']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(turns, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
