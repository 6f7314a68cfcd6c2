"""Readings behind a cell's limits (``limits/<workload>.json``), in one
process on the card: the program's compared numbers over many seeds, each
a full run of the cell at a short window, and the control's: the
reference's step from the same lane states computed with TF32 matmuls
(the precision below the float32 the configurations state), compared with
its float32 step by the same numbers. The benchmark's own runs never run
this.

    python3 -m slam_bench.calibrate --workload lio.hdl64.fleet99 \\
        --seeds 11 12 13 --control 3 --seconds 5 --out calib.jsonl
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import check, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds (the first) with the control")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    torch.set_num_threads(run.INTRA_OP_THREADS)
    with open(args.out, "a") as out:
        for i, seed in enumerate(args.seeds):
            keep = {}
            t0 = time.perf_counter()
            res = run.run(bench, args.workload, seed, args.seconds, False, keep=keep)
            rec = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                   "failed": res["failed"], "metrics": res["metrics"],
                   "program": keep["readings"]}
            if i < args.control:
                control = {}
                for b, prog in keep["after"].items():
                    state, config = keep["before"][b], keep["config"]
                    got = check.compare_step(
                        check.step_from(keep["feed"], prog["scan"], state, config, tf32=True),
                        check.step_from(keep["feed"], prog["scan"], state, config))
                    for k, v in got.items():
                        control[k] = max(control.get(k, 0.0), v)
                rec["control"] = control
            rec["seconds"] = time.perf_counter() - t0
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)
            del keep
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
