"""Attribute the chunked engine's time (port of
``scripts/profile_pipeline.py``).

    python -m fastliosam_tpu_torch.scripts.profile_pipeline [--chunk 5] [--reps 3]
        [--device cpu]

Runs the bench's figure-8 feed (``eval/feeds.py: fig8_sequence``, 150
scans, cached under ``build/feeds/``) through the bench's engine
(``make_engine_for``) in chunks, four ways:

  full           keyframes, loop detection, ICP verification and solves
                 (``process_chunk``)
  full_deferred  the same through ``process_chunk_deferred`` (the
                 production mode)
  no_verify      keyframes committed, loop verification suppressed (every
                 keyframe marked as loop-processed before and after each
                 chunk)
  no_kf          keyframe threshold at 1e9 m on an engine of its own: pure
                 chunked odometry

Each variant runs once warm, then ``--reps`` times; its wall time is the
least of the timed runs (host clock, from and to a drained device queue).
``full - no_verify`` is the loop ICP and solve cost, ``no_verify - no_kf``
the keyframe commits, ``no_kf`` the chunked odometry. Prints the JAX
script's JSON (``wall_s``, ``scans_per_sec``, ``kf_loops_solves`` a
variant, ``attribution_s``) with the card's name and power limit under
``card`` and, a variant, whether every timed run repeated the warm run bit
for bit (``replay_equal``: trajectory, keyframes, loops, solves) and the
kernels it launched over all its runs (``launches``).

The port reads ``cfg.keyframe_threshold`` at call time, so replacing the
engine's ``cfg`` is enough for ``no_kf`` (the JAX engine bakes it into its
chunk program and must rebuild it).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..eval import feeds
from ..ops import KERNEL_MODULES
from ..utils.device import resolve_device
from ..utils.timing import card_line

VARIANTS = (("full", False), ("full_deferred", True), ("no_verify", False), ("no_kf", False))
NO_VERIFY = 1 << 30  # every keyframe counts as loop-processed


def setup(data, chunk: int = 5, device=None) -> dict:
    """The two engines (the bench's, and one with keyframes off) and the
    feed staged in chunks on the device."""
    engine = feeds.make_engine_for(data, chunk=chunk, device=device)
    engine_nokf = feeds.make_engine_for(data, chunk=chunk, device=device)
    engine_nokf.cfg = engine_nokf.cfg._replace(keyframe_threshold=1e9)
    feed, _ = feeds._stage_chunks(data, chunk, engine.device)
    return {"data": data, "engine": engine, "engine_nokf": engine_nokf, "feed": feed,
            "n_fed": len(feed) * chunk}


def run(ctx, variant: str, deferred: bool = False):
    """One run of ``variant`` (``full``, ``no_verify`` or ``no_kf``) from the
    feed's initial state: ``(seconds, (keyframes, loops, solves),
    realtime trajectory, loop pairs)``."""
    e = ctx["engine_nokf"] if variant == "no_kf" else ctx["engine"]
    feeds._init_engine_at(e, ctx["data"])
    if variant == "no_verify":
        e._loop_processed_kf = NO_VERIFY
    step = e.process_chunk_deferred if deferred else e.process_chunk
    feeds.sync(e)
    t0 = time.perf_counter()
    for (scans, imus, stamps, sdt, _lo, _hi) in ctx["feed"]:
        step(scans, imus, stamps, sdt)
        if variant == "no_verify":
            e._loop_processed_kf = NO_VERIFY
    e.finish()
    feeds.sync(e)
    el = time.perf_counter() - t0
    return (el, (e.kf.n, len(e.loop_pairs), e.solve_count), np.stack(e.realtime_traj),
            list(e.loop_pairs))


def _launches() -> dict:
    return {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}


def profile(ctx, reps: int = 3, print_fn=None):
    """Every variant, warm then ``reps`` timed runs. Returns the script's
    record and, a variant, the fastest timed run's trajectory and loop
    pairs (``{variant: {"traj", "loop_pairs"}}``)."""
    out, runs = {}, {}
    for variant, deferred in VARIANTS:
        v = variant.replace("_deferred", "")
        before = _launches()
        _, w_stats, w_traj, w_loops = run(ctx, v, deferred)
        timed = [run(ctx, v, deferred) for _ in range(reps)]
        el, stats, traj, loops = min(timed, key=lambda r: r[0])
        after = _launches()
        out[variant] = {
            "wall_s": round(el, 3),
            "scans_per_sec": round(ctx["n_fed"] / el, 2),
            "kf_loops_solves": list(stats),
            "replay_equal": all(s == w_stats and lp == w_loops and np.array_equal(t, w_traj)
                                for _, s, t, lp in timed),
            "launches": {k: after[k] - before[k] for k in after},
        }
        runs[variant] = {"traj": traj, "loop_pairs": loops}
        if print_fn is not None:
            print_fn(f"# {variant}: {out[variant]}")
    full, nv, nk = (out[v]["wall_s"] for v in ("full", "no_verify", "no_kf"))
    out["attribution_s"] = {
        "verify_plus_solve": round(full - nv, 3),
        "keyframe_commit": round(nv - nk, 3),
        "chunked_odom": round(nk, 3),
    }
    return out, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunk", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else None
    ctx = setup(feeds.fig8_sequence(), args.chunk, dev)
    out, _ = profile(ctx, args.reps, print_fn=lambda line: print(line, file=sys.stderr))
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
