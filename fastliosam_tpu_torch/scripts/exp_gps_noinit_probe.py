"""Two odometry probes (port of ``scripts/exp_gps_noinit_probe.py``): the
per-keyframe-hop drift of the raw odometry on the figure-8 feed (the basis
of the degraded-GPS bench's between-factor noise model), and the per-scan
error profile of a run from the identity state (where the no-init ATE
accrues: the first scans' transient or steady drift).

    python -m fastliosam_tpu_torch.scripts.exp_gps_noinit_probe [both|hop|noinit]
        [--device cpu]

``hop``: the bench's engine (``eval/feeds.py: make_engine_for``) over the
150-scan figure-8 feed in chunks of 5, one ``process_chunk_deferred`` run
from the true initial pose with ``p`` moved by 2e-4 m; then each hop
between consecutive keyframes, raw odometry against ground truth. The JAX
script reads the engine after ``bench.bench_pipeline()``, whose last run is
exactly this deferred, jittered one (its docstring says "sync"); the port
runs that one run alone and reproduces what the JAX script computes.
Prints ``n_hops``, ``hop_err_med_m``, ``hop_err_p90_m``, ``hop_err_max_m``
and ``hop_len_med_m``.

``noinit``: the bench's odometry rollout (``make_rollout``) over the
43-scan odometry feed (``get_sequence``) from the identity state, each
scan's position error in the filter's own frame (the first body frame), and
the RMS over all scans and from scan 5 and 10 on. The JAX script first runs
the bench's timed odometry (four rollouts that only time); the port runs
the identity-start rollout once. Prints ``per_scan_err``, ``ate_all``,
``ate_skip5`` and ``ate_skip10``.

Both run on the card unless ``--device cpu`` is given (the feeds are
cached under ``build/feeds/``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..eval import feeds
from ..utils.device import resolve_device

HOP_JITTER_M = 2e-4  # the bench's last deferred run starts here (bench.py: bench_pipeline)


def probe_per_hop(device=None, data=None, chunk: int = 5, jitter: float = HOP_JITTER_M):
    """The hop probe's record, and the engine it ran."""
    data = feeds.fig8_sequence() if data is None else data
    engine = feeds.make_engine_for(data, chunk=chunk, device=device)
    feed, _ = feeds._stage_chunks(data, chunk, engine.device)
    feeds._init_engine_at(engine, data, jitter)
    feeds._run_pipeline(engine, feed, deferred=True)
    raw = np.stack(engine.raw_traj)[:, :3, 3]
    gt = data["gt_p"][: len(raw)]
    st = np.asarray(engine.scan_stamps)
    n = engine.kf.n
    kf_st = engine.kf.stamps[:n].cpu().numpy().astype(np.float64)
    idx = np.clip(np.searchsorted(st, kf_st), 0, len(st) - 1)
    hop_est = np.diff(raw[idx], axis=0)
    hop_gt = np.diff(gt[idx], axis=0)
    err = np.linalg.norm(hop_est - hop_gt, axis=1)
    out = {
        "n_hops": int(len(err)),
        "hop_err_med_m": round(float(np.median(err)), 5),
        "hop_err_p90_m": round(float(np.percentile(err, 90)), 5),
        "hop_err_max_m": round(float(np.max(err)), 5),
        "hop_len_med_m": round(float(np.median(np.linalg.norm(hop_gt, axis=1))), 3),
    }
    return out, engine


def probe_no_init(device=None, data=None, raw_pts: int = feeds.RAW_PTS, num_ds: int = 8192):
    """The no-init probe's record, and the rollout's positions ``(S, 3)``
    and per-scan errors unrounded."""
    data = feeds.get_sequence() if data is None else data
    ctx = feeds.make_rollout(data, raw_pts=raw_pts, num_ds=num_ds, device=device)
    _, aux = ctx["roll"](ctx["identity_state"](), ctx["scans"], ctx["imus"])
    ps = aux["p"].cpu().numpy()
    R0, p0 = data["R0"], data["p0"]
    gt_local = (data["gt_p"][: ctx["S"]] - p0) @ R0  # R0.T @ (p - p0)
    err = np.linalg.norm(ps - gt_local, axis=1)
    out = {
        "per_scan_err": [round(float(e), 4) for e in err],
        "ate_all": round(float(np.sqrt(np.mean(err ** 2))), 4),
        "ate_skip5": round(float(np.sqrt(np.mean(err[5:] ** 2))), 4),
        "ate_skip10": round(float(np.sqrt(np.mean(err[10:] ** 2))), 4),
    }
    return out, {"p": ps, "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="both", choices=("both", "hop", "noinit"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.which in ("both", "hop"):
        print(json.dumps(probe_per_hop(dev)[0]), flush=True)
    if args.which in ("both", "noinit"):
        print(json.dumps(probe_no_init(dev)[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
