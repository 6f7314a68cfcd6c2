"""Narrow per-slot gathers against bucketed wide-row gathers (port of
``scripts/microbench_gather.py``).

    python -m fastliosam_tpu_torch.scripts.microbench_gather [--c 524288] [--n 8192]
        [--reps 50] [--seed 0] [--device cpu]

The JAX script's question: is a merged3 query round bound by the latency
of its random reads? ``narrow`` is one round as the map lays it out today,
3 pools x (4 fingerprint probes + 1 moment-row gather) = 15 narrow gathers
of N rows; ``bucketed`` is a 4-slot bucketed layout, 3 gathers of (N, 44
bytes) rows, each bucket's fingerprints bit-cast into its float rows;
``narrow_scatter`` is one (N, 10) moment scatter-add. Each is a function of
``(device, C, N, seed)`` that draws the JAX script's tables and indices
(C slots, N queries, ``numpy.random.default_rng(seed)`` in its order) and
returns the unreduced outputs: ``(acc (N, 10), tot (N,))`` for the
gathers (the JAX functions return their sums) and the updated moments for
the scatter. The row gathers go through the port's ``gather_rows``; the
scatter is ``core/segment.py``'s fixed-order sum (no float ``index_add_``).
``argmax`` over the bucket's match flags runs on ``uint8`` (the first
maximum, as ``jnp.argmax`` over a bool). On the card each is timed with
CUDA events over ``--reps`` back-to-back calls on the same inputs (the JAX
script's ``timeit``), at the bench's C = 2^19 slots and N = 8192 queries;
on the CPU nothing is timed. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core.segment import index_add_, segment_plan
from ..ops.gather_cuda import gather_rows
from ..utils.device import resolve_device
from ..utils.timing import device_ms


def inputs(device=None, C: int = 1 << 19, N: int = 8192, seed: int = 0) -> dict:
    """The JAX script's inputs on ``device``: fingerprints ``fp (C,)``,
    moments ``(C, 10)``, the bucket table ``(C/4, 4, 11)`` (fingerprint bit
    cast to float, then the moments), query slots ``idx (N,)`` and their
    buckets ``bid``, and the scatter's ``upd`` (ones)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fp = torch.from_numpy(rng.integers(1, 1 << 30, size=(C,), dtype=np.int32)).to(dev)
    moments = torch.from_numpy(rng.normal(size=(C, 10)).astype(np.float32)).to(dev)
    tbl = torch.cat([fp.view(torch.float32).reshape(C // 4, 4, 1),
                     moments.reshape(C // 4, 4, 10)], dim=-1).contiguous()
    idx = torch.from_numpy(rng.integers(0, C, size=(N,), dtype=np.int32)).to(dev)
    return {"fp": fp, "moments": moments, "tbl": tbl, "idx": idx, "bid": idx >> 2,
            "upd": torch.ones((N, 10), dtype=torch.float32, device=dev)}


def narrow_round(fp, moments, h0):
    """One merged3 round as laid out today: 3 pools x (4 fingerprint probes
    + 1 moment gather)."""
    C, N = fp.shape[0], h0.shape[0]
    acc = torch.zeros((N, 10), dtype=torch.float32, device=fp.device)
    tot = torch.zeros((N,), dtype=torch.int32, device=fp.device)
    for c in range(3):
        h = (h0 + c * 977) & (C - 1)
        slots = torch.full((N,), -1, dtype=torch.int32, device=fp.device)
        for p in range(4):
            cand = (h + p) & (C - 1)
            match = gather_rows(fp, cand) > (p + 1) * (1 << 27)  # an arbitrary predicate
            slots = torch.where((slots < 0) & match, cand, slots)
        sl = torch.clamp(slots, 0, C - 1)
        acc = acc + gather_rows(moments, sl) * (slots >= 0).to(torch.float32)[:, None]
        tot = tot + slots
    return acc, tot


def bucketed_round(tbl, b0):
    """The bucketed layout: 3 pools x 1 wide-row gather (fingerprints and
    moments fused)."""
    B, N = tbl.shape[0], b0.shape[0]
    flat = tbl.reshape(B, -1)
    acc = torch.zeros((N, 10), dtype=torch.float32, device=tbl.device)
    tot = torch.zeros((N,), dtype=torch.int64, device=tbl.device)
    for c in range(3):
        b = (b0 + c * 977) & (B - 1)
        row = gather_rows(flat, b).reshape(N, 4, 11)  # one gather
        fpl = row[..., 0].view(torch.int32)
        match = fpl > (c + 1) * (1 << 27)
        lane = torch.argmax(match.to(torch.uint8), dim=-1)  # the first match, 0 if none
        found = torch.any(match, dim=-1)
        mom = torch.take_along_dim(row[..., 1:], lane[:, None, None], dim=1)[:, 0, :]
        acc = acc + mom * found.to(torch.float32)[:, None]
        tot = tot + lane
    return acc, tot.to(torch.int32)


def scatter_round(moments, h0, upd):
    """``moments.at[h0].add(upd)``: the moments plus the fixed-order sums."""
    return index_add_(moments.clone(), segment_plan(h0), upd)


def narrow(device=None, C: int = 1 << 19, N: int = 8192, seed: int = 0):
    x = inputs(device, C, N, seed)
    return narrow_round(x["fp"], x["moments"], x["idx"])


def bucketed(device=None, C: int = 1 << 19, N: int = 8192, seed: int = 0):
    x = inputs(device, C, N, seed)
    return bucketed_round(x["tbl"], x["bid"])


def narrow_scatter(device=None, C: int = 1 << 19, N: int = 8192, seed: int = 0):
    x = inputs(device, C, N, seed)
    return scatter_round(x["moments"], x["idx"], x["upd"])


def run(device=None, C: int = 1 << 19, N: int = 8192, seed: int = 0, reps: int = 50) -> dict:
    """The three rounds' outputs (sums, as the JAX functions return them) and,
    on the card, their device times."""
    dev = resolve_device(device)
    x = inputs(dev, C, N, seed)
    calls = {"narrow": (narrow_round, (x["fp"], x["moments"], x["idx"])),
             "bucketed": (bucketed_round, (x["tbl"], x["bid"])),
             "narrow_scatter": (scatter_round, (x["moments"], x["idx"], x["upd"]))}
    rec = {"metric": "microbench_gather", "device": dev.type, "C": C, "N": N, "reps": reps}
    for name, (fn, args) in calls.items():
        out = fn(*args)
        if name == "narrow_scatter":
            rec[f"{name}_sum"] = float(out.sum())
        else:
            rec[f"{name}_sums"] = [float(out[0].sum()), int(out[1].to(torch.int64).sum())]
        rec[f"{name}_ms"] = device_ms(fn, [args] * reps) if dev.type == "cuda" else None
    if dev.type == "cuda":
        rec["bucketed_speedup"] = rec["narrow_ms"] / rec["bucketed_ms"]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--c", type=int, default=1 << 19, help="slots")
    ap.add_argument("--n", type=int, default=8192, help="queries a pass")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rec = run(dev, args.c, args.n, args.seed, args.reps)
    if dev.type == "cuda":
        from ..utils.timing import card_line

        rec["card"] = card_line()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
