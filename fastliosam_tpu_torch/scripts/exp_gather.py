"""Gather experiments through the port's CUDA kernels: the Pallas parts of
``scripts/exp_assoc_kernels.py`` (experiments A and B, the row gather
``table[idx]``) and of ``scripts/exp_pallas_gather.py`` (the three 2-D
``take_along_axis`` forms), at their shapes.

    python -m fastliosam_tpu_torch.scripts.exp_gather [--device cuda] [--reps 10]

Each experiment draws a fresh index set for every timed rep (as the JAX
scripts' ``timeit_fresh`` does), checks the kernel against its plain
version bit for bit, and times the kernel, the plain version and one
PyTorch library call that computes the same function (``index_select``,
``gather``) with CUDA events around back-to-back device work
(``utils/timing.py``). The bound counts the HBM bytes the call must
move: the 32-byte sectors the indexed elements touch, the index read and
the output write. On the CPU (``--device cpu``) the plain versions run and
nothing is timed. Prints one line per experiment.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import gather_cuda, take_along_cuda
from ..utils.device import resolve_device
from ..utils.timing import device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SECTOR = 32


def experiments(c: int = 1 << 19, n: int = 8192, small_c: int = 1 << 14,
                tal=(4096, 64, 128), tal1=(8, 512)):
    """The JAX scripts' shapes (defaults), or smaller ones for a quick run."""
    return [
        {"name": "A_int_indexing", "kind": "rows", "table": (c, 16), "n": n,
         "replaces": "scripts/exp_assoc_kernels.py:61"},
        {"name": "B_fori_dynamic_slice", "kind": "rows", "table": (small_c, 16), "n": n,
         "replaces": "scripts/exp_assoc_kernels.py:92,116"},
        {"name": "tal_axis0", "kind": "take", "table": (tal[0], tal[2]),
         "idx": (tal[1], tal[2]), "axis": 0, "replaces": "scripts/exp_pallas_gather.py:92"},
        {"name": "tal_axis1", "kind": "take", "table": tal1, "idx": tal1, "axis": 1,
         "replaces": "scripts/exp_pallas_gather.py:122"},
        {"name": "tal_big", "kind": "take", "table": (c, 128), "idx": (n, 128), "axis": 0,
         "replaces": "scripts/exp_pallas_gather.py:152"},
    ]


def _bits(t):
    return t.contiguous().view(torch.int32)


def sector_bytes(idx_np, row_words: int, col=None, cols: int = 1) -> int:
    """Bytes of the distinct 32-byte sectors that the indexed 4-byte
    elements touch: whole rows of ``row_words`` words for a row gather, or
    element ``(idx, col)`` of a ``cols``-wide table for take_along."""
    if col is None:
        start = idx_np.astype(np.int64).reshape(-1) * row_words * 4
        first, last = start // SECTOR, (start + row_words * 4 - 1) // SECTOR
        span = last - first
        sectors = np.unique(np.concatenate(
            [first[span >= k] + k for k in range(int(span.max()) + 1)]))
        return int(sectors.size) * SECTOR
    addr = (idx_np.astype(np.int64) * cols + col) * 4
    return int(np.unique(addr // SECTOR).size) * SECTOR


def _one(exp, dev, reps: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tab_np = rng.normal(size=exp["table"]).astype(np.float32)
    table = torch.from_numpy(tab_np).to(dev)
    if exp["kind"] == "rows":
        extent, shape = exp["table"][0], (exp["n"],)
    else:
        extent, shape = exp["table"][exp["axis"]], exp["idx"]
    # index sets drawn as the JAX scripts draw them: uniform in range
    idx_np = [np.random.default_rng(s).integers(0, extent, size=shape).astype(np.int32)
              for s in range(reps)]
    idx = [torch.from_numpy(a).to(dev) for a in idx_np]
    idx64 = [i.to(torch.int64) for i in idx]  # the library calls take int64
    if exp["kind"] == "rows":
        def kernel(i):
            return gather_cuda.gather_rows(table, i)

        def plain(i):
            return gather_cuda.gather_rows_ref(table, i)

        def library(i):
            return torch.index_select(table, 0, i)

        d = exp["table"][1]
        nbytes = sector_bytes(idx_np[0], d) + idx_np[0].nbytes + exp["n"] * d * 4
    else:
        axis = exp["axis"]

        def kernel(i):
            return take_along_cuda.take_along_axis(table, i, axis)

        def plain(i):
            return take_along_cuda.take_along_axis_ref(table, i, axis)

        def library(i):
            return torch.gather(table, axis, i)

        cols = exp["table"][1]
        if axis == 0:
            col = np.broadcast_to(np.arange(shape[1])[None, :], shape)
            gathered = sector_bytes(idx_np[0], 1, col=col, cols=cols)
        else:
            rows = np.broadcast_to(np.arange(shape[0])[:, None], shape)
            gathered = sector_bytes(rows, 1, col=idx_np[0], cols=cols)
        nbytes = gathered + idx_np[0].nbytes + int(np.prod(shape)) * 4
    got, want = kernel(idx[0]), plain(idx[0])
    equal = bool(torch.equal(_bits(got), _bits(want)))
    lib_equal = bool(torch.equal(_bits(library(idx64[0])), _bits(want)))
    rec = {"name": exp["name"], "replaces": exp["replaces"], "table": list(exp["table"]),
           "idx": list(shape), "equal": equal, "library_equal": lib_equal,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "ms": None, "plain_ms": None, "library_ms": None, "device": dev.type}
    if dev.type == "cuda":
        rec["ms"] = device_ms(kernel, [(i,) for i in idx])
        rec["plain_ms"] = device_ms(plain, [(i,) for i in idx])
        rec["library_ms"] = device_ms(library, [(i,) for i in idx64])
    return rec


def run(device=None, reps: int = 10, seed: int = 0, exps=None, print_fn=print) -> list[dict]:
    """Run every experiment; returns one record per experiment and prints
    one line each. Raises if a kernel disagrees with its plain version."""
    dev = resolve_device(device)
    out = []
    for k, exp in enumerate(exps or experiments()):
        rec = _one(exp, dev, reps, seed + k)
        out.append(rec)
        if rec["ms"] is None:
            timing = "not timed on the CPU"
        else:
            timing = (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                      f"library {rec['library_ms']:.4f} ms, "
                      f"bound {rec['bound_ms']:.5f} ms (HBM bytes)")
        print_fn(f"{rec['name']}: table {tuple(rec['table'])} idx {tuple(rec['idx'])}: "
                 f"equal={rec['equal']} library_equal={rec['library_equal']}, {timing}")
        if not (rec["equal"] and rec["library_equal"]):
            raise AssertionError(f"{rec['name']}: kernel and plain version disagree")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=10, help="fresh index sets timed")
    ap.add_argument("--json", action="store_true", help="print the records as JSON too")
    args = ap.parse_args(argv)
    recs = run(args.device, reps=args.reps)
    if args.json:
        print(json.dumps(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
