"""Gather experiments through the port's CUDA kernels: the Pallas parts of
``scripts/exp_assoc_kernels.py`` (experiments A and B, the row gather
``table[idx]``) and of ``scripts/exp_pallas_gather.py`` (the three 2-D
``take_along_axis`` forms), at their shapes.

    python -m fastliosam_tpu_torch.scripts.exp_gather [--device cuda] [--reps 10]
    python -m fastliosam_tpu_torch.scripts.exp_gather --lanes [--reps 200] [--turns 4]

Each experiment draws a fresh index set for every timed rep (as the JAX
scripts' ``timeit_fresh`` does), checks the kernel against its plain
version bit for bit, and times the kernel, the plain version and one
PyTorch library call that computes the same function (``index_select``,
``gather``) with CUDA events around back-to-back device work
(``utils/timing.py``). The bound counts the HBM bytes the call must
move: the 32-byte sectors the indexed elements touch, the index read and
the output write. On the card a ceiling probe follows the map-size
``take_along_axis``: as many random 4-byte reads from a buffer of the same
256 MB, and nothing else (no index read), the rate random sectors reach
from HBM. On the CPU (``--device cpu``) the plain versions run, nothing is
timed and the probe is skipped. Prints one line per experiment.

``--lanes`` runs one other experiment instead: the batched rollout's
lane-major row gather (``gather_rows(..., lane_major=True)`` of an (8, 2^19,
10) float32 table at (8, 8192) int64 slots) against ``torch.gather`` of the
same rows, timed in turns (kernel, library, library, kernel, ...) over
``--reps`` fresh slot sets each, so that a drift of the card's clock falls
on both alike.

``--xla`` runs the XLA parts of the two JAX scripts instead (:func:`run_xla`),
on the same tables and index draws: ``exp_c_onehot_mxu``
(``exp_assoc_kernels.py:136``: the one-hot (N, 1024) x (1024, 512·16)
product, then ``take_along_axis`` within the row group; exact only without
TF32, which the script turns off), ``exp_d_probe_windows`` (:166: a 4-row
window read as one strided-view gather against 4 row gathers, which must be
equal), and the timings of ``exp_pallas_gather.py:39-77``: the (C,16),
(C,10), (C,128) and (C,) row gathers, 15 chained (C,) gathers (the float
read cast to int32 toward zero, as XLA's convert does) and the (C,16)
scatter-add, here the fixed-order sums of ``core/segment.py`` (no float
``index_add_``: its atomics change the sums' last bits from run to run).
The gathers go through the port's row gather (``gather_rows``) and
``take_along_axis``, timed beside ``index_select``; on the card every
gather's result equals the same function's on the CPU bit for bit.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core.segment import scatter_add
from ..ops import gather_cuda, take_along_cuda
from ..ops.gather_cuda import SECTOR, sector_bytes
from ..utils.device import resolve_device
from ..utils.precision import geometry_precision
from ..utils.timing import device_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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


def ceiling_probe(dev, words: int, n: int, reps: int, seed: int = 0) -> dict:
    """Time :func:`ops.take_along_cuda.random_read_probe`: ``n`` random
    4-byte reads from a ``words``-long float32 buffer (fresh positions per
    rep). Its bound counts the distinct sectors read and the output."""
    buf = torch.zeros((words,), dtype=torch.float32, device=dev)
    seeds = [seed + r for r in range(reps)]
    ms = device_ms(lambda s: take_along_cuda.random_read_probe(buf, n, s), [(s,) for s in seeds])
    pos = take_along_cuda.random_read_positions(n, words, seeds[0])
    nbytes = int(np.unique(pos // (SECTOR // 4)).size) * SECTOR + n * 4
    return {"name": "tal_big_ceiling_probe", "buffer_words": words, "reads": n, "ms": ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "achieved_bytes_per_s": nbytes / (ms * 1e-3), "device": dev.type}


def lane_gather_turns(device=None, reps: int = 200, turns: int = 4, lanes: int = 8,
                      c: int = 1 << 19, d: int = 10, n: int = 8192, seed: int = 0) -> dict:
    """The lane-major row gather against ``torch.gather`` in turns (see the
    module docstring); each turn's mean device time over ``reps`` fresh slot
    sets. Raises if the three reads differ."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(lanes, c, d)).astype(np.float32)).to(dev)
    slots = [torch.from_numpy(rng.integers(0, c, size=(lanes, n))).to(dev) for _ in range(reps)]
    wide = [s[..., None].expand(-1, -1, d) for s in slots]
    got = gather_cuda.gather_rows(table, slots[0], lane_major=True)
    if not (torch.equal(_bits(got), _bits(gather_cuda.gather_rows_ref(table, slots[0],
                                                                        lane_major=True)))
            and torch.equal(_bits(got), _bits(torch.gather(table, 1, wide[0])))):
        raise AssertionError("lane gather: kernel, plain version and torch.gather differ")
    rec = {"name": "lane_rows", "table": [lanes, c, d], "idx": [lanes, n], "reps": reps,
           "device": dev.type, "kernel_ms": [], "library_ms": []}
    if dev.type != "cuda":
        return rec
    for t in range(turns):
        for who in (("kernel", "library") if t % 2 == 0 else ("library", "kernel")):
            if who == "kernel":
                rec["kernel_ms"].append(device_ms(
                    lambda s: gather_cuda.gather_rows(table, s, lane_major=True),
                    [(s,) for s in slots]))
            else:
                rec["library_ms"].append(device_ms(lambda i: torch.gather(table, 1, i),
                                                   [(i,) for i in wide]))
    rec["kernel_mean_ms"] = float(np.mean(rec["kernel_ms"]))
    rec["library_mean_ms"] = float(np.mean(rec["library_ms"]))
    rec["faster"] = "kernel" if rec["kernel_mean_ms"] < rec["library_mean_ms"] else "library"
    return rec


def run(device=None, reps: int = 10, seed: int = 0, exps=None, print_fn=print) -> list[dict]:
    """Run every experiment (and, on the card, the ceiling probe beside the
    map-size take_along_axis); returns one record per experiment and prints
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
        if exp["name"] == "tal_big" and dev.type == "cuda":
            words = int(np.prod(exp["table"]))
            probe = ceiling_probe(dev, words, int(np.prod(exp["idx"])), reps, seed + k)
            out.append(probe)
            print_fn(f"{probe['name']}: {probe['reads']} random 4-byte reads from "
                     f"{words * 4 >> 20} MB: {probe['ms']:.4f} ms, "
                     f"{probe['achieved_bytes_per_s'] / 1e12:.3f} TB/s of distinct sectors "
                     f"(bound {probe['bound_ms']:.5f} ms)")
    return out


# ---------------------------------------------------------------------------
# the XLA parts of scripts/exp_assoc_kernels.py and scripts/exp_pallas_gather.py
# ---------------------------------------------------------------------------
def onehot_gather(table, idx, c1: int, c2: int):
    """``exp_c_onehot_mxu``'s two-level gather: the one-hot ``(N, c1)``
    product with the table as ``(c1, c2 * D)`` picks each query's row group,
    ``take_along_axis`` its row within the group. Equals ``table[idx]``
    when the product is exact (no TF32)."""
    d = table.shape[1]
    g1 = idx // c2
    onehot = (torch.arange(c1, dtype=torch.int32, device=idx.device)[None, :]
              == g1[:, None]).to(torch.float32)
    groups = onehot @ table.reshape(c1, c2 * d)
    within = ((idx % c2)[:, None] * d
              + torch.arange(d, dtype=torch.int32, device=idx.device)[None, :])
    return take_along_cuda.take_along_axis(groups, within.to(torch.int32), 1)


def window_rows(table, idx):
    """``exp_d_probe_windows``' window: rows ``idx .. idx + 3`` of each
    query as one gather from a strided view of overlapping 4-row windows
    (the JAX script's ``vmap`` of ``dynamic_slice``; ``idx`` <= C - 4)."""
    c, d = table.shape
    return torch.as_strided(table, (c - 3, 4, d), (d, d, 1))[idx.to(torch.int64)]


def four_gathers(table, idx):
    """The same rows as four row gathers (indices wrap at C)."""
    c = table.shape[0]
    return torch.stack([gather_cuda.gather_rows(table, (idx + k) & (c - 1))
                        for k in range(4)], 1)


def chained_gather(table1d, idx, links: int = 15):
    """``links`` dependent gathers of a ``(C,)`` table, as one association's
    probe chain: ``x = (int32(table[x]) ^ (x + k)) & (C - 1)``; the cast
    truncates toward zero."""
    c = table1d.shape[0]
    x = idx
    for k in range(links):
        x = (gather_cuda.gather_rows(table1d, x).to(torch.int32) ^ (x + k)) & (c - 1)
    return x


def scatter_rows(table, idx, n: int):
    """The (C, D) scatter-add of ``table[:n]`` at ``idx`` into zeros, summed
    in the fixed order of ``core/segment.py``."""
    return scatter_add(idx, table[:n], table.shape[0])


def xla_tables(c: int, seed: int = 0) -> dict:
    """The two JAX scripts' tables, drawn as they draw them: the (C,16)
    table of ``exp_assoc_kernels.py``; ``exp_pallas_gather.py``'s (C,16),
    (C,10), (C,128) and (C,) tables from one generator in that order."""
    rng = np.random.default_rng(seed)
    out = {"assoc16": rng.normal(size=(c, 16)).astype(np.float32)}
    rng = np.random.default_rng(seed)
    for name, shape in (("t16", (c, 16)), ("t10", (c, 10)), ("t128", (c, 128)), ("t1d", (c,))):
        out[name] = rng.normal(size=shape).astype(np.float32)
    return out


def xla_indices(seed: int, n: int, cap: int) -> np.ndarray:
    """The JAX scripts' ``mk_idx``: ``n`` uniform int32 indices below ``cap``."""
    return np.random.default_rng(seed).integers(0, cap, size=(n,)).astype(np.int32)


def run_xla(device=None, reps: int = 10, c: int = 1 << 19, n: int = 8192, c1: int = 1024,
            c2: int = 512, seed: int = 0, print_fn=print) -> list[dict]:
    """The XLA experiments (module docstring), one record each: the port's
    route timed (``ms``) beside ``index_select`` where it computes the same
    rows (``library_ms``), on the card also ``equal_cpu`` (the same
    function on the CPU, bit for bit). Raises where ``exp_c`` is not exact,
    the window differs from the four gathers, or a card gather differs
    from the CPU's."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    host = xla_tables(c, seed)
    tabs = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    cpu_tabs = {k: torch.from_numpy(v) for k, v in host.items()}

    def idx_sets(k: int, mask: int = -1):
        return [torch.from_numpy(xla_indices(s, n, c) & mask).to(dev) for s in range(k)]

    specs = [  # name, replaces, function (table name, idx) -> out, library or None, sets
        ("exp_c_onehot_mxu", "scripts/exp_assoc_kernels.py:136", "assoc16",
         lambda t, i: onehot_gather(t, i, c1, c2), None, min(reps, 3), -1),
        ("exp_d_window", "scripts/exp_assoc_kernels.py:170", "assoc16", window_rows, None,
         min(reps, 5), c - 5),
        ("exp_d_four_gathers", "scripts/exp_assoc_kernels.py:176", "assoc16", four_gathers,
         None, min(reps, 5), c - 5),
        ("gather_c16", "scripts/exp_pallas_gather.py:51", "t16", gather_cuda.gather_rows,
         True, reps, -1),
        ("gather_c10", "scripts/exp_pallas_gather.py:53", "t10", gather_cuda.gather_rows,
         True, reps, -1),
        ("gather_c128", "scripts/exp_pallas_gather.py:55", "t128", gather_cuda.gather_rows,
         True, reps, -1),
        ("gather_c", "scripts/exp_pallas_gather.py:57", "t1d", gather_cuda.gather_rows,
         True, reps, -1),
        ("chained_15", "scripts/exp_pallas_gather.py:61-65", "t1d", chained_gather, None,
         reps, -1),
        ("scatter_add_c16", "scripts/exp_pallas_gather.py:71-72", "t16",
         lambda t, i: scatter_rows(t, i, n), None, reps, -1),
    ]
    out = []
    with geometry_precision():  # the one-hot product is exact only in full float32
        for name, replaces, tab, fn, library, k, mask in specs:
            sets = idx_sets(k, mask)
            table = tabs[tab]
            got = fn(table, sets[0])
            rec = {"name": name, "replaces": replaces, "table": list(table.shape), "n": n,
                   "device": dev.type, "ms": None, "library_ms": None, "equal_cpu": None}
            if cuda:
                rec["ms"] = device_ms(lambda i: fn(table, i), [(i,) for i in sets])
                if library:
                    rec["library_ms"] = device_ms(
                        lambda i: torch.index_select(table, 0, i),
                        [(i.to(torch.int64),) for i in sets])
                want = fn(cpu_tabs[tab], sets[0].cpu())
                rec["equal_cpu"] = bool(torch.equal(_bits(got.cpu()), _bits(want)))
            out.append(rec)
        # the JAX scripts' checks: exp_c on index set 7 against the plain
        # gather, exp_d on set 3 (masked to C - 5) against the four gathers
        t, i7 = tabs["assoc16"], torch.from_numpy(xla_indices(7, n, c)).to(dev)
        exact = bool(torch.equal(_bits(onehot_gather(t, i7, c1, c2)),
                                 _bits(gather_cuda.gather_rows(t, i7))))
        i3 = torch.from_numpy(xla_indices(3, n, c) & (c - 5)).to(dev)
        window_equal = bool(torch.equal(_bits(window_rows(t, i3)), _bits(four_gathers(t, i3))))
    out[0]["exact"] = exact
    out[1]["equal_four_gathers"] = window_equal
    for rec in out:
        timing = ("not timed on the CPU" if rec["ms"] is None else
                  f"{rec['ms']:.4f} ms" + ("" if rec["library_ms"] is None
                                           else f", index_select {rec['library_ms']:.4f} ms"))
        extra = "".join(f", {k}={rec[k]}" for k in ("exact", "equal_four_gathers", "equal_cpu")
                        if rec.get(k) is not None)
        print_fn(f"{rec['name']} ({rec['replaces']}): table {tuple(rec['table'])} x {n}: "
                 f"{timing}{extra}")
    bad = [r["name"] for r in out if r["equal_cpu"] is False and r["name"] != "scatter_add_c16"]
    if not exact or not window_equal or bad:
        raise AssertionError(f"XLA experiments: exact={exact}, window equal={window_equal}, "
                             f"card differs from the CPU: {bad}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=10, help="fresh index sets timed")
    ap.add_argument("--json", action="store_true", help="print the records as JSON too")
    ap.add_argument("--lanes", action="store_true",
                    help="time the lane-major row gather against torch.gather instead")
    ap.add_argument("--turns", type=int, default=4, help="--lanes: timed turns of each")
    ap.add_argument("--xla", action="store_true",
                    help="run the XLA experiments (one-hot, windows, gathers, scatter) instead")
    args = ap.parse_args(argv)
    if args.lanes:
        print(json.dumps(lane_gather_turns(args.device, reps=args.reps, turns=args.turns)))
        return 0
    if args.xla:
        recs = run_xla(args.device, reps=args.reps)
        if args.json:
            print(json.dumps(recs))
        return 0
    recs = run(args.device, reps=args.reps)
    if args.json:
        print(json.dumps(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
