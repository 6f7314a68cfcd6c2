"""Speed-of-light accounting for the odometry step (port of
``scripts/roofline_odom.py``).

    python -m fastliosam_tpu_torch.scripts.roofline_odom [--raw-pts 32768] [--num-ds 8192]
        [--reps 30] [--chip h100] [--device cpu] [--out FILE]

One ``odom_step`` at the bench's shapes (``eval/feeds.py: make_rollout`` on
the odometry feed's first scan: merged3, a 2^19-slot map) is counted,
timed and set against the chip's bandwidth and float32 rates. The JAX
script reads XLA's cost analysis of the compiled step; the eager port has
none, so it counts one step itself, on the state the timed steps start
from (after one warm step):

* bytes (``xla_bytes_accessed``, the JAX script's key): the input and
  output bytes of every PyTorch operation of the step, as XLA counts
  operand plus output bytes per HLO (a ``TorchDispatchMode``; views and
  bare allocations move nothing), plus, on the card, each hand-written
  kernel's HBM bytes from the formula its kernel check uses
  (``ops/*_cuda.py: hbm_bytes``): a ctypes launch is invisible to the
  dispatch mode, which sees only its output allocations;
* flops: ``torch.utils.flop_counter.FlopCounterMode`` for the matrix
  products, plus one flop per output element of every other
  floating-point operation that computes (not a copy, gather, scatter,
  concatenation or fill); the kernels' own arithmetic is not counted;
* ``io_bytes_per_step``: the tensors of the step's output (state and aux)
  and of its scan and IMU inputs, as the JAX script counts them. The
  port's state keeps the scan counter and the initialized flag on the host,
  so they add nothing.

Then ``--reps`` steps from that state on the same scan, on the host clock
ending in ``torch.cuda.synchronize()`` (``measured_ms``). ``PEAKS``: the
H100's 3.35 TB/s HBM3 and 67 TFLOP/s float32 outside the tensor cores (SXM
data sheet), and a CPU ballpark for relative numbers only. Prints one JSON
line with the JAX script's keys, the card's name and power limit
(``card``) and the bytes each kernel moved (``kernel_bytes``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..eval import feeds
from ..utils.device import resolve_device

PEAKS = {
    # chip: (memory bytes per second, float32 flops per second)
    "h100": (3.35e12, 67e12),
    "cpu": (50e9, 1e12),  # ballpark, for relative numbers only
}

# operations that move no bytes: allocations and aliases
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "_unsafe_view", "lift_fresh", "detach", "alias", "set_"}
# operations that move, select or order data and compute no new value
_NO_FLOPS = {"copy_", "clone", "_to_copy", "cat", "stack", "index", "index_select", "gather",
             "index_put", "index_put_", "index_copy", "index_copy_", "scatter", "scatter_",
             "masked_select", "fill", "fill_", "zero_", "zeros", "ones", "full", "zeros_like",
             "ones_like", "full_like", "new_zeros", "new_ones", "new_full", "arange",
             "lift_fresh_copy", "_local_scalar_dense", "flip", "roll", "repeat",
             "constant_pad_nd", "slice_scatter", "select_scatter", "nonzero", "sort",
             "argsort", "topk", "unique", "_unique2", "index_fill", "index_fill_",
             "scalar_tensor", "_pin_memory"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) NamedTuple, tuple or dict."""
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


class _Traffic(TorchDispatchMode):
    """Operand plus output bytes of every operation, and one flop per
    output element of the floating-point operations that compute."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.elem_flops = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        outs = _tensors(out)
        self.ops += 1
        self.bytes += tree_bytes((args, kwargs)) + tree_bytes(outs)
        if (func.overloadpacket not in flop_registry and name not in _NO_FLOPS
                and any(t.is_floating_point() for t in outs)):
            self.elem_flops += sum(t.numel() for t in outs if t.is_floating_point())
        return out


@contextlib.contextmanager
def kernel_traffic():
    """Inside, each launch of the kernels the odometry step runs (merged3:
    the association and the insert) adds its HBM bytes (``ops/*_cuda.py:
    hbm_bytes``) to the yielded ``{kernel: bytes}``."""
    from ..ops import assoc_cuda, insert_cuda

    counts = {}

    def add(name, formula):
        # the formula's own reads and arithmetic are not the step's: counted
        # with every dispatch mode (this module's, the flop counter) off
        with _disable_current_modes():
            counts[name] = counts.get(name, 0) + int(formula())

    def assoc(fp, moments, pools, coords0, mask, voxel_size, probes):
        out = saved["assoc"](fp, moments, pools, coords0, mask, voxel_size, probes)
        add("merged_moments", lambda: assoc_cuda.hbm_bytes(fp, pools, coords0, probes))
        return out

    def insert(fp, coords, moments, xyz, mask, voxel_size, rounds, maxp):
        with _disable_current_modes():
            fp_np = fp.cpu().numpy()  # the fingerprints before
        out = saved["insert"](fp, coords, moments, xyz, mask, voxel_size, rounds, maxp)
        add("insert_claim",
            lambda: insert_cuda.hbm_bytes(fp_np, xyz, mask, out[2], voxel_size, rounds))
        return out

    slots = {"assoc": (assoc_cuda, "merged_moments_cuda", assoc),
             "insert": (insert_cuda, "insert_claim_cuda", insert)}
    saved = {k: getattr(mod, attr) for k, (mod, attr, _) in slots.items()}
    for mod, attr, fn in slots.values():
        setattr(mod, attr, fn)
    try:
        yield counts
    finally:
        for k, (mod, attr, _) in slots.items():
            setattr(mod, attr, saved[k])


def count_step(step, state, scan, imu) -> dict:
    """The counts of one ``step(state, scan, imu)``, and its result."""
    on_card = scan.xyz.is_cuda
    with contextlib.ExitStack() as stack:
        kernels = stack.enter_context(kernel_traffic()) if on_card else {}
        fc = stack.enter_context(FlopCounterMode(display=False))
        tr = stack.enter_context(_Traffic())
        new_state, aux = step(state, scan, imu)
    return {"flops": float(fc.get_total_flops() + tr.elem_flops),
            "matmul_flops": float(fc.get_total_flops()), "elementwise_flops": float(tr.elem_flops),
            "op_bytes": float(tr.bytes), "kernel_bytes": dict(kernels),
            "bytes": float(tr.bytes + sum(kernels.values())), "ops": tr.ops,
            "io_bytes": float(tree_bytes((new_state, aux)) + tree_bytes((scan, imu))),
            "result": (new_state, aux)}


def measure(dev, raw_pts: int = feeds.RAW_PTS, num_ds: int = 8192, reps: int = 30,
            chip: str = "h100", data=None) -> dict:
    """The roofline record (see the module docstring)."""
    from ..odom import ImuBatch, Scan
    from ..odom.pipeline import odom_step
    from ..utils.precision import geometry_precision

    data = feeds.get_sequence() if data is None else data
    ctx = feeds.make_rollout(data, raw_pts=raw_pts, num_ds=num_ds, device=dev)
    odom_cfg, map_cfg = ctx["odom_cfg"], ctx["map_cfg"]
    dt = float(np.float32(data["scan_dt"]))
    scan0 = Scan(*(t[0] for t in ctx["scans"]))
    imu0 = ImuBatch(*(t[0] for t in ctx["imus"]))

    def step(st, scan, imu):
        return odom_step(st, scan, imu, dt, odom_cfg, map_cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with geometry_precision():
        st, _ = step(ctx["gt_state"](), scan0, imu0)  # warm
        counted = count_step(step, st, scan0, imu0)
        st = counted.pop("result")[0]
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            st, aux = step(st, scan0, imu0)
        sync()
        t_step = (time.perf_counter() - t0) / reps
        finite = bool(torch.isfinite(aux["p"]).all())
    hbm_bw, f32_fl = PEAKS[chip]
    flops, raw_bytes, io_bytes = counted["flops"], counted["bytes"], counted["io_bytes"]
    t_flops = flops / f32_fl
    t_hbm_xla = raw_bytes / hbm_bw
    t_hbm_io = io_bytes / hbm_bw
    sol = max(t_flops, t_hbm_io)
    return {
        "metric": "odom_step_roofline",
        "backend": dev.type,
        "chip": chip,
        "raw_pts": raw_pts,
        "num_ds_points": num_ds,
        "flops_per_step": flops,
        "xla_bytes_accessed": raw_bytes,
        "io_bytes_per_step": io_bytes,
        "measured_ms": round(t_step * 1e3, 3),
        "roofline_flops_ms": round(t_flops * 1e3, 3),
        "roofline_xla_bytes_ms": round(t_hbm_xla * 1e3, 3),
        "roofline_io_bytes_ms": round(t_hbm_io * 1e3, 3),
        "bound": "flops" if t_flops > t_hbm_xla else "memory",
        "pct_of_xla_bytes_roofline": round(100 * t_hbm_xla / t_step, 1),
        "speed_of_light_ms": round(sol * 1e3, 3),
        "matmul_flops": counted["matmul_flops"],
        "elementwise_flops": counted["elementwise_flops"],
        "op_bytes": counted["op_bytes"],
        "kernel_bytes": counted["kernel_bytes"],
        "counted_ops": counted["ops"],
        "finite": finite,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--raw-pts", type=int, default=feeds.RAW_PTS)
    ap.add_argument("--num-ds", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--chip", default="h100", choices=sorted(PEAKS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rec = measure(dev, args.raw_pts, args.num_ds, args.reps, args.chip)
    if dev.type == "cuda":
        from ..utils.timing import card_line

        rec["card"] = card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
