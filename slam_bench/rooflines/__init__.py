"""Roofline counts of the kernels the benchmark times.

Each ``rooflines/<name>.py`` names the profiler kernel names it times
(``KERNELS``, matched as substrings) and ``need(trace)``: the bytes and
floating-point operations one launch needs at the cell's shapes, counted
from what the operation must read and write (each input byte read once,
each output byte written once), never from how today's kernel does it. A
count that depends on the data takes only what the traced window shows
(the valid points a step, ``aux["cloud_mask"]``; the points the iEKF
matched to a plane, ``aux["n_matched"]``; the points the insert left
unassigned, ``aux["n_dropped"]``) and otherwise counts the least the
operation can move, so that a share never passes 100% for a kernel that
does the work.
"""
from __future__ import annotations

import importlib
import math

# NVIDIA H100 SXM (the data sheet, at 700 W): HBM3 bandwidth and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12

POOLS = {"merged": 7, "merged2": 2, "merged3": 3}


def shapes(trace: dict) -> dict:
    """The launch shapes of the traced cell: lanes ``B``, points a lane ``n``
    (the iEKF budget), valid points a step ``V`` and points matched to a
    plane a step ``M`` (all lanes), points the insert left unassigned a
    step, and the association's pools ``P``."""
    odom = trace["config"]["odom"]
    return {"B": trace["lanes"], "n": odom["num_ds_points"], "V": trace["valid_points"],
            "M": trace["matched_points"], "dropped": trace["dropped_points"],
            "P": POOLS.get(odom["query_mode"], 1)}


def share(trace: dict, name: str):
    """The kernel's share (%) of its roofline over the traced window: the
    least time its launches need, the larger of bytes over the peak bandwidth
    and operations over the peak rate, against their profiled time. None
    where the window ran no such kernel."""
    mod = importlib.import_module(f"slam_bench.rooflines.{name}")
    count = ns = 0
    for kname, (c, t) in trace["device_ops"].items():
        if any(k in kname for k in mod.KERNELS):
            count += c
            ns += t
    if count == 0 or ns == 0:
        return None
    nbytes, flops = mod.need(shapes(trace))
    least_s = count * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)
    return 100.0 * least_s / (ns / 1e9)


def distinct_voxels_at_least(points: float) -> int:
    """The fewest 0.5 m map voxels that ``points`` downsampled points can
    touch: each is the centroid of a cell of a 0.5 m scan grid, and a map
    voxel overlaps at most 8 such cells."""
    return math.ceil(max(points, 0.0) / 8)
