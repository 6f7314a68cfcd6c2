"""Scatter-adds with a fixed summation order.

Float ``index_add_`` on CUDA sums duplicate indices with atomics, so the
order of the additions, and the last bits of every sum, change from run to
run. The JAX package is bit-for-bit deterministic, and the port is held to
the same. :func:`index_add_` replaces every float scatter-add of the port:
the indices are stable-sorted once (:func:`segment_plan`), each touched row
becomes one segment that starts with the row's current value followed by
its contributions in index order, and ``torch.segment_reduce`` sums each
segment in a fixed order on the card. On the CPU the segments are summed
sequentially, which is exactly the order ``index_add_`` uses there, so CPU
results are bit-identical to ``table.index_add_(0, index, values)``.

On the card each segment is summed by one thread, so the cost follows the
longest segment. Elements whose contribution is discarded (padding lanes
routed to a drop row) are passed as ``dead``: each becomes a segment of its
own instead of one long run.

A plan depends only on the indices, so a caller that adds several value
sets through the same indices (the PGO normal equations and every PCG
matvec of one linearization) sorts once.

Lanes (the batched rollout, ``eval/batch_eval.py``): B lane-major tables of
``rows`` rows each are one flat table, lane b's local row i its row
``b * rows + i`` (:func:`lane_rows`), and :func:`lane_plan` plans their
scatters as one. Since the sort is stable and each lane's rows are its
own, every run holds one lane's contributions in that lane's index order:
each lane's sums are the unbatched plan's on that lane, bit for bit. A
lane's drop row is its own row ``rows - 1``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_DEAD_KEY = 1 << 62  # sort key base of dead elements: after every live index


class SegmentPlan(NamedTuple):
    """Stable sort of ``n`` scatter indices into runs of equal index."""

    order: torch.Tensor  # (n,) int64: sorted position -> original position
    sidx: torch.Tensor  # (n,) int64: the indices, in sorted order
    run: torch.Tensor  # (n,) int64: run number of each sorted index
    elem_pos: torch.Tensor  # (n,) int64: slot of each contribution in the data
    head_pos: torch.Tensor  # (n,) int64: slot of each run's head (2n if none)
    lengths: torch.Tensor  # (n + 1,) int64: segment lengths


def segment_plan(index, dead=None) -> SegmentPlan:
    """Plan the scatter of ``index (n,)``; no host read. Elements where the
    bool ``dead`` holds must point at a row that no live element uses and
    whose result is never read (a drop row): they are summed alone."""
    index = index.to(torch.int64).reshape(-1)
    n = index.shape[0]
    dev = index.device
    ar = torch.arange(n, device=dev)
    key = index if dead is None else torch.where(dead.reshape(-1), _DEAD_KEY + ar, index)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = skey[1:] != skey[:-1]
    run = torch.cumsum(is_start.to(torch.int64), 0) - 1
    # data layout: run r = [head (the table row), its contributions...],
    # runs back to back, then one element for each of the n + 1 - n_runs
    # empty segments, so every segment has one more element than its run
    # and the data is exactly 2n + 1 long
    elem_pos = ar + run + 1
    head_pos = torch.where(is_start, ar + run, 2 * n)
    counts = torch.zeros((n + 1,), dtype=torch.int64, device=dev).index_add_(
        0, run, torch.ones_like(run))  # integer counts: exact in any order
    return SegmentPlan(order, index[order], run, elem_pos, head_pos, counts + 1)


def lane_rows(index, rows: int):
    """Flat rows (int64) of the lane-local rows ``index (B, ...)`` of a
    lane-major table with ``rows`` rows a lane: ``b * rows + index[b]``."""
    index = index.to(torch.int64)
    lane = torch.arange(index.shape[0], device=index.device).reshape(
        (-1,) + (1,) * (index.dim() - 1))
    return index + lane * rows


def with_drop_row(t, lane_major: bool = False):
    """``t`` plus one zero row at index ``len(t)`` that takes the writes the
    JAX package drops (``mode="drop"`` with an out-of-bounds index);
    lane-major, one such row after each lane's table and the lanes
    flattened: lane b's row i is row ``b * (C + 1) + i``."""
    if not lane_major:
        return torch.cat([t, torch.zeros_like(t[:1])])
    return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1).reshape(
        (-1,) + tuple(t.shape[2:]))


def without_drop_row(t, cap: int, lane_major: bool = False):
    """The table of :func:`with_drop_row`'s rows ``t``, the drop rows
    left out (contiguous, as the kernels take a map's fields)."""
    if not lane_major:
        return t[:cap]
    return t.reshape((-1, cap + 1) + tuple(t.shape[1:]))[:, :cap].contiguous()


def lane_plan(index, rows: int, dead=None) -> SegmentPlan:
    """:func:`segment_plan` of the lane-local rows ``index (B, n)`` of a
    lane-major table with ``rows`` rows a lane (lane b's drop row is its own
    row ``rows - 1``), for values flattened to ``(B * n, ...)``."""
    return segment_plan(lane_rows(index, rows).reshape(-1),
                        None if dead is None else dead.reshape(-1))


def index_add_(table, plan: SegmentPlan, values):
    """In place: ``table[i] += Σ values[k]`` over ``index[k] == i``, summed
    in index order (see the module docstring). ``values`` has the plan's
    ``n`` rows and ``table``'s row shape. Returns ``table``."""
    n = plan.order.shape[0]
    if n == 0:
        return table
    data = torch.empty((2 * n + 1,) + tuple(table.shape[1:]), dtype=table.dtype,
                       device=table.device)
    data[plan.elem_pos] = values[plan.order].to(table.dtype)
    # slots of the empty segments (and position 2n, where the non-heads
    # write) hold arbitrary values: those segments are never read
    data[plan.head_pos] = table[plan.sidx]
    sums = torch.segment_reduce(data, "sum", lengths=plan.lengths, unsafe=True)
    # every contribution of a run writes its run's sum: duplicates agree
    table[plan.sidx] = sums[plan.run]
    return table


def scatter_add(index, values, size: int, dead=None):
    """``zeros((size, ...)).index_add_(0, index, values)`` in the fixed
    order of :func:`index_add_`."""
    table = torch.zeros((size,) + tuple(values.shape[1:]), dtype=values.dtype,
                        device=values.device)
    return index_add_(table, segment_plan(index, dead), values)
