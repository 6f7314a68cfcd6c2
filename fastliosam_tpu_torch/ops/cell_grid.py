"""The cell grid of the k-NN kernel's search (``csrc/knn.cu``) in plain
torch, on the card as on the CPU: the destinations' index, the queries'
cell order, and the size of the cell hash (``csrc/cell_hash.cuh``) that
one kernel fills from the index.

:func:`cell_index` lays the destinations out by cell. Fine cells have edge
``h``, set from the bounding box so that each axis spans fewer than 2^21 of
them; a point's fine key is ``floor(p / h) - floor(lo / h)`` and its Morton
code interleaves the three keys' bits. One stable sort of the codes orders
the points; the cells of level ``L`` (``2^L`` fine cells a side) are the
runs of codes that agree above their lowest ``3 L`` bits, so the sorted
codes give every level's cell count at once, and the index takes the level
whose mean occupancy is nearest ``occupancy * (k + 1)`` (at least 2).
Nothing here reads the device back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

FINE_BITS = 21  # fine cells a side: under 2^21, so a Morton code fits 63 bits
# the level's target points a cell, per neighbour asked for (k + 1 points;
# fastliosam_tpu_torch/scripts/exp_knn.py sweeps 0.25 to 4, PERF.md)
OCCUPANCY = 1.0


class CellIndex(NamedTuple):
    fparams: torch.Tensor  # (2,) float64: h, the largest |coordinate|
    iparams: torch.Tensor  # (7,) int64: fine base (3), largest fine key (3), level
    order: torch.Tensor  # (M,) the destinations' permutation into cell order
    codes: torch.Tensor  # (M,) their fine Morton codes, sorted
    points: torch.Tensor  # (M, 4) float64: x, y, z, original index, in cell order
    cell_start: torch.Tensor  # (M + 1,) cell c: points[cell_start[c]:cell_start[c + 1]]
    cell_code: torch.Tensor  # (M,) cell c's Morton code at the level (c < n_cells)
    n_cells: torch.Tensor  # 0-dim int64


def hash_capacity(n: int) -> int:
    """Slots of a cell hash for ``n`` cells: a power of two, at least 2 n."""
    return 1 << max(6, (2 * n - 1).bit_length())


def morton(keys: torch.Tensor) -> torch.Tensor:
    """Morton codes of int64 keys ``(..., 3)`` in ``[0, 2^21)``: bit b of x,
    y, z goes to bit 3 b + 2, 3 b + 1, 3 b (``csrc/knn.cu: morton3``)."""
    v = keys
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return (v[..., 0] << 2) | (v[..., 1] << 1) | v[..., 2]


def fine_scale(dst: torch.Tensor):
    """``(h, base, top, mag)``: the fine cell edge (0-dim), the fine keys'
    base ``floor(lo / h)`` and largest relative key (both ``(3,)`` int64),
    and the largest |coordinate| (0-dim). ``h`` keeps every axis under 2^21
    fine cells and every ``p / h`` under 2^40 (exact in float64)."""
    lo, hi = dst.aminmax(dim=0)
    mag = torch.maximum(lo.abs().max(), hi.abs().max())
    h = torch.maximum((hi - lo).max() / ((1 << FINE_BITS) - 4), mag * 2.0**-40).clamp(min=1e-30)
    base = torch.floor(lo / h).to(torch.int64)
    top = torch.floor(hi / h).to(torch.int64) - base
    return h, base, top, mag


def cell_index(dst: torch.Tensor, k: int, occupancy: float = OCCUPANCY) -> CellIndex:
    """The destinations ``(M, 3)`` float64 by cell (see the module's text)."""
    m, dev = dst.shape[0], dst.device
    h, base, top, mag = fine_scale(dst)
    keys = torch.floor(dst / h).to(torch.int64) - base
    codes, order = torch.sort(morton(keys), stable=True)
    # cells at level L: 1 + the adjacent pairs whose codes differ at or
    # above bit 3 L
    diff = codes[1:] ^ codes[:-1]
    bits = 3 * torch.arange(FINE_BITS, device=dev)
    cells = 1 + (diff[:, None] >= (1 << bits)).sum(0)
    target = max(2.0, occupancy * (k + 1))
    score = (torch.log(m / cells.to(torch.float64)) - math.log(target)).abs()
    # the last of equals: the coarser level (below the points' spacing every
    # level holds one point a cell)
    level = FINE_BITS - 1 - torch.argmin(score.flip(0))
    pre = codes >> (3 * level)
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = pre[1:] != pre[:-1]
    cell_of = torch.cumsum(start, 0) - 1
    # cell c's first point: the first i with cell_of[i] >= c (m from n_cells)
    cell_start = torch.searchsorted(cell_of, torch.arange(m + 1, device=dev))
    cell_code = pre.gather(0, cell_start[:m].clamp(max=m - 1))
    points = torch.cat([dst[order], order.to(torch.float64)[:, None]], 1)
    return CellIndex(torch.stack([h, mag]), torch.cat([base, top, level.view(1)]), order, codes,
                     points, cell_start, cell_code, cell_of[-1] + 1)


def query_order(src: torch.Tensor, index: CellIndex) -> torch.Tensor:
    """``(N,)`` the queries ``src (N, 3)`` in the cell order of ``index``'s
    fine grid, each key clamped onto ``[0, 2^21)`` (the order only groups
    queries that read the same cells)."""
    h, base = index.fparams[0], index.iparams[:3].to(torch.float64)
    keys = (torch.floor(src / h) - base).clamp(0, (1 << FINE_BITS) - 1).to(torch.int64)
    return torch.argsort(morton(keys), stable=True)
