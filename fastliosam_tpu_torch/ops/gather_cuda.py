"""Row gather ``table[idx]``: the CUDA kernel ``csrc/gather.cu``, its plain
PyTorch version, and the dispatch between them.

Port of the Pallas TPU kernels ``scripts/exp_assoc_kernels.py:
exp_a_int_indexing`` and ``exp_b_fori_dynamic_slice`` (both compute
``table[idx]``). The gather experiments run it (``scripts/exp_gather.py``,
``microbench_gather.py``, ``profile_insert.py``'s gather stages); no
engine path does. There its reads live in the kernels that consume the
rows: the association's in ``ops/assoc_cuda.py``, the cached-plane
query's in ``ops/query_cuda.py``, the insert's in ``ops/insert_cuda.py``,
the plane refresh's in ``ops/plane_fit_cuda.py`` and the point-to-plane
ICP's in ``ops/p2pl_cuda.py``. The plain version :func:`gather_rows_ref`
is the row read of all their plain versions.
:func:`gather_rows` launches the kernel for CUDA tensors (or raises) and
runs the plain version only for tensors on the CPU; there is no fallback
from one to the other.

Index rule (JAX's for ``table[idx]``): a negative index wraps once
(``-1`` -> ``C-1``) and what is still out of range clamps to ``[0, C-1]``.
Rows whose ``valid`` is false come out as zeros.

Lanes (the batched rollout's lane-major map): with ``lane_major``, the table
is ``(B, C)`` or ``(B, C, D)``, one table per lane, and ``idx`` is ``(B,
...)``; lane b's indices read lane b's table, the index rule applied within
the lane, all lanes in one launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.segment import lane_rows
from . import build

KERNEL = {
    "name": "gather_rows",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/gather.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice)",
}

launches = 0  # kernel launches since the last reset (see reset_launches)

_WORD_TYPES = (torch.float32, torch.int32)
_INDEX_TYPES = (torch.int32, torch.int64)
SECTOR = 32  # bytes: the unit in which the card reads HBM


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("gather")
    fn = lib.gather_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _valid_mask(valid, idx):
    if valid is not None and (valid.dtype != torch.bool or valid.shape != idx.shape):
        raise ValueError(f"valid must be bool of the index shape {tuple(idx.shape)}")


def gather_rows_cuda(table, idx, valid=None, lane_major: bool = False):
    """``out[r] = table[idx[r]]`` (zero where ``valid`` is false) for a
    ``(C,)`` or ``(C, D)`` float32/int32 table and int32/int64 indices of
    any shape; with ``lane_major``, a ``(B, C)`` or ``(B, C, D)`` table and
    ``(B, ...)`` indices (see the module docstring). CUDA tensors only;
    output shape ``idx.shape + table.shape[1:]`` (``[2:]`` lane-major)."""
    global launches
    lanes, rows = (table.shape[0], table.shape[1:]) if lane_major else (1, table.shape)
    if table.dtype not in _WORD_TYPES or len(rows) not in (1, 2) or lanes == 0:
        raise ValueError(f"table must be {'(B, C) or (B, C, D)' if lane_major else '(C,) or (C, D)'}"
                         f" float32/int32, got {tuple(table.shape)} {table.dtype}")
    if lane_major and (idx.dim() == 0 or idx.shape[0] != lanes):
        raise ValueError(f"idx must have the table's {lanes} lanes first, got {tuple(idx.shape)}")
    if idx.dtype not in _INDEX_TYPES:
        raise ValueError(f"idx must be int32 or int64, got {idx.dtype}")
    _valid_mask(valid, idx)
    if not table.is_contiguous() or not idx.is_contiguous() or (
            valid is not None and not valid.is_contiguous()):
        raise ValueError("table, idx and valid must be contiguous")
    dev = table.device
    if dev.type != "cuda" or idx.device != dev or (valid is not None and valid.device != dev):
        raise ValueError("gather_rows_cuda needs all tensors on one CUDA device")
    c = rows[0]
    if c == 0:
        raise ValueError("cannot gather from an empty table")
    d = rows[1] if len(rows) == 2 else 1
    out = torch.empty(tuple(idx.shape) + tuple(rows[1:]), dtype=table.dtype,
                      device=dev)
    fn = _lib().gather_rows_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), c, d, lanes, idx.data_ptr(), int(idx.dtype == torch.int64),
                 idx.numel(), None if valid is None else valid.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {err}")
    launches += 1
    return out


def gather_rows_ref(table, idx, valid=None, lane_major: bool = False):
    """Plain version: wrap negative indices once, clamp, index (within the
    lane, lane-major), zero the invalid rows."""
    c = table.shape[1] if lane_major else table.shape[0]
    i = idx.to(torch.int64)
    i = torch.clamp(torch.where(i < 0, i + c, i), 0, c - 1)
    if lane_major:
        out = table.reshape((-1,) + tuple(table.shape[2:]))[lane_rows(i, c)]
    else:
        out = table[i]
    if valid is not None:
        keep = valid.reshape(tuple(valid.shape) + (1,) * (out.dim() - valid.dim()))
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def gather_rows(table, idx, valid=None, lane_major: bool = False):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if table.is_cuda:
        return gather_rows_cuda(table, idx, valid, lane_major)
    return gather_rows_ref(table, idx, valid, lane_major)


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


def hbm_bytes(idx_np, d: int, c: int, valid=None, idx_itemsize=None) -> int:
    """HBM bytes a row gather of ``d``-word rows from a ``c``-row table must
    move: the distinct 32-byte sectors of the rows it reads (after the
    index rule), the index (and mask) read and the output write."""
    i = idx_np.astype(np.int64)
    i = np.clip(np.where(i < 0, i + c, i), 0, c - 1)
    if valid is not None:
        i = i[valid]
    n = len(idx_np)
    return (sector_bytes(i, d) + n * (idx_itemsize or idx_np.itemsize)
            + (n if valid is not None else 0) + n * d * 4)
