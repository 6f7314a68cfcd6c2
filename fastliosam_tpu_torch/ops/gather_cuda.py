"""Row gather ``table[idx]``: the CUDA kernel ``csrc/gather.cu``, its plain
PyTorch version, and the dispatch between them.

Port of the Pallas TPU kernels ``scripts/exp_assoc_kernels.py:
exp_a_int_indexing`` and ``exp_b_fori_dynamic_slice`` (both compute
``table[idx]``). On the engine path it is the plane refresh's read of
the moment and coordinate tables (``map/voxel_hash.py: _fit_planes``: the
loop closure's throwaway map, and the engine's map in the cached query
mode) and the point-to-plane ICP's reads of the destination rows at the
neighbours (``loop/icp.py: icp_align_p2pl``); the association's reads are
fused into ``ops/assoc_cuda.py``, the cached-plane query's into
``ops/query_cuda.py``, the insert's into ``ops/insert_cuda.py``.
:func:`gather_rows` launches the kernel for CUDA tensors (or raises) and
runs the plain version only for tensors on the CPU; there is no fallback
from one to the other.

Index rule (JAX's for ``table[idx]``): a negative index wraps once
(``-1`` -> ``C-1``) and what is still out of range clamps to ``[0, C-1]``.
Rows whose ``valid`` is false come out as zeros.
"""
from __future__ import annotations

import ctypes

import torch

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


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("gather")
    fn = lib.gather_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _valid_mask(valid, idx):
    if valid is not None and (valid.dtype != torch.bool or valid.shape != idx.shape):
        raise ValueError(f"valid must be bool of the index shape {tuple(idx.shape)}")


def gather_rows_cuda(table, idx, valid=None):
    """``out[r] = table[idx[r]]`` (zero where ``valid`` is false) for a
    ``(C,)`` or ``(C, D)`` float32/int32 table and int32/int64 indices of
    any shape. CUDA tensors only; output shape ``idx.shape + table.shape[1:]``."""
    global launches
    if table.dtype not in _WORD_TYPES or table.dim() not in (1, 2):
        raise ValueError(f"table must be (C,) or (C, D) float32/int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if idx.dtype not in _INDEX_TYPES:
        raise ValueError(f"idx must be int32 or int64, got {idx.dtype}")
    _valid_mask(valid, idx)
    if not table.is_contiguous() or not idx.is_contiguous() or (
            valid is not None and not valid.is_contiguous()):
        raise ValueError("table, idx and valid must be contiguous")
    dev = table.device
    if dev.type != "cuda" or idx.device != dev or (valid is not None and valid.device != dev):
        raise ValueError("gather_rows_cuda needs all tensors on one CUDA device")
    c = table.shape[0]
    if c == 0:
        raise ValueError("cannot gather from an empty table")
    d = table.shape[1] if table.dim() == 2 else 1
    out = torch.empty(tuple(idx.shape) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=dev)
    fn = _lib().gather_rows_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), c, d, idx.data_ptr(), int(idx.dtype == torch.int64),
                 idx.numel(), None if valid is None else valid.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {err}")
    launches += 1
    return out


def gather_rows_ref(table, idx, valid=None):
    """Plain version: wrap negative indices once, clamp, index, zero the
    invalid rows."""
    c = table.shape[0]
    i = idx.to(torch.int64)
    i = torch.clamp(torch.where(i < 0, i + c, i), 0, c - 1)
    out = table[i]
    if valid is not None:
        keep = valid.reshape(tuple(valid.shape) + (1,) * (out.dim() - valid.dim()))
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def gather_rows(table, idx, valid=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if table.is_cuda:
        return gather_rows_cuda(table, idx, valid)
    return gather_rows_ref(table, idx, valid)
