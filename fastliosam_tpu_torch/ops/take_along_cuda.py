"""2-D ``take_along_axis``: the CUDA kernel ``csrc/take_along.cu``, its plain
PyTorch version, and the dispatch between them.

Port of the Pallas TPU kernels ``scripts/exp_pallas_gather.py: pallas_tal``
(axis 0), ``pallas_tal1`` (axis 1) and ``pallas_big`` (axis 0 at map
size). Its one caller is the gather experiment entry point
(``scripts/exp_gather.py``). :func:`take_along_axis` launches the kernel
for CUDA tensors (or raises) and runs the plain version only for tensors
on the CPU.

Semantics: axis 0 gives ``out[i, j] = tab[idx[i, j], j]``, axis 1 gives
``out[i, j] = tab[i, idx[i, j]]``; ``idx`` is int32 and has the output's
shape. Out-of-range indices follow ``jnp.take_along_axis``'s default mode:
a negative index wraps once (``-1`` -> last), and an index still out of
range gives NaN (mode ``"fill"``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = {
    "name": "take_along_axis",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/take_along.cu",
    "replaces": "scripts/exp_pallas_gather.py:92 (pallas_tal), :122 (pallas_tal1), "
                ":152 (pallas_big)",
}

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("take_along")
    fn = lib.take_along_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(tab, idx, axis):
    if tab.dtype != torch.float32 or tab.dim() != 2:
        raise ValueError(f"tab must be 2-D float32, got {tuple(tab.shape)} {tab.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be 2-D int32, got {tuple(idx.shape)} {idx.dtype}")
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    other = 1 - axis
    if idx.shape[other] != tab.shape[other]:
        raise ValueError(f"idx and tab must agree on axis {other}: "
                         f"{tuple(idx.shape)} vs {tuple(tab.shape)}")


def take_along_axis_cuda(tab, idx, axis: int):
    """CUDA tensors only; returns a float32 tensor of ``idx``'s shape."""
    global launches
    _check(tab, idx, axis)
    if not tab.is_contiguous() or not idx.is_contiguous():
        raise ValueError("tab and idx must be contiguous")
    dev = tab.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError("take_along_axis_cuda needs both tensors on one CUDA device")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    fn = _lib().take_along_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(tab.data_ptr(), tab.shape[0], tab.shape[1], idx.data_ptr(),
                 idx.shape[0], idx.shape[1], axis, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"take_along kernel launch failed: cudaError {err}")
    launches += 1
    return out


def take_along_axis_ref(tab, idx, axis: int):
    """Plain version: wrap negatives once, ``torch.gather`` the in-range
    indices, NaN where still out of range."""
    _check(tab, idx, axis)
    extent = tab.shape[axis]
    k = idx.to(torch.int64)
    k = torch.where(k < 0, k + extent, k)
    inside = (k >= 0) & (k < extent)
    got = torch.gather(tab, axis, torch.where(inside, k, 0))
    return torch.where(inside, got, torch.full((), float("nan"), device=tab.device))


def take_along_axis(tab, idx, axis: int):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if tab.is_cuda:
        return take_along_axis_cuda(tab, idx, axis)
    return take_along_axis_ref(tab, idx, axis)
