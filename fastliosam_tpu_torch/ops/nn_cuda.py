"""Fused brute-force nearest neighbours: the CUDA kernel ``csrc/nn.cu``, its
plain PyTorch version, and the dispatch between them.

Port of the Pallas TPU kernel ``fastliosam_tpu/ops/nn_pallas.py:
nearest_neighbors_pallas``. :func:`nearest_neighbors` launches the kernel
for CUDA tensors (or raises) and runs the plain version only for tensors
on the CPU; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_BIG = 1.0e12

KERNEL = {
    "name": "nearest_neighbors",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/nn.cu",
    "replaces": "fastliosam_tpu/ops/nn_pallas.py:100",
}

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("nn")
    fn = lib.nn_launch
    if fn.argtypes is None:
        lib.nn_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.nn_plan.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_points(name, t):
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name} must be (N, 3) float32, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def slice_plan(n: int, m: int) -> tuple[int, int]:
    """``(slices, slice_len)``: how the kernel splits ``m`` destinations for
    ``n`` sources (slice ``s`` holds indices ``[s * slice_len, (s + 1) *
    slice_len)``). Needs the built kernel library."""
    slice_len = ctypes.c_int()
    slices = _lib().nn_plan(n, m, ctypes.byref(slice_len))
    return slices, slice_len.value


def nearest_neighbors_cuda(src, dst, dst_mask):
    """For each ``src (N, 3)`` point: ``(idx (N,) int32, d2 (N,) float32)``
    of its nearest valid ``dst (M, 3)`` point. CUDA tensors only."""
    global launches
    _check_points("src", src)
    _check_points("dst", dst)
    if dst_mask.dtype != torch.bool or dst_mask.shape != (dst.shape[0],):
        raise ValueError("dst_mask must be (M,) bool")
    if not dst_mask.is_contiguous():
        raise ValueError("dst_mask must be contiguous")
    dev = src.device
    if dev.type != "cuda" or dst.device != dev or dst_mask.device != dev:
        raise ValueError("nearest_neighbors_cuda needs all tensors on one CUDA device")
    n, m = src.shape[0], dst.shape[0]
    slices, slice_len = slice_plan(n, m)
    # scratch: the packed destinations and each slice's (d2, idx) per source
    packed = torch.empty((slices * slice_len, 4), dtype=torch.float32, device=dev)
    part_d = torch.empty((slices, n), dtype=torch.float32, device=dev)
    part_i = torch.empty((slices, n), dtype=torch.int32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().nn_launch(src.data_ptr(), n, dst.data_ptr(), dst_mask.data_ptr(), m,
                               slices, slice_len, packed.data_ptr(), part_d.data_ptr(),
                               part_i.data_ptr(), idx.data_ptr(), d2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nn kernel launch failed: cudaError {err}")
    launches += 1
    return idx, d2


def _nearest_raw(src, dst, dst_mask, chunk: int = 2048):
    """The plain version's unclamped ``(idx, d2)``: what the kernel merges
    across its destination slices before it clamps."""
    n, m = src.shape[0], dst.shape[0]
    dev = src.device
    pad = (-m) % chunk
    dstp = torch.cat([dst, torch.full((pad, 3), 1e6, dtype=dst.dtype, device=dev)])
    maskp = torch.cat([dst_mask, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    src_n2 = torch.sum(src * src, dim=-1)
    best_d2 = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    for d0 in range(0, dstp.shape[0], chunk):
        dc = dstp[d0: d0 + chunk]
        mc = maskp[d0: d0 + chunk]
        dot = src @ dc.T
        d2 = src_n2[:, None] + torch.sum(dc * dc, dim=-1)[None, :] - 2.0 * dot
        d2 = torch.where(mc[None, :], d2, _BIG)
        cmin, carg = torch.min(d2, dim=1)
        better = cmin < best_d2
        best_d2 = torch.where(better, cmin, best_d2)
        best_idx = torch.where(better, carg.to(torch.int32) + d0, best_idx)
    return best_idx, best_d2


def nearest_neighbors_ref(src, dst, dst_mask, chunk: int = 2048):
    """Plain version (mirrors ``fastliosam_tpu/loop/icp.py:
    nearest_neighbors``): destinations in chunks with a running (min,
    argmin); ties to the lowest index, masked destinations count as 1e12,
    padding points sit at 1e6, d2 clamped to >= 0."""
    idx, d2 = _nearest_raw(src, dst, dst_mask, chunk)
    return idx, torch.clamp(d2, min=0.0)


def nearest_neighbors(src, dst, dst_mask, chunk: int = 2048):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if src.is_cuda:
        return nearest_neighbors_cuda(src, dst, dst_mask)
    return nearest_neighbors_ref(src, dst, dst_mask, chunk)
