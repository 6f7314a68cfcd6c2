"""The point-to-plane ICP step's row reads and normal equations: the CUDA
kernels ``csrc/p2pl.cu``, their plain PyTorch versions, and the dispatch
between them.

For N source points ``ps`` (moved by the current pose) and their nearest
destination points ``nn_idx`` at squared distance ``nn_d2``, the weights
and the 6 x 6 Gauss-Newton system of ``loop/icp.py: icp_align_p2pl``
(the JAX package's ``corr_weights`` and ``step``)::

    corr = src_mask & (nn_d2 < max_d2) & nvalid[nn_idx]
    w    = corr & (nn_d2 <= thr)        (w = corr without a trim threshold)
    r    = n . (ps - q),  a = [ps x n, n],  n = dst_normals[nn_idx], q = dst[nn_idx]
    G    = sum w a a^T,   b = sum w a r

On the point-to-plane path this is the redesign of the row gather
``table[idx]`` that stood in for the Pallas TPU kernels
``scripts/exp_assoc_kernels.py: exp_a_int_indexing`` and
``exp_b_fori_dynamic_slice``: :func:`normal_eq` is one launch instead of
three row gathers and the dozen tensor operations of the residuals, the
rows and the two products; a trimmed step first launches
:func:`corr_keys` (``corr`` and the trim's sort keys ``where(corr, nn_d2,
BIG)``). The indices follow ``table[idx]``'s rule (a negative index wraps
once, the rest clamps). Each function launches its kernel for CUDA tensors
(or raises) and runs the plain version only for tensors on the CPU; there
is no fallback from one to the other.

On the card the kernel sums in a fixed order of its own (bit for bit from
run to run; no float atomics), the plain version's matmul in cuBLAS's:
``chip_smoke.py`` holds ``G`` and ``b`` to :data:`TOLERANCE` of their
largest entries.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .gather_cuda import SECTOR, gather_rows_ref, sector_bytes

KERNEL = {
    "name": "p2pl_normal_eq",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/p2pl.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice), on the point-to-plane ICP path",
}

BIG = 1.0e12  # the trim's sort key of a point without a correspondence
TERMS = 27  # the kernel's partial row: G's upper triangle (21), then b (6)
# the card check's limit of |kernel - plain| against the largest |entry| of
# G and of b (the two sum in different orders)
TOLERANCE = 1e-5

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("p2pl")
    fn = lib.p2pl_normal_eq_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, ll, ll, ctypes.c_float, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.p2pl_corr_keys_launch.argtypes = [p, p, p, p, ll, ll, ctypes.c_float, p, p, p]
        lib.p2pl_corr_keys_launch.restype = ctypes.c_int
        lib.p2pl_partial_rows.argtypes = [ll]
        lib.p2pl_partial_rows.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and t.shape[k] != s for k, s in enumerate(shape)):
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_points(nn_idx, nn_d2, src_mask, nvalid):
    """The per-point inputs of both kernels; returns ``(n, m)``."""
    _check("nn_idx", nn_idx, torch.int32, (None,))
    n = nn_idx.shape[0]
    _check("nn_d2", nn_d2, torch.float32, (n,))
    _check("src_mask", src_mask, torch.bool, (n,))
    _check("nvalid", nvalid, torch.bool, (None,))
    m = nvalid.shape[0]
    if m == 0:
        raise ValueError("the destination is empty")
    dev = nn_idx.device
    if dev.type != "cuda" or any(t.device != dev for t in (nn_d2, src_mask, nvalid)):
        raise ValueError("the p2pl kernels need all tensors on one CUDA device")
    return n, m


def corr_keys_cuda(nn_idx, nn_d2, src_mask, nvalid, max_d2: float):
    """``(corr (N,) bool, key (N,) float32)``: the correspondences and the
    trim's sort keys ``where(corr, nn_d2, BIG)``; ``nn_idx`` int32,
    ``nvalid (M,)`` bool. CUDA tensors only."""
    global launches
    n, m = _check_points(nn_idx, nn_d2, src_mask, nvalid)
    dev = nn_idx.device
    corr = torch.empty((n,), dtype=torch.bool, device=dev)
    key = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _lib().p2pl_corr_keys_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(nn_idx.data_ptr(), nn_d2.data_ptr(), src_mask.data_ptr(), nvalid.data_ptr(),
                 m, n, float(np.float32(max_d2)), corr.data_ptr(), key.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"p2pl corr_keys kernel launch failed: cudaError {err}")
    launches += 1
    return corr, key


def normal_eq_cuda(ps, nn_idx, nn_d2, src_mask, dst, dst_normals, nvalid, max_d2: float,
                   thr=None):
    """``(G (6, 6), b (6,))`` of the step's weighted rows (see the module
    docstring); ``thr`` a 1-element float32 tensor (the trim threshold) or
    None. CUDA tensors only."""
    global launches
    n, m = _check_points(nn_idx, nn_d2, src_mask, nvalid)
    _check("ps", ps, torch.float32, (n, 3))
    _check("dst", dst, torch.float32, (m, 3))
    _check("dst_normals", dst_normals, torch.float32, (m, 3))
    if thr is not None:
        _check("thr", thr, torch.float32, (1,))
    dev = nn_idx.device
    if any(t.device != dev for t in (ps, dst, dst_normals)) or (
            thr is not None and thr.device != dev):
        raise ValueError("the p2pl kernels need all tensors on one CUDA device")
    lib = _lib()
    partial = torch.empty((lib.p2pl_partial_rows(n), TERMS), dtype=torch.float32, device=dev)
    out = torch.empty((42,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.p2pl_normal_eq_launch(
            ps.data_ptr(), nn_idx.data_ptr(), nn_d2.data_ptr(), src_mask.data_ptr(),
            dst.data_ptr(), dst_normals.data_ptr(), nvalid.data_ptr(), m, n,
            float(np.float32(max_d2)), None if thr is None else thr.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"p2pl normal_eq kernel launch failed: cudaError {err}")
    launches += 1
    return out[:36].view(6, 6), out[36:]


def _corr_ref(nn_idx, nn_d2, src_mask, nvalid, max_d2: float):
    return src_mask & (nn_d2 < max_d2) & (gather_rows_ref(nvalid, nn_idx) != 0)


def corr_keys_ref(nn_idx, nn_d2, src_mask, nvalid, max_d2: float):
    """Plain version of :func:`corr_keys_cuda`."""
    corr = _corr_ref(nn_idx, nn_d2, src_mask, nvalid, max_d2)
    return corr, torch.where(corr, nn_d2, BIG)


def normal_eq_ref(ps, nn_idx, nn_d2, src_mask, dst, dst_normals, nvalid, max_d2: float,
                  thr=None):
    """Plain version of :func:`normal_eq_cuda`: the row reads, the residuals
    and rows, and the two products."""
    corr = _corr_ref(nn_idx, nn_d2, src_mask, nvalid, max_d2)
    w = (corr if thr is None else corr & (nn_d2 <= thr)).to(torch.float32)
    nrm = gather_rows_ref(dst_normals, nn_idx)
    q = gather_rows_ref(dst, nn_idx)
    r = torch.sum(nrm * (ps - q), dim=-1)
    A = torch.cat([torch.linalg.cross(ps, nrm, dim=-1), nrm], dim=-1)  # (N, 6)
    Aw = A * w[:, None]
    return A.T @ Aw, Aw.T @ r


def corr_keys(nn_idx, nn_d2, src_mask, nvalid, max_d2: float):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = corr_keys_cuda if nn_idx.is_cuda else corr_keys_ref
    return fn(nn_idx, nn_d2, src_mask, nvalid, max_d2)


def normal_eq(ps, nn_idx, nn_d2, src_mask, dst, dst_normals, nvalid, max_d2: float,
              thr=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = normal_eq_cuda if nn_idx.is_cuda else normal_eq_ref
    return fn(ps, nn_idx, nn_d2, src_mask, dst, dst_normals, nvalid, max_d2, thr)


def hbm_bytes(nn_idx_np, live_np, w_np, m: int) -> int:
    """HBM bytes one :func:`normal_eq` must move: the 21 contiguous bytes a
    point (point, index, distance, mask), the distinct sectors of the
    neighbours' 1-byte flags where the point is ``live`` (masked in and
    within ``max_d2``), those of the neighbours' point and normal rows
    where its weight ``w`` is 1, and the 42-word output."""
    i = nn_idx_np.astype(np.int64)
    i = np.clip(np.where(i < 0, i + m, i), 0, m - 1)
    flags = np.unique(i[live_np] // SECTOR).size * SECTOR
    rows = i[w_np]
    return len(i) * 21 + flags + (2 * sector_bytes(rows, 3) if rows.size else 0) + 42 * 4
