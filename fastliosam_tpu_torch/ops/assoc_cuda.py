"""The voxel-hash association's merged moments: the CUDA kernel
``csrc/assoc.cu``, its plain PyTorch version, and the dispatch between
them.

For each query, the moment sums ``[tot_c, tot_s (3), tot_o (3x3)]`` of the
voxels of every pool, each found by fingerprint probing and re-referenced
to the query voxel's centre: what ``map/voxel_hash.py: _merged_fit`` fits
its plane to. On the association path this is the redesign of the row
gathers that stood in for the Pallas TPU kernels
``scripts/exp_assoc_kernels.py: exp_a_int_indexing`` and
``exp_b_fori_dynamic_slice``: one launch per association instead of
``pools x (probes + 1)`` gathers and the tensor operations around them.
:func:`merged_moments` launches the kernel for CUDA tensors (or raises)
and runs the plain version only for tensors on the CPU; there is no
fallback from one to the other.

Lanes (the batched rollout, ``eval/batch_eval.py``): a lane-major map
(``fp (B, C)``, ``moments (B, C, 10)``) with ``(B, n)`` queries (``pools
(P, B, n, 3)``, ``coords0 (B, n, 3)``, ``mask (B, n)``) is one launch over
the B·n queries, each probing only its own lane's table; lane b's rows
equal the unbatched call's on lane b's table, bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.voxel import voxel_center
from . import build
from .gather_cuda import gather_rows_ref
from .query_cuda import find_slots_ref

KERNEL = {
    "name": "merged_moments",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/assoc.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice), on the association path",
}

MAX_POOLS = 8
MAX_PROBES = 8

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("assoc")
    fn = lib.merged_moments_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and t.shape[k] != s for k, s in enumerate(shape)):
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def merged_moments_cuda(fp, moments, pools, coords0, mask, voxel_size: float, probes: int):
    """``(N, 13)`` float32 ``[tot_c, tot_s (3), tot_o (9, row-major)]`` of
    the ``pools (P, N, 3)`` voxels found in the map ``fp (C,)`` /
    ``moments (C, 10)``, re-referenced to the centre of ``coords0 (N, 3)``,
    for the queries where ``mask (N,)`` holds; lane-major with ``fp (B,
    C)`` (see the module docstring). CUDA tensors only."""
    global launches
    lead = tuple(fp.shape[:-1])  # () or (B,)
    lanes = fp.shape[0] if lead else 1
    c = fp.shape[-1] if fp.dim() in (1, 2) else 0
    _check("fp", fp, torch.int32, lead + (None,))
    if c == 0 or c & (c - 1) or c > 1 << 31 or lanes == 0:
        raise ValueError(f"fp must be (C,) or (B, C), C a power of two, got {tuple(fp.shape)}")
    _check("moments", moments, torch.float32, lead + (c, 10))
    _check("pools", pools, torch.int32, (None,) + lead + (None, 3))
    p, n = pools.shape[0], pools.shape[-2]
    if not 1 <= p <= MAX_POOLS:
        raise ValueError(f"pools must hold 1..{MAX_POOLS} pools, got {p}")
    _check("coords0", coords0, torch.int32, lead + (n, 3))
    _check("mask", mask, torch.bool, lead + (n,))
    if not 1 <= probes <= MAX_PROBES:
        raise ValueError(f"probes must be in 1..{MAX_PROBES}, got {probes}")
    dev = fp.device
    if dev.type != "cuda" or any(t.device != dev for t in (moments, pools, coords0, mask)):
        raise ValueError("merged_moments_cuda needs all tensors on one CUDA device")
    if moments.data_ptr() % 8:
        raise ValueError("moments must be 8-byte aligned (rows are read as float2)")
    out = torch.empty(lead + (n, 13), dtype=torch.float32, device=dev)
    fn = _lib().merged_moments_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(fp.data_ptr(), moments.data_ptr(), c, lanes, pools.data_ptr(), p, lanes * n,
                 coords0.data_ptr(), mask.data_ptr(), float(np.float32(voxel_size)),
                 int(probes), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"merged_moments kernel launch failed: cudaError {err}")
    launches += 1
    return out


def merged_moments_ref(fp, moments, pools, coords0, mask, voxel_size: float, probes: int):
    """Plain version: per pool, ``probes`` fingerprint reads (first match
    in probe order, only where ``mask`` holds), the moment read (zeros
    where nothing matched), and the re-referenced sums in the order the
    kernel keeps; lane-major with ``fp (B, C)``, lane by lane the
    unbatched sums."""
    moms = []
    for coords in pools:
        slots, found = find_slots_ref(fp, coords, mask, probes)
        # 0 where not found
        moms.append(gather_rows_ref(moments, slots, valid=found, lane_major=fp.dim() == 2))
    return rereferenced_sums(moms, pools, coords0, voxel_size)


def rereferenced_sums(moms, pools, coords0, voxel_size: float):
    """``(..., 13)`` ``[count, Σ (3), Σ outer (3x3)]``: the moment rows
    ``moms`` (one ``(..., 10)`` per pool voxel, zeros where none matched)
    shifted from each pool voxel's centre to the query voxel's centre and
    summed over the pools in the order the kernel keeps."""
    lead = tuple(coords0.shape[:-1])  # (n,) or (B, n)
    dev = coords0.device
    c0 = voxel_center(coords0, voxel_size)
    tot_c = torch.zeros(lead, dtype=torch.float32, device=dev)
    tot_s = torch.zeros(lead + (3,), dtype=torch.float32, device=dev)
    tot_o = torch.zeros(lead + (3, 3), dtype=torch.float32, device=dev)
    for mom, coords in zip(moms, pools):
        ci = mom[..., 0]
        si = mom[..., 1:4]
        xx, xy, xz, yy, yz, zz = mom[..., 4:10].unbind(-1)
        oi = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(lead + (3, 3))
        # shift moments from neighbour centre c_i to the query voxel centre
        dc = voxel_center(coords, voxel_size) - c0
        tot_c = tot_c + ci
        tot_s = tot_s + si + ci[..., None] * dc
        cross = si[..., :, None] * dc[..., None, :]
        tot_o = (
            tot_o
            + oi
            + cross
            + cross.transpose(-1, -2)
            + ci[..., None, None] * (dc[..., :, None] * dc[..., None, :])
        )
    return torch.cat([tot_c[..., None], tot_s, tot_o.reshape(lead + (9,))], dim=-1)


def merged_moments(fp, moments, pools, coords0, mask, voxel_size: float, probes: int):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if fp.is_cuda:
        return merged_moments_cuda(fp, moments, pools, coords0, mask, voxel_size, probes)
    return merged_moments_ref(fp, moments, pools, coords0, mask, voxel_size, probes)
