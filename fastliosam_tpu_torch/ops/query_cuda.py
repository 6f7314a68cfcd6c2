"""The voxel-hash map's cached-plane query: the CUDA kernel ``csrc/query.cu``,
its plain PyTorch version, and the dispatch between them.

For each query point, the cached plane (``normal``, ``d``, ``plane_valid``)
of the point's own voxel, found by fingerprint probing: what
``map/voxel_hash.py: query_planes`` returns (the JAX package's
``query_planes`` through ``_find_slots``). On the cached association path
this is the redesign of the row gather ``table[idx]`` that stood in for the
Pallas TPU kernels ``scripts/exp_assoc_kernels.py: exp_a_int_indexing`` and
``exp_b_fori_dynamic_slice``: one launch per query instead of ``probes``
fingerprint gathers, three row gathers and the tensor operations around
them. :func:`query_cached` launches the kernel for CUDA tensors (or raises)
and runs the plain version only for tensors on the CPU; there is no
fallback from one to the other.

Semantics (the JAX package's): the first probe round whose fingerprint
matches, where ``mask`` holds (an empty slot does not end the probe); where
nothing matched, the row of slot 0 (the clipped ``-1``), with ``valid``
false; ``valid = found & (plane_valid > 0) & mask``.

Lanes (the batched rollout's cached mode): a lane-major map (``fp (B, C)``,
``normal (B, C, 3)``, ``d (B, C)``, ``plane_valid (B, C)``) with ``(B, n)``
queries is one launch; each query reads only its own lane's table (its
slot 0 where nothing matched), lane by lane the unbatched call's words.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.voxel import fingerprint, hash_slot, voxel_coords
from . import build
from .gather_cuda import gather_rows_ref, sector_bytes

KERNEL = {
    "name": "query_cached",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/query.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice), on the cached-plane query path",
}

MAX_PROBES = 8

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("query")
    fn = lib.query_cached_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and t.shape[k] != s for k, s in enumerate(shape)):
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def query_cached_cuda(fp, normal, d, plane_valid, xyz, mask, voxel_size: float, probes: int):
    """``(normal (N, 3), d (N,), valid (N,) bool)`` of the cached planes of
    the voxels of ``xyz (N, 3)`` in the map ``fp (C,)`` / ``normal (C, 3)`` /
    ``d (C,)`` / ``plane_valid (C,)``; lane-major with ``fp (B, C)`` and
    ``xyz (B, N, 3)`` (see the module docstring). CUDA tensors only."""
    global launches
    lead = tuple(fp.shape[:-1])  # () or (B,)
    lanes = fp.shape[0] if lead else 1
    c = fp.shape[-1] if fp.dim() in (1, 2) else 0
    _check("fp", fp, torch.int32, lead + (None,))
    if c == 0 or c & (c - 1) or c > 1 << 31 or lanes == 0:
        raise ValueError(f"fp must be (C,) or (B, C), C a power of two, got {tuple(fp.shape)}")
    _check("normal", normal, torch.float32, lead + (c, 3))
    _check("d", d, torch.float32, lead + (c,))
    _check("plane_valid", plane_valid, torch.int32, lead + (c,))
    _check("xyz", xyz, torch.float32, lead + (None, 3))
    n = xyz.shape[-2]
    _check("mask", mask, torch.bool, lead + (n,))
    if not 1 <= probes <= MAX_PROBES:
        raise ValueError(f"probes must be in 1..{MAX_PROBES}, got {probes}")
    dev = fp.device
    if dev.type != "cuda" or any(t.device != dev for t in (normal, d, plane_valid, xyz, mask)):
        raise ValueError("query_cached_cuda needs all tensors on one CUDA device")
    normal_out = torch.empty(lead + (n, 3), dtype=torch.float32, device=dev)
    d_out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    valid_out = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    fn = _lib().query_cached_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(fp.data_ptr(), normal.data_ptr(), d.data_ptr(), plane_valid.data_ptr(), c,
                 lanes, xyz.data_ptr(), mask.data_ptr(), lanes * n,
                 float(np.float32(1.0 / voxel_size)),
                 int(probes), normal_out.data_ptr(), d_out.data_ptr(), valid_out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"query_cached kernel launch failed: cudaError {err}")
    launches += 1
    return normal_out, d_out, valid_out


def find_slots_ref(fp, coords, mask, probes: int):
    """The JAX package's ``_find_slots``: one fingerprint gather per probe
    round, the first match where ``mask`` holds. Returns ``(slots (int64,
    -1 where none), found)``; lane-major with ``fp (B, C)`` and ``coords
    (B, n, 3)`` (lane-local slots)."""
    cap = fp.shape[-1]
    h0 = hash_slot(coords, cap).to(torch.int64)
    want = fingerprint(coords)
    slots = torch.full(coords.shape[:-1], -1, dtype=torch.int64, device=coords.device)
    for p in range(probes):
        cand = (h0 + p) & (cap - 1)
        match = gather_rows_ref(fp, cand, lane_major=fp.dim() == 2) == want
        slots = torch.where((slots < 0) & match & mask, cand, slots)
    return slots, slots >= 0


def query_cached_ref(fp, normal, d, plane_valid, xyz, mask, voxel_size: float, probes: int):
    """Plain version: the slot probe, then the clipped reads of the cached
    plane fields (slot 0 where nothing matched; lane by lane, lane-major)."""
    slots, found = find_slots_ref(fp, voxel_coords(xyz, voxel_size), mask, probes)
    sl = torch.clamp(slots, min=0)
    lm = fp.dim() == 2
    valid = found & (gather_rows_ref(plane_valid, sl, lane_major=lm) > 0) & mask
    return (gather_rows_ref(normal, sl, lane_major=lm), gather_rows_ref(d, sl, lane_major=lm),
            valid)


def query_cached(fp, normal, d, plane_valid, xyz, mask, voxel_size: float, probes: int):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if fp.is_cuda:
        return query_cached_cuda(fp, normal, d, plane_valid, xyz, mask, voxel_size, probes)
    return query_cached_ref(fp, normal, d, plane_valid, xyz, mask, voxel_size, probes)


def hbm_bytes(fp, xyz, mask, voxel_size: float, probes: int) -> int:
    """HBM bytes the cached-plane query must move: the distinct fingerprint
    sectors of the live queries' probes, the sectors of the rows read
    (normal, d and plane_valid: three arrays; slot 0 for a miss), the xyz
    and mask read and the 17-byte output rows."""
    cap = fp.shape[-1]
    live = mask.cpu().numpy()
    coords = voxel_coords(xyz, voxel_size)
    h0 = hash_slot(coords, cap).to(torch.int64).cpu().numpy()[live]
    cand = (h0[:, None] + np.arange(probes)) & (cap - 1)
    slots, _ = find_slots_ref(fp, coords, mask, probes)
    rows = np.clip(slots.cpu().numpy(), 0, None)
    n = len(live)
    return (sector_bytes(cand.reshape(-1), 1) + sector_bytes(rows, 3) + 2 * sector_bytes(rows, 1)
            + n * 12 + n + n * 17)
