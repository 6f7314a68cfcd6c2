"""The voxel-hash map insert's probe-and-claim rounds: the CUDA kernel
``csrc/insert.cu``, its plain PyTorch version, and the dispatch between
them.

For a masked batch of points: each point's voxel, its slot found or
claimed over ``rounds`` synchronous match-or-claim rounds (the highest
point index wins an empty slot), the new fingerprint and coordinate
tables, and each point's moment-update row ``[1, rel, outer6(rel)] * w``
(``w`` = assigned and the voxel not yet saturated): everything
``map/voxel_hash.py: insert`` does before its moment scatter. On the map
insert path this is the redesign of the row gathers that stood in for the
Pallas TPU kernels ``scripts/exp_assoc_kernels.py: exp_a_int_indexing``
and ``exp_b_fori_dynamic_slice``: one claim-table memset and one launch
per insert instead of ~220 small device operations. :func:`insert_claim`
launches the kernel for CUDA tensors (or raises) and runs the plain
version only for tensors on the CPU; there is no fallback from one to the
other.

Lanes (the batched rollout, ``eval/batch_eval.py``): a lane-major map
(``fp (B, C)``, ``coords (B, C, 3)``, ``moments (B, C, 10)``) with ``(B,
n)`` points is one cooperative launch over the B·n points; each lane
probes, bids and claims in its own table only, so lane b's tables, slots
(lane-local, ``C`` where unassigned), update rows and drop count (one per
lane, ``(B,)``) are the unbatched call's on lane b's table, bit for bit.
The launch raises where the B·n points do not fit one cooperative grid;
it is never split.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.segment import lane_rows
from ..core.voxel import fingerprint, hash_slot, voxel_center, voxel_coords
from . import build
from .gather_cuda import gather_rows_ref, sector_bytes

KERNEL = {
    "name": "insert_claim",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/insert.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice), on the map insert path",
}

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("insert")
    fn = lib.insert_claim_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, p, p, ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_float, p, p, p, p, p,
        ]
        fn.restype = ctypes.c_int
        lib.insert_claim_grid.argtypes = [ctypes.c_longlong, p, p]
        lib.insert_claim_grid.restype = ctypes.c_int
        lib.grid_sync_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int, p]
        lib.grid_sync_probe_launch.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and t.shape[k] != s for k, s in enumerate(shape)):
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def insert_claim_cuda(fp, coords, moments, xyz, mask, voxel_size: float, rounds: int,
                      max_points_per_voxel: float):
    """``(fp, coords, sl, upd, n_dropped)`` of inserting ``xyz (N, 3)``
    where ``mask (N,)`` holds into the map ``fp (C,)`` / ``coords (C, 3)`` /
    ``moments (C, 10)``: new tables (the inputs stay untouched), each
    point's slot (``C`` where unassigned, int64), its ``(N, 10)`` moment
    update and the 0-dim int32 count of masked points left unassigned;
    lane-major with ``fp (B, C)`` and ``xyz (B, N, 3)`` (see the module
    docstring). CUDA tensors only."""
    fp_new, coords_new = fp.clone(), coords.clone()
    return (fp_new, coords_new) + insert_claim_into(
        fp_new, coords_new, moments, xyz, mask, voxel_size, rounds, max_points_per_voxel)


def insert_claim_into(fp, coords, moments, xyz, mask, voxel_size: float, rounds: int,
                      max_points_per_voxel: float):
    """The launch of :func:`insert_claim_cuda` with the tables ``fp`` and
    ``coords`` updated in place; returns ``(sl, upd, n_dropped)``. The
    launch zeroes its claim table, then runs the kernel, both on the
    current stream."""
    global launches
    lead = tuple(fp.shape[:-1])  # () or (B,)
    lanes = fp.shape[0] if lead else 1
    c = fp.shape[-1] if fp.dim() in (1, 2) else 0
    _check("fp", fp, torch.int32, lead + (None,))
    if c == 0 or c & (c - 1) or lanes == 0 or lanes * c > 1 << 31:
        raise ValueError(f"fp must be (C,) or (B, C), C a power of two, B * C <= 2^31, "
                         f"got {tuple(fp.shape)}")
    _check("coords", coords, torch.int32, lead + (c, 3))
    _check("moments", moments, torch.float32, lead + (c, 10))
    _check("xyz", xyz, torch.float32, lead + (None, 3))
    n = xyz.shape[-2]
    _check("mask", mask, torch.bool, lead + (n,))
    if lanes * n >= (1 << 31) - 1:
        raise ValueError(f"too many points for one launch: {lanes * n}")
    if int(rounds) < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    dev = fp.device
    if dev.type != "cuda" or any(t.device != dev for t in (coords, moments, xyz, mask)):
        raise ValueError("insert_claim_cuda needs all tensors on one CUDA device")
    sl = torch.empty(lead + (n,), dtype=torch.int64, device=dev)
    upd = torch.empty(lead + (n, 10), dtype=torch.float32, device=dev)
    if n == 0:
        return sl, upd, torch.zeros(lead, dtype=torch.int32, device=dev)
    n_dropped = torch.empty(lead, dtype=torch.int32, device=dev)  # the kernel zeroes it
    claim = torch.empty((lanes * c,), dtype=torch.int32, device=dev)  # the launch zeroes it
    fn = _lib().insert_claim_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(fp.data_ptr(), coords.data_ptr(), moments.data_ptr(), c, lanes,
                 xyz.data_ptr(), mask.data_ptr(), lanes * n,
                 float(np.float32(1.0 / voxel_size)), float(np.float32(voxel_size)),
                 int(rounds), float(np.float32(max_points_per_voxel)), claim.data_ptr(),
                 sl.data_ptr(), upd.data_ptr(), n_dropped.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"insert_claim kernel launch failed: cudaError {err}")
    launches += 1
    return sl, upd, n_dropped


def insert_claim_grid(n: int, device=None) -> tuple[int, int]:
    """``(blocks, points per thread)`` of the kernel's cooperative grid for
    ``n`` points on the current (or given) CUDA device."""
    blocks, per_thread = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().insert_claim_grid(int(n), ctypes.byref(blocks), ctypes.byref(per_thread))
    if err != 0:
        raise RuntimeError(f"insert_claim_grid failed: cudaError {err}")
    return blocks.value, per_thread.value


def grid_sync_probe(blocks: int, syncs: int, device=None) -> None:
    """One cooperative launch of ``blocks`` x 256 threads that does
    ``syncs`` grid barriers and nothing else (the barriers' cost at the
    insert's grid; not counted as a launch of the insert)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    with torch.cuda.device(dev):
        err = _lib().grid_sync_probe_launch(int(blocks), int(syncs),
                                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid_sync_probe launch failed: cudaError {err}")


def outer6(v):
    """Upper-triangle outer product packing (..., 3) -> (..., 6)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def insert_claim_ref(fp, coords, moments, xyz, mask, voxel_size: float, rounds: int,
                     max_points_per_voxel: float):
    """Plain version: per round one fingerprint read, the adoption of a
    match, a scatter-max tournament on ``pid + 1`` for empty slots, the
    winners' integer scatter-add commit and the re-read; then the winners'
    coordinate rows, the saturation read of the old moments and the
    moment-update rows. Lane-major with ``fp (B, C)``: every table index is
    the lane's own (the claim and coordinate tables flat, lane b's rows from
    ``b * (C + 1)``, its row ``C`` taking the non-winners), lane by lane the
    unbatched result."""
    lm = fp.dim() == 2
    cap = fp.shape[-1]
    dev = xyz.device
    vc = voxel_coords(xyz, voxel_size)
    h0 = hash_slot(vc, cap).to(torch.int64)
    want = fingerprint(vc)
    lead = tuple(xyz.shape[:-1])  # (n,) or (B, n)
    n = lead[-1]
    pid1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev).expand(lead)

    def flat(idx, rows):  # rows of a flat table of ``rows`` rows a lane
        return lane_rows(idx, rows).reshape(-1) if lm else idx

    fp = fp.clone()
    fp_flat = fp.reshape(-1)  # a view: the commit below writes fp
    slots = torch.full(lead, -1, dtype=torch.int64, device=dev)
    poff = torch.zeros(lead, dtype=torch.int64, device=dev)
    won_slot = torch.full(lead, cap, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        cand = (h0 + poff) & (cap - 1)
        unassigned = (slots < 0) & mask
        cur = gather_rows_ref(fp, cand, lane_major=lm)
        slots = torch.where(unassigned & (cur == want), cand, slots)
        tryclaim = unassigned & (cur == 0)
        claim = torch.zeros((fp_flat.shape[0] // cap * (cap + 1),), dtype=torch.int32,
                            device=dev)
        ccand = flat(cand, cap + 1)
        claim.scatter_reduce_(0, ccand, torch.where(tryclaim, pid1, 0).reshape(-1), "amax")
        won = tryclaim & (claim[ccand].reshape(lead) == pid1)
        # empty slots hold fp == 0, so adding writes exactly the winner's word
        fp_flat.index_add_(0, flat(cand, cap), (want * won.to(torch.int32)).reshape(-1))
        won_slot = torch.where(won, cand, won_slot)
        cur2 = gather_rows_ref(fp, cand, lane_major=lm)
        slots = torch.where((slots < 0) & mask & (cur2 == want), cand, slots)
        poff = torch.where(
            (slots < 0) & mask & (cur2 != 0) & (cur2 != want), poff + 1, poff
        )
    # row cap of each lane: no win
    coords_tbl = torch.cat([coords, torch.zeros_like(coords[..., :1, :])], dim=-2)
    coords_flat = coords_tbl.reshape(-1, 3)  # a view
    coords_flat[flat(won_slot, cap + 1)] = vc.reshape(-1, 3)  # winners hold unique slots
    coords_tbl = coords_tbl[..., :cap, :].contiguous()  # as the kernel's table

    assigned = (slots >= 0) & mask
    n_dropped = torch.sum(mask & ~assigned, dim=-1, dtype=torch.int32)
    sl = torch.where(assigned, slots, cap)

    # moment saturation: stop accumulating once a voxel is very full
    room = gather_rows_ref(moments, sl, lane_major=lm)[..., 0] < max_points_per_voxel
    w = (assigned & room).to(torch.float32)
    rel = xyz - voxel_center(vc, voxel_size)
    upd = torch.cat([torch.ones_like(w)[..., None], rel, outer6(rel)], dim=-1) * w[..., None]
    return fp, coords_tbl, sl, upd, n_dropped


def insert_claim(fp, coords, moments, xyz, mask, voxel_size: float, rounds: int,
                 max_points_per_voxel: float):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if fp.is_cuda:
        return insert_claim_cuda(fp, coords, moments, xyz, mask, voxel_size, rounds,
                                 max_points_per_voxel)
    return insert_claim_ref(fp, coords, moments, xyz, mask, voxel_size, rounds,
                            max_points_per_voxel)


def hbm_bytes(fp_np, xyz, mask, sl, voxel_size: float, rounds: int) -> int:
    """HBM bytes the insert must move: the distinct fingerprint sectors of
    every probe chain walked (to the slot found, or ``rounds`` long where
    none was), the sectors of the new fingerprint words and coordinate rows
    and of the old moment words read, the xyz and mask read and the sl,
    upd and n_dropped writes. ``fp_np``: the fingerprints before; ``sl``:
    the slots the insert gave."""
    c = fp_np.shape[-1]
    h0 = hash_slot(voxel_coords(xyz, voxel_size), c).to(torch.int64).cpu().numpy()
    sl, mask = sl.cpu().numpy(), mask.cpu().numpy()
    found = sl < c
    steps = np.where(found, ((sl - h0) & (c - 1)) + 1, np.where(mask, rounds, 0))
    walked = np.concatenate([(h0[steps > k] + k) & (c - 1) for k in range(int(steps.max()))])
    slots = np.unique(sl[found])
    new = slots[fp_np[slots] == 0]  # empty before: a winner wrote it
    n = len(sl)
    return (sector_bytes(walked, 1) + sector_bytes(new, 1) + sector_bytes(new, 3)
            + sector_bytes(slots * 10, 1) + n * (12 + 1) + n * (8 + 40) + 4)
