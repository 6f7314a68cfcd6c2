"""The voxel-hash map's plane refresh: the CUDA kernel ``csrc/plane_fit.cu``,
its plain PyTorch version, and the dispatch between them.

For each slot the insert touched, the plane of that voxel fitted from its
moments and written into the cached plane fields (``normal``, ``d``,
``plane_valid``): what ``map/voxel_hash.py: insert(refresh_planes=True)``
does after its moment scatter (the JAX package's ``_fit_planes`` and its
three ``mode="drop"`` scatters). On the plane-refresh path this is the
redesign of the row gather ``table[idx]`` that stood in for the Pallas TPU
kernels ``scripts/exp_assoc_kernels.py: exp_a_int_indexing`` and
``exp_b_fori_dynamic_slice``: one launch per refresh instead of two row
gathers, the closed-form eigenvector of ``core/eigh3.py`` in plain torch
and three scatters. :func:`refresh_planes` launches the kernel for CUDA
tensors (or raises) and runs the plain version only for tensors on the
CPU; there is no fallback from one to the other.

Semantics (the JAX package's): a slot equal to the table's size ``C`` is
the insert's drop row: the plane is fitted at the clipped slot and its
write dropped, so nothing changes there. Duplicate slots write identical
values. The tables are new tensors; the inputs stay untouched.

On the card the kernel rounds each operation as the plain version's
tensor operations do there; the batched 3 x 3 matmul of the
eigenvector's column, which the plain version leaves to cuBLAS, is an
FMA chain in cuBLAS's order on an H100 (see ``csrc/plane_fit.cu``), so
the two agree bit for bit there. cuBLAS does not document that order:
``chip_smoke.py`` holds the two to :data:`TOLERANCE` (:func:`compare`)
and counts the rows that differ.

Lanes (the batched rollout's cached mode): lane-major tables (``moments
(B, C, 10)``, ``coords (B, C, 3)``, ``normal (B, C, 3)``, ``d (B, C)``,
``plane_valid (B, C)``) with ``(B, n)`` lane-local slots are one launch;
lane b's slots touch lane b's rows only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.eigh3 import smallest_eigvec3
from ..core.segment import lane_rows, with_drop_row, without_drop_row
from ..core.voxel import voxel_center
from . import build
from .gather_cuda import gather_rows_ref, sector_bytes

KERNEL = {
    "name": "refresh_planes",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/plane_fit.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice), on the plane-refresh path",
}

# the card check's limits of kernel against plain version (see compare):
# a normal's turn and d (m) times the voxel's relative eigenvalue gap, and
# how close (relative) l0 may lie to plane_var_thresh where plane_valid differs
TOLERANCE = {"normal": 1e-5, "d": 1e-5, "lam0_rel": 1e-6}

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("plane_fit")
    fn = lib.refresh_planes_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_longlong, p, p, p,
                       p, p, p, ctypes.c_float, ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and t.shape[k] != s for k, s in enumerate(shape)):
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refresh_planes_cuda(moments, coords, slots, normal, d, plane_valid, voxel_size: float,
                        min_points: float, plane_var_thresh: float):
    """``(normal, d, plane_valid)``: new tables equal to the old ones but at
    the ``slots (n,)`` (int64, ``C`` = dropped) of the map ``moments (C,
    10)`` / ``coords (C, 3)``, where the plane fitted from the slot's
    moments is written; lane-major with ``moments (B, C, 10)`` and ``slots
    (B, n)`` (see the module docstring). CUDA tensors only."""
    global launches
    lead = tuple(moments.shape[:-2])  # () or (B,)
    lanes = moments.shape[0] if lead else 1
    c = moments.shape[-2] if moments.dim() in (2, 3) else 0
    _check("moments", moments, torch.float32, lead + (None, 10))
    if c == 0 or lanes == 0:
        raise ValueError(f"moments must be (C, 10) or (B, C, 10), got {tuple(moments.shape)}")
    _check("coords", coords, torch.int32, lead + (c, 3))
    _check("slots", slots, torch.int64, lead + (None,))
    _check("normal", normal, torch.float32, lead + (c, 3))
    _check("d", d, torch.float32, lead + (c,))
    _check("plane_valid", plane_valid, torch.int32, lead + (c,))
    dev = moments.device
    if dev.type != "cuda" or any(t.device != dev for t in (coords, slots, normal, d,
                                                           plane_valid)):
        raise ValueError("refresh_planes_cuda needs all tensors on one CUDA device")
    normal_out, d_out, pv_out = (torch.empty_like(t) for t in (normal, d, plane_valid))
    fn = _lib().refresh_planes_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(moments.data_ptr(), coords.data_ptr(), c, lanes, slots.data_ptr(),
                 slots.numel(), normal.data_ptr(), d.data_ptr(), plane_valid.data_ptr(),
                 normal_out.data_ptr(), d_out.data_ptr(), pv_out.data_ptr(),
                 float(np.float32(voxel_size)), float(np.float32(min_points)),
                 float(np.float32(plane_var_thresh)), stream)
    if err != 0:
        raise RuntimeError(f"refresh_planes kernel launch failed: cudaError {err}")
    launches += 1
    return normal_out, d_out, pv_out


def unpack_sym(m6):
    """(..., 6) ``[xx, xy, xz, yy, yz, zz]`` -> (..., 3, 3) symmetric."""
    xx, xy, xz, yy, yz, zz = (m6[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def fit_planes_ref(moments, coords, slots, voxel_size: float, min_points: float,
                   plane_var_thresh: float):
    """``(normal, d, valid int32)`` of the planes fitted from the moments
    stored at ``slots`` (clipped gather; lane-major, lane-local slots)."""
    lm = moments.dim() == 3
    mom = gather_rows_ref(moments, slots, lane_major=lm)
    c = mom[..., 0]
    safe_c = torch.clamp(c, min=1.0)
    mean_rel = mom[..., 1:4] / safe_c[..., None]
    cov = unpack_sym(mom[..., 4:10]) / safe_c[..., None, None] - (
        mean_rel[..., :, None] * mean_rel[..., None, :]
    )
    normal, lam = smallest_eigvec3(cov)
    center = voxel_center(gather_rows_ref(coords, slots, lane_major=lm), voxel_size)
    mean_world = center + mean_rel
    d = -torch.sum(normal * mean_world, dim=-1)
    valid = (c >= min_points) & (lam[..., 0] < plane_var_thresh)
    return normal, d, valid.to(torch.int32)


def refresh_planes_ref(moments, coords, slots, normal, d, plane_valid, voxel_size: float,
                       min_points: float, plane_var_thresh: float):
    """Plain version: :func:`fit_planes_ref` at every slot, then the three
    scatters into copies of the tables with a drop row (see
    ``core/segment.py: with_drop_row``)."""
    lm = moments.dim() == 3
    cap = moments.shape[-2]
    nrm, dd, pv = fit_planes_ref(moments, coords, slots, voxel_size, min_points,
                                 plane_var_thresh)
    # duplicates write identical values, so the scatter is deterministic
    rows = lane_rows(slots, cap + 1) if lm else slots
    out = []
    for table, value in ((normal, nrm), (d, dd), (plane_valid, pv)):
        t = with_drop_row(table, lm)
        t[rows] = value
        out.append(without_drop_row(t, cap, lm))
    return tuple(out)


def refresh_planes(moments, coords, slots, normal, d, plane_valid, voxel_size: float,
                   min_points: float, plane_var_thresh: float):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = refresh_planes_cuda if moments.is_cuda else refresh_planes_ref
    return fn(moments, coords, slots, normal, d, plane_valid, voxel_size, min_points,
              plane_var_thresh)


def hbm_bytes(slots_np, cap: int, lanes: int = 1) -> int:
    """HBM bytes a refresh must move: the slots read, the distinct sectors
    of the moment and coordinate rows of the live slots (lane b's row s is
    ``b * C + s``), and the three tables (20 bytes a row) read once and
    written once (the new tables are copies with the slots' rows refitted)."""
    sl = np.asarray(slots_np, dtype=np.int64).reshape(lanes, -1)
    rows = (sl + np.arange(lanes)[:, None] * cap)[(sl >= 0) & (sl < cap)]
    read = sector_bytes(rows, 10) + sector_bytes(rows, 3) if rows.size else 0
    return sl.size * 8 + read + 2 * lanes * cap * 20


def compare(got, want, moments, coords, slots, voxel_size: float,
            plane_var_thresh: float) -> dict:
    """The kernel's tables ``got`` against the plain version's ``want``
    (each ``(normal, d, plane_valid)``) of one refresh at ``slots`` ((n,),
    or lane-major (B, n)). Rows the refresh did not touch must be equal bit
    for bit (copies). At the touched rows the two differ only where the
    plain version's cuBLAS matmul of the eigenvector's column (``core/
    eigh3.py: _eigvec``) rounds otherwise than the kernel's FMA chain: a
    turn of the fitted normal (or its sign, the other column of a near tie)
    that grows as 1 / g, g = min(1, (l1 - l0) / l2) of the voxel's
    covariance (float64). So ``ok`` holds where |n - s n_ref| <= normal / g
    and |d - s d_ref| <= d (1 + |centre|) / g, s the sign of n . n_ref, and
    ``plane_valid`` is equal unless l0 lies within lam0_rel of
    ``plane_var_thresh`` (:data:`TOLERANCE`). Returns ``ok`` and the counts."""
    lm = moments.dim() == 3
    cap = moments.shape[-2]
    lanes = moments.shape[0] if lm else 1

    def flat(t):
        return t.reshape((lanes * cap,) + tuple(t.shape[(2 if lm else 1):]))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    kn, kd, kv = (flat(t) for t in got)
    pn, pd, pv = (flat(t) for t in want)
    sl = slots.reshape(lanes, -1)
    lane = torch.arange(lanes, device=sl.device)[:, None] * cap
    rows = (sl + lane)[(sl >= 0) & (sl < cap)].unique()
    touched = torch.zeros(lanes * cap, dtype=torch.bool, device=sl.device)
    touched[rows] = True
    copies_equal = (torch.equal(bits(kn[~touched]), bits(pn[~touched]))
                    and torch.equal(bits(kd[~touched]), bits(pd[~touched]))
                    and torch.equal(kv[~touched], pv[~touched]))
    kn, kd, kv, pn, pd, pv = (t[rows] for t in (kn, kd, kv, pn, pd, pv))
    same = (bits(kn) == bits(pn)).all(-1) & (bits(kd) == bits(pd)) & (kv == pv)
    mom = flat(moments)[rows].double()
    c = mom[:, 0].clamp(min=1.0)
    mean = mom[:, 1:4] / c[:, None]
    cov = unpack_sym(mom[:, 4:10]) / c[:, None, None] - mean[:, :, None] * mean[:, None, :]
    lam = torch.linalg.eigvalsh(cov)
    g = ((lam[:, 1] - lam[:, 0]) / lam[:, 2].clamp(min=1e-30)).clamp(max=1.0)
    sign = torch.where((kn * pn).sum(-1) < 0, -1.0, 1.0)
    n_err = (kn - sign[:, None] * pn).abs().amax(-1).double()
    d_err = (kd - sign * pd).abs().double()
    centre = ((flat(coords)[rows].double() + 0.5) * voxel_size).norm(dim=-1)
    thresh = float(np.float32(plane_var_thresh))
    near = (lam[:, 0] - thresh).abs() <= TOLERANCE["lam0_rel"] * thresh
    ok = (bool((n_err * g <= TOLERANCE["normal"]).all())
          and bool((d_err * g <= TOLERANCE["d"] * (1.0 + centre)).all())
          and bool(((kv == pv) | near).all()))
    # the angle between the two (not unit where a column's norm fell below
    # the division's 1e-12 clamp)
    a, b = kn.double(), pn.double()
    dot = (a * b).sum(-1).abs() / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=1e-300)
    some = rows.numel() > 0
    return {"ok": ok and copies_equal, "copies_equal": copies_equal, "rows": int(rows.numel()),
            "rows_bit_for_bit": int(same.sum()), "sign_flips": int((sign < 0).sum()),
            "valid_differs": int((kv != pv).sum()),
            "max_normal_err": float(n_err.max()) if some else 0.0,
            "max_d_err": float(d_err.max()) if some else 0.0,
            "max_one_minus_dot": float((1.0 - dot).max()) if some else 0.0}
