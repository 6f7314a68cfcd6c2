"""One iteration of the cached-mode iEKF's map rows: the CUDA kernel
``csrc/cached_rows.cu``, its plain PyTorch version, and the dispatch
between them.

For each point of the scan, at the state ``(R, p)``: the optional probe of
the voxel hash (the cached-plane query), the read of the chosen slot's
cached plane, and every per-point row that the iteration's reductions read
(``odom/iekf.py``; the JAX package's ``iekf_update`` in ``query_mode=
"cached"``, ``fastliosam_tpu/odom/iekf.py:93-131``)::

    pw    = q_b @ R^T + p                     (the points in the world)
    slot  = probe ? first fingerprint match of voxel(pq) : slots   (-1: none)
    n, d  = normal[max(slot, 0)], d[max(slot, 0)]
    assoc = slot >= 0 & plane_valid[max(slot, 0)] > 0 & mask
    r     = sum(n * pw) + d,   valid = assoc & |r| < max_residual
    w     = valid / point_cov,  v = n @ R
    A     = [q_b x v, n] (+ [p_l x (v @ R_ext), v] with the extrinsic)
    Aw    = A * w,  wc = valid * (1 / point_cov) (0 unless the confident
            share's test passes),  nwc = n * wc,  n_matched = sum(valid)

``pq`` is ``pw`` or, where the caller passes ``q_query``, ``q_query @ R^T
+ p`` (the JAX package probes at the body points in the first iteration
while its rows use ``q_b``: the two differ in rounding with the extrinsic
estimated). ``probe`` is True (probe every lane), False (read the carried
``slots``) or a bool device flag per lane (the re-query gate, read by the
kernel: no host read). The matrix products that follow (``A^T Aw``,
``Aw^T r``, ``nwc^T n``) stay in torch.

On the cached path this is the redesign of ``ops/query_cuda.py:
query_cached`` (the row gather ``table[idx]`` that stood in for the
Pallas TPU kernels ``scripts/exp_assoc_kernels.py: exp_a_int_indexing``
and ``exp_b_fori_dynamic_slice``): one launch an iteration instead of the
query's launch, about twenty tensor operations of rows around it and the
re-query gate's host read. :func:`cached_rows` launches the kernel for
CUDA tensors (or raises) and runs the plain version only for tensors on
the CPU; there is no fallback from one to the other.

The kernel rounds each operation as the plain version's tensor operations
do on the card, so every output is the plain version's bit for bit
(``csrc/cached_rows.cu`` says how each rounding was matched).

Lanes (the batched rollout): a state ``R (B, 3, 3)``, ``p (B, 3)``, points
``(B, n, 3)`` and a lane-major map (``fp (B, C)``, ...) are one launch;
each point reads only its own lane's table (its slot 0 where nothing
matched), and ``n_matched`` is ``(B,)``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.voxel import voxel_coords
from . import build
from .gather_cuda import gather_rows_ref, sector_bytes
from .query_cuda import MAX_PROBES, find_slots_ref

KERNEL = {
    "name": "cached_rows",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/cached_rows.cu",
    "replaces": "scripts/exp_assoc_kernels.py:61 (exp_a_int_indexing), "
                ":92 and :116 (exp_b_fori_dynamic_slice), on the cached-mode iEKF's rows",
}

MAX_LANES = 1024  # the kernel's per-lane match counters

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


class CachedRows(NamedTuple):
    """The rows of one iteration (``K`` = 6, or 12 with the extrinsic)."""
    n: torch.Tensor  # (..., N, 3) the plane normals
    r: torch.Tensor  # (..., N) residuals
    valid: torch.Tensor  # (..., N) bool
    A: torch.Tensor  # (..., N, K) Jacobian rows
    Aw: torch.Tensor  # (..., N, K) weighted rows
    wc: torch.Tensor  # (..., N) confident weights of the degeneracy remap
    nwc: torch.Tensor  # (..., N, 3) n * wc
    n_matched: torch.Tensor  # (...) int64
    slots: torch.Tensor  # (..., N) int32 association (-1: none), carried to the next call


def _lib():
    lib = build.load("cached_rows")
    fn = lib.cached_rows_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, p,  # state, points, probe
                       p, p, p, p, ctypes.c_longlong, i, i,  # map, lanes, n
                       p, i, f, i, f, f, f,  # slots, probes, constants
                       p, p, p, p, p, p, p, p, p, p]  # outputs, stream
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and t.shape[k] != s for k, s in enumerate(shape)):
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _wc_scale(point_cov: float, degen_conf_ratio: float) -> float:
    """``wc`` of a valid point: ``(rvar < ratio * point_cov) * (1 /
    point_cov)`` at the cached mode's ``rvar`` = 0, each in float32 as the
    plain version's tensor operations take their Python scalars."""
    conf = np.float32(0.0) < np.float32(degen_conf_ratio * point_cov)
    return float(np.float32(1.0 / point_cov)) if conf else 0.0


def cached_rows_cuda(R, p, q_b, mask, table, slots, probe, voxel_size: float, probes: int,
                     point_cov: float, max_residual: float, degen_conf_ratio: float,
                     q_query=None, p_l=None, R_ext=None) -> CachedRows:
    """The rows of one iteration (see the module docstring) in one launch.
    ``table`` is the map's ``(fp, normal, d, plane_valid)``; ``slots`` the
    previous call's association (None only where ``probe`` is True);
    ``p_l`` and ``R_ext`` together add the extrinsic's columns. CUDA
    tensors only."""
    global launches
    lead = tuple(R.shape[:-2])  # () or (B,)
    lanes = R.shape[0] if lead else 1
    _check("R", R, torch.float32, lead + (3, 3))
    if len(lead) > 1 or lanes == 0 or lanes > MAX_LANES:
        raise ValueError(f"R must be (3, 3) or (B, 3, 3), 1 <= B <= {MAX_LANES}, "
                         f"got {tuple(R.shape)}")
    _check("p", p, torch.float32, lead + (3,))
    _check("q_b", q_b, torch.float32, lead + (None, 3))
    n = q_b.shape[-2]
    _check("mask", mask, torch.bool, lead + (n,))
    if q_query is not None:
        _check("q_query", q_query, torch.float32, lead + (n, 3))
    if (p_l is None) != (R_ext is None):
        raise ValueError("p_l and R_ext come together (the extrinsic's columns)")
    if p_l is not None:
        _check("p_l", p_l, torch.float32, lead + (n, 3))
        _check("R_ext", R_ext, torch.float32, lead + (3, 3))
    fp, normal, d, plane_valid = table
    _check("fp", fp, torch.int32, lead + (None,))
    c = fp.shape[-1]
    if c == 0 or c & (c - 1) or c > 1 << 31:
        raise ValueError(f"the map's capacity must be a power of two, got {c}")
    _check("normal", normal, torch.float32, lead + (c, 3))
    _check("d", d, torch.float32, lead + (c,))
    _check("plane_valid", plane_valid, torch.int32, lead + (c,))
    flag = None
    if isinstance(probe, torch.Tensor):
        _check("probe", probe, torch.bool, lead)
        flag = probe
    elif not isinstance(probe, bool):
        raise ValueError(f"probe must be a bool or a bool tensor, got {type(probe)}")
    if slots is None:
        if probe is not True:
            raise ValueError("slots may be None only where every lane probes")
    else:
        _check("slots", slots, torch.int32, lead + (n,))
    if not 1 <= probes <= MAX_PROBES:
        raise ValueError(f"probes must be in 1..{MAX_PROBES}, got {probes}")
    dev = R.device
    ins = [t for t in (p, q_b, mask, q_query, p_l, R_ext, fp, normal, d, plane_valid, flag,
                       slots) if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError("cached_rows_cuda needs all tensors on one CUDA device")
    k = 12 if p_l is not None else 6
    out = CachedRows(
        n=torch.empty(lead + (n, 3), dtype=torch.float32, device=dev),
        r=torch.empty(lead + (n,), dtype=torch.float32, device=dev),
        valid=torch.empty(lead + (n,), dtype=torch.bool, device=dev),
        A=torch.empty(lead + (n, k), dtype=torch.float32, device=dev),
        Aw=torch.empty(lead + (n, k), dtype=torch.float32, device=dev),
        wc=torch.empty(lead + (n,), dtype=torch.float32, device=dev),
        nwc=torch.empty(lead + (n, 3), dtype=torch.float32, device=dev),
        n_matched=torch.empty(lead, dtype=torch.int64, device=dev),
        slots=torch.empty(lead + (n,), dtype=torch.int32, device=dev))
    mode = 0 if probe is False else (1 if probe is True else 2)
    fn = _lib().cached_rows_launch

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(R.data_ptr(), p.data_ptr(), ptr(R_ext), q_b.data_ptr(), ptr(q_query), ptr(p_l),
                 mask.data_ptr(), mode, ptr(flag),
                 fp.data_ptr(), normal.data_ptr(), d.data_ptr(), plane_valid.data_ptr(), c,
                 lanes, n, ptr(slots), int(probes),
                 float(np.float32(1.0 / voxel_size)), 1 if k == 12 else 0,
                 float(np.float32(point_cov)), float(np.float32(max_residual)),
                 _wc_scale(point_cov, degen_conf_ratio),
                 *(t.data_ptr() for t in out), stream)
    if err != 0:
        raise RuntimeError(f"cached_rows kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _world(pts, R, p):
    return pts @ R.mT + p[..., None, :]


def cached_rows_ref(R, p, q_b, mask, table, slots, probe, voxel_size: float, probes: int,
                    point_cov: float, max_residual: float, degen_conf_ratio: float,
                    q_query=None, p_l=None, R_ext=None) -> CachedRows:
    """Plain version: the cached-plane query of ``odom/iekf.py:
    _query_planes`` (where asked) and the row code of its iteration, one
    tensor operation at a time and in their order."""
    fp, normal, d, plane_valid = table
    lm = fp.dim() == 2
    pw = _world(q_b, R, p)
    if probe is False:
        sl = slots
    else:
        pq = pw if q_query is None else _world(q_query, R, p)
        fresh = find_slots_ref(fp, voxel_coords(pq, voxel_size), mask, probes)[0]
        fresh = fresh.to(torch.int32)
        sl = fresh if probe is True else torch.where(probe[..., None], fresh, slots)
    i = torch.clamp(sl, min=0)
    n = gather_rows_ref(normal, i, lane_major=lm)
    plane_d = gather_rows_ref(d, i, lane_major=lm)
    assoc = (sl >= 0) & (gather_rows_ref(plane_valid, i, lane_major=lm) > 0) & mask
    # the cached mode's planes carry no moment record: rvar = 0
    rvar = torch.zeros(assoc.shape, dtype=torch.float32, device=assoc.device)
    r = torch.sum(n * pw, dim=-1) + plane_d
    valid = assoc & (torch.abs(r) < max_residual)
    w = valid.to(torch.float32) / (point_cov + rvar)
    v = n @ R  # Rᵀ n per point
    cols = [torch.linalg.cross(q_b, v, dim=-1), n]
    if p_l is not None:
        cols.append(torch.linalg.cross(p_l, v @ R_ext, dim=-1))
        cols.append(v)
    A = torch.cat(cols, dim=-1)
    wc = (valid & (rvar < degen_conf_ratio * point_cov)).to(torch.float32) * (1.0 / point_cov)
    return CachedRows(n=n, r=r, valid=valid, A=A, Aw=A * w[..., None], wc=wc,
                      nwc=n * wc[..., None], n_matched=torch.sum(valid.to(torch.int32), dim=-1),
                      slots=sl)


def cached_rows(R, p, q_b, mask, table, slots, probe, voxel_size: float, probes: int,
                point_cov: float, max_residual: float, degen_conf_ratio: float,
                q_query=None, p_l=None, R_ext=None) -> CachedRows:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = cached_rows_cuda if R.is_cuda else cached_rows_ref
    return fn(R, p, q_b, mask, table, slots, probe, voxel_size, probes, point_cov,
              max_residual, degen_conf_ratio, q_query=q_query, p_l=p_l, R_ext=R_ext)


def hbm_bytes(rows: CachedRows, table, mask, probe, probed_slots, probes: int,
              q_query: bool = False, ext: bool = False) -> int:
    """HBM bytes one call must move, from its outputs: per point the 12-byte
    ``q_b`` and 1-byte mask (and the 12-byte ``q_query`` and ``p_l`` where
    given), the 4-byte carried slot where a lane does not probe, the
    distinct 32-byte fingerprint sectors of the live points' probes where
    it does (``probed_slots``: their first probe slots ``h0``, numpy, one
    row of lanes' lane-local slots), the distinct sectors of the chosen rows
    (normal, d and plane_valid: three arrays; slot 0 for a miss), and the
    outputs (``n``, ``r``, ``valid``, ``A``, ``Aw``, ``wc``, ``nwc``,
    ``slots``, ``n_matched``)."""
    fp = table[0]
    cap = fp.shape[-1]
    lanes = fp.shape[0] if fp.dim() == 2 else 1
    n = mask.shape[-1]
    k = rows.A.shape[-1]
    live = mask.reshape(lanes, n).cpu().numpy()
    lane_base = (np.arange(lanes) * cap)[:, None]
    if probe is True:
        lane_probes = np.ones(lanes, bool)
    elif probe is False:
        lane_probes = np.zeros(lanes, bool)
    else:
        lane_probes = probe.reshape(lanes).cpu().numpy()
    total = lanes * n * (13 + (12 if q_query else 0) + (12 if ext else 0))
    total += int((~lane_probes).sum()) * n * 4
    if lane_probes.any():
        h0 = np.asarray(probed_slots).reshape(lanes, n).astype(np.int64)
        cand = (h0[..., None] + np.arange(probes)) & (cap - 1)
        cand = (cand + lane_base[..., None])[lane_probes[:, None] & live]
        total += sector_bytes(cand.reshape(-1), 1) if cand.size else 0
    sl = np.clip(rows.slots.reshape(lanes, n).cpu().numpy().astype(np.int64), 0, None)
    rws = (sl + lane_base).reshape(-1)
    total += sector_bytes(rws, 3) + 2 * sector_bytes(rws, 1)
    total += lanes * n * (12 + 4 + 1 + 8 * k + 4 + 12 + 4) + lanes * 8
    return total
