"""Cross-voxel adjacency of Euclidean clustering: the CUDA kernel
``csrc/cluster.cu``, its plain PyTorch version, and the dispatch between
them.

No Pallas kernel stands behind it: the JAX package tests the pairs of
neighbouring voxels in numpy on the host (``fastliosam_tpu/postprocess/
cleanup.py: euclidean_clusters``, lines 105-124). :func:`voxel_edges`
launches the kernel for CUDA tensors (or raises) and runs the plain version
only for tensors on the CPU; there is no fallback from one to the other.

Semantics: given points sorted by voxel ``pts (P, 3) float64``, the sorted
unique voxel keys ``keys (V, 3) int64`` and ``offsets (V + 1,) int64`` (voxel
v holds points ``[offsets[v], offsets[v + 1])``), ``nb (V, 13) int64``:
``nb[v, o]`` is the index of the voxel ``keys[v] + OFFSETS[o]`` when it
exists and some pair of the two voxels' points has ``(dx*dx + dy*dy) +
dz*dz <= eps * eps`` (numpy's order and rounding), else -1. The kernel
equals the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = {
    "name": "voxel_edges",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/cluster.cu",
    "replaces": "none (numpy on the host): fastliosam_tpu/postprocess/cleanup.py:105-124 "
                "(euclidean_clusters' neighbour-voxel pair test)",
}

# the lexicographically positive neighbour offsets, in the nested-loop order
# of dx, dy, dz in (-1, 0, 1): the JAX package's order with nb <= key skipped
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                if (dx, dy, dz) > (0, 0, 0))

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("cluster")
    fn = lib.voxel_edges_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def key_coder(keys):
    """A function that maps voxel keys ``(..., 3) int64`` within one voxel of
    ``keys`` to int64 codes whose order is the keys' lexicographic order."""
    lo = keys.min(0).values - 1
    span = (keys.max(0).values - lo + 2).tolist()
    if span[0] * span[1] * span[2] >= 1 << 62:
        raise ValueError(f"voxel keys span {span}: too wide for one int64 code")
    sy, sz = span[1], span[2]

    def code(k):
        s = k - lo
        return (s[..., 0] * sy + s[..., 1]) * sz + s[..., 2]

    return code


def _check(pts, keys, offsets) -> None:
    if pts.dtype != torch.float64 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (P, 3) float64, got {tuple(pts.shape)} {pts.dtype}")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 3:
        raise ValueError(f"keys must be (V, 3) int64, got {tuple(keys.shape)} {keys.dtype}")
    if offsets.dtype != torch.int64 or offsets.shape != (keys.shape[0] + 1,):
        raise ValueError(f"offsets must be ({keys.shape[0] + 1},) int64, "
                         f"got {tuple(offsets.shape)} {offsets.dtype}")
    if not (pts.is_contiguous() and keys.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("pts, keys and offsets must be contiguous")
    if keys.device != pts.device or offsets.device != pts.device:
        raise ValueError("pts, keys and offsets must be on one device")


def voxel_edges_cuda(pts, keys, offsets, eps: float):
    """``nb (V, 13) int64``, the voxels' neighbours within ``eps`` (-1:
    none); CUDA tensors only."""
    global launches
    _check(pts, keys, offsets)
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError("voxel_edges_cuda needs CUDA tensors")
    v = keys.shape[0]
    nb = torch.empty((v, len(OFFSETS)), dtype=torch.int64, device=dev)
    fn = _lib().voxel_edges_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(pts.data_ptr(), keys.data_ptr(), offsets.data_ptr(), v, float(eps) * float(eps),
                 nb.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"voxel_edges kernel launch failed: cudaError {err}")
    launches += 1
    return nb


def voxel_edges_ref(pts, keys, offsets, eps: float, chunk_elems: int = 1 << 22):
    """Plain version: every voxel's points padded to the largest occupancy
    (with +inf, whose differences never pass the test), the neighbour found
    by a search over the keys' codes, and all padded pairs tested, a chunk of
    voxels at a time."""
    _check(pts, keys, offsets)
    v, dev = keys.shape[0], pts.device
    out = torch.full((v, len(OFFSETS)), -1, dtype=torch.int64, device=dev)
    if v == 0:
        return out
    counts = offsets[1:] - offsets[:-1]
    kmax = int(counts.max())
    owner = torch.repeat_interleave(torch.arange(v, device=dev), counts)
    slot = torch.arange(pts.shape[0], device=dev) - offsets[owner]
    padded = torch.full((v, kmax, 3), float("inf"), dtype=torch.float64, device=dev)
    padded[owner, slot] = pts
    code = key_coder(keys)
    codes = code(keys)
    eps2 = float(eps) * float(eps)
    rows = max(1, chunk_elems // (kmax * kmax))
    for o, off in enumerate(OFFSETS):
        want = code(keys + torch.tensor(off, dtype=torch.int64, device=dev))
        nb = torch.searchsorted(codes, want).clamp(max=v - 1)
        exists = codes[nb] == want
        for s in range(0, v, rows):
            a, b = padded[s:s + rows], padded[nb[s:s + rows]]
            dx = a[:, :, None, 0] - b[:, None, :, 0]
            dy = a[:, :, None, 1] - b[:, None, :, 1]
            dz = a[:, :, None, 2] - b[:, None, :, 2]
            hit = (((dx * dx + dy * dy) + dz * dz) <= eps2).flatten(1).any(1)
            out[s:s + rows, o] = torch.where(hit & exists[s:s + rows], nb[s:s + rows], -1)
    return out


def voxel_edges(pts, keys, offsets, eps: float):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if pts.is_cuda:
        return voxel_edges_cuda(pts, keys, offsets, eps)
    return voxel_edges_ref(pts, keys, offsets, eps)
