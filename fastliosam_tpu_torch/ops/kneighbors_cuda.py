"""Brute-force k nearest neighbours in float64: the CUDA kernel
``csrc/knn.cu``, its plain PyTorch version, and the dispatch between them.

No Pallas kernel stands behind it: the JAX package computes this in numpy
on the host (``fastliosam_tpu/postprocess/cleanup.py: _knn_mean_dists``,
the statistical outlier removal's chunked brute force, and
``postprocess/align.py: icp_2d_with_scale``'s nearest neighbour). :func:`knn`
launches the kernel for CUDA tensors (or raises) and runs the plain version
only for tensors on the CPU; there is no fallback from one to the other.

Semantics: for each row i of ``src (N, 3)``, the ``k`` rows j of ``dst (M,
3)`` with the smallest ``d2 = (dx*dx + dy*dy) + dz*dz`` (numpy's order,
every product and sum rounded on its own), ascending, ties to the lowest j;
with ``exclude_self`` (``src`` is ``dst``) j == i is skipped, as
``np.fill_diagonal(d2, inf)`` does. Returns ``(d2 (N, k) float64, idx (N, k)
int64)``; the kernel equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = {
    "name": "knn",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/knn.cu",
    "replaces": "none (numpy on the host): fastliosam_tpu/postprocess/cleanup.py:13 "
                "(_knn_mean_dists) and align.py:118 (icp_2d_with_scale)",
}

MAX_K = 32

launches = 0  # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = build.load("knn")
    fn = lib.knn_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(src, dst, k: int, exclude_self: bool) -> None:
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.float64 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3) float64, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src.device != dst.device:
        raise ValueError("src and dst must be on one device")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if dst.shape[0] < k + int(exclude_self):
        raise ValueError(f"need at least {k + int(exclude_self)} destinations for k = {k}, "
                         f"got {dst.shape[0]}")
    if exclude_self and src.shape[0] > dst.shape[0]:
        raise ValueError("exclude_self needs src to be dst")


def knn_cuda(src, dst, k: int, exclude_self: bool = False):
    """``(d2 (N, k), idx (N, k))`` of the k nearest rows of ``dst``; CUDA
    tensors only."""
    global launches
    _check(src, dst, k, exclude_self)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError("knn_cuda needs CUDA tensors")
    n, m = src.shape[0], dst.shape[0]
    d2 = torch.empty((n, k), dtype=torch.float64, device=dev)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    fn = _lib().knn_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), n, dst.data_ptr(), m, int(k), int(exclude_self),
                 d2.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: cudaError {err}")
    launches += 1
    return d2, idx


def pair_d2(a, b):
    """``(R, M)`` squared distances of the rows of ``a (R, 3)`` to those of
    ``b (M, 3)``, term by term in numpy's order ``(dx*dx + dy*dy) + dz*dz``
    (``.sum(-1)`` would sum in another order)."""
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    dz = a[:, None, 2] - b[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def knn_ref(src, dst, k: int, exclude_self: bool = False, chunk_elems: int = 1 << 26):
    """Plain version: the distances of a chunk of rows to every destination,
    the diagonal set to inf with ``exclude_self``, a stable sort (ties keep
    ascending indices) and its first k."""
    _check(src, dst, k, exclude_self)
    n, m = src.shape[0], dst.shape[0]
    rows = max(1, chunk_elems // max(m, 1))
    d2_out = torch.empty((n, k), dtype=torch.float64, device=src.device)
    idx_out = torch.empty((n, k), dtype=torch.int64, device=src.device)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        d2 = pair_d2(src[s:e], dst)
        if exclude_self:
            r = torch.arange(s, e, device=src.device)
            d2[r - s, r] = float("inf")
        val, order = torch.sort(d2, dim=1, stable=True)
        d2_out[s:e], idx_out[s:e] = val[:, :k], order[:, :k]
    return d2_out, idx_out


def knn(src, dst, k: int, exclude_self: bool = False):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if src.is_cuda:
        return knn_cuda(src, dst, k, exclude_self)
    return knn_ref(src, dst, k, exclude_self)
