"""Exact k nearest neighbours in float64: the CUDA kernels ``csrc/knn.cu``
(a cell-grid search, and brute force for small destination sets), their
plain PyTorch version, and the dispatch between them.

No Pallas kernel stands behind it: the JAX package computes this in numpy
on the host (``fastliosam_tpu/postprocess/cleanup.py: _knn_mean_dists``,
the statistical outlier removal's chunked brute force, and
``postprocess/align.py: icp_2d_with_scale``'s nearest neighbour). :func:`knn`
launches the kernels for CUDA tensors (or raises) and runs the plain version
only for tensors on the CPU; there is no fallback from one to the other.

Semantics: for each row i of ``src (N, 3)``, the ``k`` rows j of ``dst (M,
3)`` with the smallest ``d2 = (dx*dx + dy*dy) + dz*dz`` (numpy's order,
every product and sum rounded on its own), ascending, ties to the lowest j;
with ``exclude_self`` (``src`` is ``dst``) j == i is skipped, as
``np.fill_diagonal(d2, inf)`` does. Any ``1 <= k <= M`` (less one with
``exclude_self``). Returns ``(d2 (N, k) float64, idx (N, k) int64)``; both
kernel routes equal the plain version bit for bit.

On the card, ``M >= GRID_MIN_DST`` takes the grid route: the cell index
(``ops/cell_grid.py: cell_index``, plain torch) and the queries' cell
order; one kernel that fills the cell hash from the index; the search
kernel; and the rescue pass (the brute-force kernel over the queries that
used up their probe budget). Below it, one brute-force kernel. No route
reads the device back: a call costs no host sync.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from . import cell_grid
from .cell_grid import hash_capacity

KERNEL = {
    "name": "knn",
    "route": "cuda",
    "source": "fastliosam_tpu_torch/csrc/knn.cu",
    "replaces": "none (numpy on the host): fastliosam_tpu/postprocess/cleanup.py:13 "
                "(_knn_mean_dists) and align.py:118 (icp_2d_with_scale)",
}

# destinations from which the grid route runs: from 65,536 it beat brute
# force at every size measured (to 131,072), both at k = 20 and at k = 1 on
# the z = 0 plane; below, the few queries its rescue pass takes (one thread
# each over all M) cost more than brute force saves.
# fastliosam_tpu_torch/scripts/exp_knn.py on an H100, PERF.md
GRID_MIN_DST = 65536
# cells a query may probe before it goes to the rescue pass: a probe is a
# dependent load, so the budget bounds the search's slowest thread; 125 is
# the 5 x 5 x 5 cube (exp_knn.py sweeps 27 to 4096)
PROBE_BUDGET = 125

launches = 0  # knn kernel launches (the search or the brute force), one a call
build_launches = 0  # the grid route's cell hash fills, one a call
rescue_launches = 0  # the grid route's rescue passes, one a call


def reset_launches() -> None:
    global launches, build_launches, rescue_launches
    launches = build_launches = rescue_launches = 0


_P, _LL, _I, _ULL = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
_SIGNATURES = {
    "knn_launch": [_P, _LL, _P, _LL, _I, _I, _P, _P, _P],
    "knn_hash_launch": [_P, _P, _P, _LL, _P, _ULL, _P],
    "knn_grid_launch": [_P, _LL, _P, _P, _LL, _P, _ULL, _P, _P, _I, _I, _LL, _P, _P, _P, _P, _P],
    "knn_rescue_launch": [_P, _LL, _P, _LL, _I, _I, _P, _P, _P, _P, _P],
}


def _lib():
    lib = build.load("knn")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
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
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if dst.shape[0] < k + int(exclude_self):
        raise ValueError(f"need at least {k + int(exclude_self)} destinations for k = {k}, "
                         f"got {dst.shape[0]}")
    if exclude_self and src.shape[0] > dst.shape[0]:
        raise ValueError("exclude_self needs src to be dst")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"knn {what} launch failed: cudaError {err}")


def _outputs(n: int, k: int, dev):
    return (torch.empty((n, k), dtype=torch.float64, device=dev),
            torch.empty((n, k), dtype=torch.int64, device=dev))


def _knn_brute(src, dst, k: int, exclude_self: bool):
    """The brute-force route: one launch."""
    global launches
    n, m, dev = src.shape[0], dst.shape[0], src.device
    d2, idx = _outputs(n, k, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _raise_on(_lib().knn_launch(src.data_ptr(), n, dst.data_ptr(), m, int(k),
                                    int(exclude_self), d2.data_ptr(), idx.data_ptr(), stream),
                  "kernel")
    launches += 1
    return d2, idx


def _knn_grid(src, dst, k: int, exclude_self: bool, occupancy: float = cell_grid.OCCUPANCY,
              probe_budget: int = PROBE_BUDGET):
    """The grid route: the cell index, the cell hash, the search, the rescue
    pass over the queries that used up their probe budget. Returns ``(d2,
    idx, stats, index)``: ``stats`` (3,) int64 on the device counts the
    queries rescued, the search's pair tests and its cell probes (reading
    it syncs); ``index`` is the ``CellIndex``."""
    global launches, build_launches, rescue_launches
    n, m, dev = src.shape[0], dst.shape[0], src.device
    d2, idx = _outputs(n, k, dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    index = cell_grid.cell_index(dst, k, occupancy)
    if n == 0:
        return d2, idx, stats, index
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    same = src.data_ptr() == dst.data_ptr() and src.shape == dst.shape
    qorder = index.order if same else cell_grid.query_order(src, index)
    cap = hash_capacity(m)
    slots = torch.full((cap, 2), -1, dtype=torch.int64, device=dev)  # 16-byte slots
    rescue = torch.empty(n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _raise_on(lib.knn_hash_launch(index.cell_start.data_ptr(), index.cell_code.data_ptr(),
                                      index.n_cells.data_ptr(), m, slots.data_ptr(), cap - 1,
                                      stream), "cell hash")
        build_launches += 1
        _raise_on(lib.knn_grid_launch(
            src.data_ptr(), n, qorder.data_ptr(), index.points.data_ptr(), m, slots.data_ptr(),
            cap - 1, index.fparams.data_ptr(), index.iparams.data_ptr(), int(k),
            int(exclude_self), int(probe_budget), d2.data_ptr(), idx.data_ptr(),
            rescue.data_ptr(), stats.data_ptr(), stream), "search")
        launches += 1
        _raise_on(lib.knn_rescue_launch(src.data_ptr(), n, dst.data_ptr(), m, int(k),
                                        int(exclude_self), rescue.data_ptr(), stats.data_ptr(),
                                        d2.data_ptr(), idx.data_ptr(), stream), "rescue")
        rescue_launches += 1
    return d2, idx, stats, index


def knn_cuda(src, dst, k: int, exclude_self: bool = False):
    """``(d2 (N, k), idx (N, k))`` of the k nearest rows of ``dst``; CUDA
    tensors only. The grid route from ``GRID_MIN_DST`` destinations, brute
    force below."""
    _check(src, dst, k, exclude_self)
    if src.device.type != "cuda":
        raise ValueError("knn_cuda needs CUDA tensors")
    if dst.shape[0] >= 1 << 31:
        raise ValueError(f"dst must have fewer than 2^31 rows, got {dst.shape[0]}")
    if dst.shape[0] >= GRID_MIN_DST:
        return _knn_grid(src, dst, k, exclude_self)[:2]
    return _knn_brute(src, dst, k, exclude_self)


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
