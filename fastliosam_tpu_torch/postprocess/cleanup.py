"""Map cleanup: denoise, ground extraction, clustering, bounding boxes
(port of ``fastliosam_tpu/postprocess/cleanup.py``).

The pair work runs on the device in float64: the statistical outlier
removal's k nearest neighbours through ``ops/kneighbors_cuda.py`` and the
clustering's neighbour-voxel test through ``ops/cluster_cuda.py``; the
RANSAC scoring is one matrix product. Results equal the JAX package's:
the same keep-masks, inlier masks and cluster labels. Public functions take
and return numpy and run on ``device`` (``None``: ``cuda``, which raises
without CUDA; pass ``"cpu"`` for the plain versions).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cluster_cuda import key_coder, voxel_edges
from ..ops.kneighbors_cuda import knn
from ..utils.device import resolve_device


def _f64(xyz, dev):
    return torch.as_tensor(np.asarray(xyz, np.float64), device=dev).reshape(-1, 3).contiguous()


def _knn_mean_dists(xyz: np.ndarray, k: int, device=None) -> torch.Tensor:
    """Mean distance to the k nearest neighbours (self excluded), as a
    float64 tensor on ``device``."""
    pts = _f64(xyz, resolve_device(device))
    d2, _ = knn(pts, pts, k, exclude_self=True)
    return torch.sqrt(torch.clamp(d2, min=0.0)).mean(1)


def sor_denoise(xyz: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0,
                device=None):
    """Statistical outlier removal (pcl::StatisticalOutlierRemoval /
    open3d remove_statistical_outlier semantics). Returns a keep-mask."""
    d = _knn_mean_dists(xyz, nb_neighbors, device)
    thr = d.mean() + std_ratio * d.std(correction=0)
    return (d <= thr).cpu().numpy()


def ransac_ground_plane(
    xyz: np.ndarray,
    distance_threshold: float = 0.2,
    num_iterations: int = 200,
    seed: int = 0,
    device=None,
):
    """RANSAC plane fit. Returns ``(plane (4,) [a,b,c,d], inlier_mask)``
    with the normal oriented +z (ground).

    The hypotheses are drawn and made on the host with the JAX package's
    numpy calls (a degenerate triple spends its draw there too); all of
    them are scored in one device pass, and the first best wins."""
    rng = np.random.default_rng(seed)
    host = np.asarray(xyz, np.float64)
    n = len(host)
    normals, offsets, usable = [], [], []
    for _ in range(num_iterations):
        i = rng.choice(n, 3, replace=False)
        p0, p1, p2 = host[i]
        nrm = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(nrm)
        usable.append(bool(norm >= 1e-9))
        nrm = nrm / norm if usable[-1] else np.zeros(3)
        normals.append(nrm)
        offsets.append(-nrm @ p0)
    if not any(usable):
        raise ValueError("RANSAC: every sampled triple is degenerate")
    dev = resolve_device(device)
    pts = _f64(host, dev)
    nrm_t = torch.as_tensor(np.stack(normals), device=dev)
    off_t = torch.as_tensor(np.asarray(offsets), device=dev)
    counts = (torch.abs(pts @ nrm_t.T + off_t) < distance_threshold).sum(0)
    counts = torch.where(torch.as_tensor(usable, device=dev), counts, -1)
    best = int(torch.argmax(counts))  # the first maximum: JAX's strict >
    nrm, d = normals[best], offsets[best]
    if nrm[2] < 0:
        nrm, d = -nrm, -d
    nrm_t = torch.as_tensor(nrm, device=dev)
    inliers = torch.abs(pts @ nrm_t + d) < distance_threshold
    # least-squares refinement on inliers
    q = pts[inliers]
    centroid = q.mean(0)
    _, _, vt = torch.linalg.svd(q - centroid, full_matrices=False)
    nrm_t = vt[-1]
    if nrm_t[2] < 0:
        nrm_t = -nrm_t
    d_t = -nrm_t @ centroid
    inliers = torch.abs(pts @ nrm_t + d_t) < distance_threshold
    plane = torch.cat([nrm_t, d_t[None]])
    return plane.cpu().numpy(), inliers.cpu().numpy()


class Voxels(NamedTuple):
    """The clustering's voxels of ``N`` points (see :func:`voxelize`)."""

    voxel_of: torch.Tensor  # (N,) each point's voxel
    first: torch.Tensor  # (V,) each voxel's first point
    sorted_pts: torch.Tensor  # (N, 3) the points in voxel order
    keys: torch.Tensor  # (V, 3) int64, sorted
    offsets: torch.Tensor  # (V + 1,) voxel v holds sorted_pts[offsets[v]:offsets[v + 1]]


def voxelize(pts, eps: float) -> Voxels:
    """The voxels of edge ``eps`` of float64 points ``pts (N, 3)`` (the JAX
    package's ``floor(pts / eps)`` keys), laid out as ``voxel_edges`` takes
    them."""
    n, dev = pts.shape[0], pts.device
    ij = torch.floor(pts / eps).to(torch.int64)
    code = key_coder(ij)
    codes, inv, counts = torch.unique(code(ij), return_inverse=True, return_counts=True)
    first = torch.full((codes.shape[0],), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, inv, torch.arange(n, device=dev), reduce="amin")
    order = torch.argsort(inv, stable=True)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return Voxels(inv, first, pts[order].contiguous(),
                  ij[first].contiguous(), offsets)


def _cluster_roots(n_voxels: int, edges_a: list, edges_b: list) -> list:
    """Union-find over voxels, the JAX package's ``union`` calls replayed in
    its order: the root of ``a`` stays root, ``b``'s root joins it."""
    parent = list(range(n_voxels))
    for a, b in zip(edges_a, edges_b):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        while parent[b] != b:
            parent[b] = parent[parent[b]]
            b = parent[b]
        if a != b:
            parent[b] = a
    roots = []
    for v in range(n_voxels):
        while parent[v] != v:
            v = parent[v]
        roots.append(v)
    return roots


def euclidean_clusters(
    xyz: np.ndarray, eps: float = 0.5, min_points: int = 10, device=None
) -> np.ndarray:
    """Density clustering via voxel-grid connected components (DBSCAN-like:
    points within ``eps`` connect transitively). Returns labels (N,),
    −1 = noise.

    Labels equal the JAX package's bit for bit. It numbers clusters by the
    roots of its union-find in ascending order, and the roots depend on the
    order of its ``union`` calls, so those calls are replayed on the host in
    its order; the pair tests between neighbouring voxels, where its time
    goes, are one kernel launch. Its within-voxel unions join each later
    point of a voxel, still a singleton, under the root of the voxel's
    first point: they change no root, so the replay runs over voxels (each
    named by its first point), in first-appearance order, with the
    kernel's edges in place of its distance test."""
    dev = resolve_device(device)
    pts = _f64(xyz, dev)
    n = pts.shape[0]
    if n == 0:
        return -np.ones(0, dtype=int)
    vox = voxelize(pts, eps)
    nb = voxel_edges(vox.sorted_pts, vox.keys, vox.offsets, eps)
    # the edges with voxels in first-appearance order (the JAX package's
    # dict order) and offsets in its loop order
    by_first = torch.argsort(vox.first)
    rows, cols = torch.nonzero(nb[by_first] >= 0, as_tuple=True)
    a = by_first[rows]
    b = nb[a, cols]
    roots = torch.as_tensor(_cluster_roots(len(vox.keys), a.tolist(), b.tolist()), device=dev)
    point_roots = vox.first[roots][vox.voxel_of]  # each point's root, named by its first point
    _, root_of, size = torch.unique(point_roots, return_inverse=True, return_counts=True)
    big = size >= min_points
    label = torch.where(big, torch.cumsum(big, 0) - 1, -1)
    return label[root_of].cpu().numpy().astype(int)


def cluster_bounding_boxes(xyz: np.ndarray, labels: np.ndarray):
    """Axis-aligned bounding boxes per cluster: list of (min_xyz, max_xyz,
    n_points)."""
    out = []
    for lbl in range(labels.max() + 1):
        m = labels == lbl
        p = np.asarray(xyz)[m]
        out.append((p.min(0), p.max(0), int(m.sum())))
    return out


def intensity_filter(intensity: np.ndarray, min_intensity: float) -> np.ndarray:
    """Keep-mask for points above an intensity floor
    (`post_process/filter.py` capability)."""
    return np.asarray(intensity) >= min_intensity


def denoise_slam_map(
    xyz: np.ndarray,
    intensity: np.ndarray | None = None,
    min_intensity: float = 0.0,
    sor_neighbors: int = 20,
    sor_std: float = 2.0,
    cluster_eps: float = 0.0,
    cluster_min_points: int = 10,
    device=None,
) -> np.ndarray:
    """The reference's (disabled) map-denoise pipeline
    (`fast_lio_sam.cpp:941-1008`): optional intensity gate → statistical
    outlier removal → optional small-cluster rejection. Returns a keep-mask.
    """
    keep = np.ones(len(xyz), bool)
    if intensity is not None and min_intensity > 0:
        keep &= intensity_filter(intensity, min_intensity)
    idx = np.nonzero(keep)[0]
    sor_keep = sor_denoise(np.asarray(xyz)[idx], sor_neighbors, sor_std, device=device)
    keep[idx[~sor_keep]] = False
    if cluster_eps > 0:
        idx = np.nonzero(keep)[0]
        labels = euclidean_clusters(
            np.asarray(xyz)[idx], eps=cluster_eps, min_points=cluster_min_points,
            device=device,
        )
        keep[idx[labels < 0]] = False
    return keep
