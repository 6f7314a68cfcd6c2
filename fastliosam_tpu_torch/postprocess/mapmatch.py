"""Road-network map matching: snap a georeferenced trajectory to roads
(port of ``fastliosam_tpu/postprocess/mapmatch.py``).

Capability port of the reference's `georef_mapmatch.py` (mappymatch
LCSSMatcher over OSM): an HMM matcher — emission = distance from the
trajectory point to a candidate road edge, transition = agreement between
along-road distance and traveled distance, decoded with Viterbi. The road
network is supplied as polylines (from any source: an OSM extract, a GIS
export); no network access is required.

On the device: the projection of every point on every edge is one pass,
the edges padded to the longest polyline, and the Viterbi is one ``(E, E)``
step a point. Public functions take and return numpy and run on ``device``
(``None``: ``cuda``, which raises without CUDA).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclass
class RoadNetwork:
    """Edges as 2D polylines: list of (Ni, 2) arrays (same CRS as the
    trajectory, e.g. local ENU meters)."""

    edges: list

    def __post_init__(self):
        self.edges = [np.asarray(e, np.float64) for e in self.edges]

    @staticmethod
    def from_osm_xml(path, origin=None, highway_only=True, device=None):
        """Build a road network from an OpenStreetMap XML extract
        (the offline half of the reference's mappymatch-over-OSM flow,
        `georef_mapmatch.py:290-366` — zero-egress environments supply the
        .osm file; this parses it, no fetch involved).

        ``origin`` = (lat, lon) of the local ENU frame; defaults to the
        mean of all way nodes. Ways without a ``highway`` tag are skipped
        unless ``highway_only=False``. Returns ``(network, origin)``.
        """
        import xml.etree.ElementTree as ET

        from ..core.geodesy import LocalCartesian

        dev = resolve_device(device)
        root = ET.parse(path).getroot()
        nodes = {}
        for nd in root.iter("node"):
            nodes[nd.get("id")] = (
                float(nd.get("lat")), float(nd.get("lon"))
            )
        ways = []
        for way in root.iter("way"):
            tags = {t.get("k"): t.get("v") for t in way.findall("tag")}
            if highway_only and "highway" not in tags:
                continue
            refs = [nd.get("ref") for nd in way.findall("nd")]
            pts = [nodes[r] for r in refs if r in nodes]
            if len(pts) >= 2:
                ways.append(np.asarray(pts, np.float64))
        if origin is None:
            allp = np.concatenate(ways, axis=0)
            origin = (float(allp[:, 0].mean()), float(allp[:, 1].mean()))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        lc = LocalCartesian.from_origin(f32(origin[0]), f32(origin[1]), f32(0.0))
        edges = []
        for w in ways:
            enu = lc.forward(f32(w[:, 0]), f32(w[:, 1]), f32(np.zeros(len(w)))).cpu().numpy()
            edges.append(enu[:, :2])
        return RoadNetwork(edges=edges), origin

    def project_points(self, xy, chunk_elems: int = 1 << 22):
        """Nearest point on each edge for every row of the float64 tensor
        ``xy (n, 2)``, on its device: ``(dist (n, E), snapped (n, E, 2),
        arclen (n, E))``, arclen the distance along the edge to the snapped
        point (the JAX package's ``project_point``, a chunk of points at a
        time against every segment of every edge)."""
        dev = xy.device
        n_seg = max(len(e) - 1 for e in self.edges)
        a = torch.zeros((len(self.edges), n_seg, 2), dtype=torch.float64)
        ab = torch.zeros_like(a)
        real = torch.zeros((len(self.edges), n_seg), dtype=torch.bool)
        for k, e in enumerate(self.edges):
            e = torch.from_numpy(e)
            a[k, : len(e) - 1], ab[k, : len(e) - 1] = e[:-1], e[1:] - e[:-1]
            real[k, : len(e) - 1] = True
        a, ab, real = a.to(dev), ab.to(dev), real.to(dev)
        ab2 = torch.clamp(ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1], min=1e-12)
        seg_len = torch.sqrt(ab2)
        arc0 = torch.cumsum(seg_len, 1) - seg_len  # length before each segment
        out, rows = [], max(1, chunk_elems // real.numel())
        for s in range(0, len(xy), rows):
            p = xy[s:s + rows, None, None, :]
            pa = p - a
            t = torch.clamp((pa[..., 0] * ab[..., 0] + pa[..., 1] * ab[..., 1]) / ab2, 0.0, 1.0)
            proj = a + t[..., None] * ab
            q = proj - p
            d2 = torch.where(real, q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1], float("inf"))
            i = torch.argmin(d2, dim=2, keepdim=True)  # the first minimum, as np.argmin
            out.append((
                torch.sqrt(torch.take_along_dim(d2, i, dim=2)[..., 0]),
                torch.take_along_dim(proj, i[..., None], dim=2)[:, :, 0],
                (torch.take_along_dim(arc0.expand_as(d2), i, dim=2)
                 + torch.take_along_dim(t * seg_len, i, dim=2))[..., 0],
            ))
        return tuple(torch.cat(v) for v in zip(*out))

    def project_point(self, p, device=None):
        """Nearest point on each edge: returns arrays
        (dist (E,), snapped (E, 2), arclen (E,)) where arclen is the
        distance along the edge to the snapped point."""
        xy = torch.as_tensor(np.asarray(p, np.float64).reshape(1, 2),
                             device=resolve_device(device))
        return tuple(v[0].cpu().numpy() for v in self.project_points(xy))


def match_trajectory(
    xy: np.ndarray,
    network: RoadNetwork,
    sigma_obs: float = 5.0,
    beta_transition: float = 2.0,
    max_candidate_dist: float = 30.0,
    device=None,
):
    """Viterbi map matching.

    Returns ``(edge_idx (N,), snapped (N, 2), matched mask (N,))`` —
    points with no candidate edge within ``max_candidate_dist`` are
    unmatched (edge −1, original position).
    """
    dev = resolve_device(device)
    xy = np.asarray(xy, np.float64)
    n = len(xy)
    E = len(network.edges)
    xy_t = torch.as_tensor(xy, device=dev)
    dists, snaps, arcs = network.project_points(xy_t)

    # emission log-prob: gaussian on perpendicular distance
    emis = -0.5 * (dists / sigma_obs) ** 2
    emis[dists > max_candidate_dist] = -np.inf

    # transition log-prob: along-road movement should match traveled
    # distance; changing edges costs the endpoint discontinuity; one
    # (E_prev, E) table a step
    step = torch.linalg.vector_norm(xy_t[1:] - xy_t[:-1], dim=1)
    eye = torch.eye(E, dtype=torch.bool, device=dev)
    logp = emis[0].clone()
    back = torch.zeros((n, E), dtype=torch.int64, device=dev)
    for i in range(1, n):
        same = torch.abs(torch.abs(arcs[i][None, :] - arcs[i - 1][:, None]) - step[i - 1])
        jump = torch.linalg.vector_norm(snaps[i][None, :, :] - snaps[i - 1][:, None, :], dim=-1)
        trans = -torch.where(eye, same, jump + step[i - 1]) / max(beta_transition, 1e-6)
        scores = logp[:, None] + trans
        back[i] = torch.argmax(scores, dim=0)  # the first maximum, as np.argmax
        logp = torch.gather(scores, 0, back[i][None])[0] + emis[i]

    if bool(torch.all(torch.isinf(logp))):
        return np.full(n, -1), xy.copy(), np.zeros(n, bool)
    back = back.cpu().numpy()
    edge_idx = np.empty(n, int)
    edge_idx[-1] = int(torch.argmax(logp))
    for i in range(n - 2, -1, -1):
        edge_idx[i] = back[i + 1][edge_idx[i + 1]]
    rows = np.arange(n)
    snapped = snaps.cpu().numpy()[rows, edge_idx]
    matched = np.isfinite(emis.cpu().numpy()[rows, edge_idx])
    snapped[~matched] = xy[~matched]
    edge_out = np.where(matched, edge_idx, -1)
    return edge_out, snapped, matched


def route_length(snapped: np.ndarray) -> float:
    """Total matched route length (the distance-total report of
    `georef_mapmatch.py`)."""
    return float(np.linalg.norm(np.diff(snapped, axis=0), axis=1).sum())
