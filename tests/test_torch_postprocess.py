"""The port's post-processing toolbox (``fastliosam_tpu_torch/postprocess``)
against the JAX package's on the same seeded numpy inputs, on the CPU
(``device="cpu"``: the kernels' plain versions).

Tolerances, each with its reason:
  * the k-NN's plain d2 equals numpy's bit for bit (the same expression,
    term by term); its order is lexicographic (d2, index);
  * SOR mean distances agree to a relative 1e-12 (numpy averages the k
    smallest in ``np.partition``'s order, the port in ascending order), and
    the keep-masks are equal;
  * RANSAC planes agree within 1e-9 (the SVD refinement on another LAPACK
    path), the inlier masks are equal;
  * cluster labels are equal bit for bit, ``denoise_slam_map`` with
    ``cluster_eps > 0`` included;
  * ``fit_similarity_2d``, ICP-2D and ``match_trajectory`` agree within
    1e-9 (float64 sums in other orders); the OSM reader's ENU nodes within
    1e-4 m (float32 geodesy in both packages, whose sin/cos differ by an
    ulp: 1.5e-5 m at 200 m);
  * georeferencing runs float32 geodesy in both packages (ROADMAP Queue 3
    fault 2: float32 lon at 114° steps 7.6e-6°, ~0.8 m, and ECEF 0.5 m): each
    position within 3 m horizontally of JAX's, each package's within 2 m of
    a float64 numpy conversion, θ within 1e-3 rad and scale within 1e-3;
  * ``decode_yolo`` / ``nms`` equal on distinct scores (numpy's ``argsort``
    is not stable: the order of equal scores is printed, not tested);
  * ``CameraModel.project`` within 1e-9 px of ``cv2.projectPoints``.
cv2 and matplotlib tests skip without those packages, as
``tests/test_images_plots.py`` does.
"""
import numpy as np
import pytest
import torch

from fastliosam_tpu import postprocess as jpp
from fastliosam_tpu.postprocess import align as jalign
from fastliosam_tpu.postprocess import cleanup as jclean
from fastliosam_tpu.postprocess import detect as jdetect
from fastliosam_tpu.postprocess import georef as jgeoref
from fastliosam_tpu.postprocess import images as jimages
from fastliosam_tpu.postprocess import mapmatch as jmm
from fastliosam_tpu.postprocess import plots as jplots
from fastliosam_tpu_torch import postprocess as tpp
from fastliosam_tpu_torch.ops import cell_grid, cluster_cuda, kneighbors_cuda
from fastliosam_tpu_torch.postprocess import align as talign
from fastliosam_tpu_torch.postprocess import cleanup as tclean
from fastliosam_tpu_torch.postprocess import detect as tdetect
from fastliosam_tpu_torch.postprocess import georef as tgeoref
from fastliosam_tpu_torch.postprocess import images as timages
from fastliosam_tpu_torch.postprocess import mapmatch as tmm
from fastliosam_tpu_torch.postprocess import plots as tplots
from fastliosam_tpu_torch.scripts import exp_knn

CPU = "cpu"
needs_cv2 = pytest.mark.skipif(not jimages.HAS_CV2, reason="cv2 unavailable")


def _bits(a):
    return np.ascontiguousarray(a).view(np.int64)


def _cloud(seed, n_ground=600, n_out=30, n_blobs=3):
    """A noisy ground patch, a few tight blobs and scattered outliers."""
    rng = np.random.default_rng(seed)
    ground = np.column_stack([rng.uniform(-8, 8, n_ground), rng.uniform(-8, 8, n_ground),
                              rng.normal(size=n_ground) * 0.03])
    blobs = [rng.normal(size=(40, 3)) * 0.15 + rng.uniform(-6, 6, 3) + [0, 0, 2]
             for _ in range(n_blobs)]
    out = rng.uniform(-8, 8, size=(n_out, 3)) + [0, 0, 6]
    return rng.permutation(np.vstack([ground, *blobs, out]))


def test_exports_match_the_jax_package():
    names = [n for n in dir(jpp) if not n.startswith("_") and callable(getattr(jpp, n))]
    assert names and all(hasattr(tpp, n) for n in names)


def test_public_functions_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None runs on the card")
    xyz = _cloud(0)
    for call in (lambda: tpp.sor_denoise(xyz), lambda: tpp.euclidean_clusters(xyz),
                 lambda: tpp.ransac_ground_plane(xyz), lambda: tpp.denoise_slam_map(xyz),
                 lambda: tpp.fit_similarity_2d(xyz[:, :2], xyz[:, :2]),
                 lambda: tpp.icp_2d_with_scale(xyz[:, :2], xyz[:, :2]),
                 lambda: tmm.match_trajectory(xyz[:5, :2], tmm.RoadNetwork([xyz[:3, :2]])),
                 lambda: tdetect.nms(xyz[:4, [0, 1, 0, 1]], xyz[:4, 2]),
                 lambda: timages.CameraModel(1, 1, 0, 0, []).project(xyz)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# --- kernels' plain versions --------------------------------------------


@pytest.mark.parametrize("n,m", [(64, 500), (300, 301)])
def test_knn_plain_d2_equals_numpy_bit_for_bit(n, m):
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=(n, 3)) * 7, rng.normal(size=(m, 3)) * 7
    want = ((a[:, None] - b[None]) ** 2).sum(-1)
    got = kneighbors_cuda.pair_d2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k,exclude_self", [(1, False), (20, True), (32, False), (50, True),
                                            (64, False)])
def test_knn_plain_order_is_d2_then_index(k, exclude_self):
    rng = np.random.default_rng(k)
    dst = rng.integers(-3, 4, size=(400, 3)).astype(np.float64)  # many exact ties
    src = dst if exclude_self else rng.integers(-3, 4, size=(50, 3)).astype(np.float64)
    d2, idx = kneighbors_cuda.knn(torch.from_numpy(src), torch.from_numpy(dst), k, exclude_self)
    full = ((src[:, None] - dst[None]) ** 2).sum(-1)
    if exclude_self:
        np.fill_diagonal(full, np.inf)
    order = np.lexsort((np.broadcast_to(np.arange(len(dst)), full.shape), full), axis=1)[:, :k]
    assert np.array_equal(idx.numpy(), order)
    assert np.array_equal(_bits(d2.numpy()), _bits(np.take_along_axis(full, order, 1)))


def ip_level(index):
    return int(index.iparams[6])


def _cell_box(index):
    """Each sorted point's coarse cell as ``(lo, hi)`` coordinates of its
    faces, from the index's own keys, and the kernel's slack."""
    h, mag = index.fparams.tolist()
    ip = index.iparams.tolist()
    base, level = np.array(ip[:3]), ip[6]
    keys = np.floor(index.points[:, :3].numpy() / h).astype(np.int64) - base
    cell = keys >> level
    lo = (base + (cell << level)) * h
    hi = (base + ((cell + 1) << level)) * h
    return cell, lo, hi, 1e-12 * (mag + mag + h * 2.0**level)


@pytest.mark.parametrize("case", ["street", "faces", "one_cell", "georeferenced", "plane_z0"])
def test_cell_index_places_every_point_in_its_cell(case):
    sets = {name: dst for name, _, dst, _, _ in exp_knn.hazard_sets(0, scale=0.1)}
    dst = exp_knn.surface_cloud(3000, 1) if case == "street" else sets[case]
    dst_t = torch.from_numpy(np.ascontiguousarray(dst))
    index = cell_grid.cell_index(dst_t, 20)
    m, n_cells = len(dst), int(index.n_cells)
    order = index.points[:, 3].numpy().astype(np.int64)
    # every point once, carrying its original index and coordinates
    assert np.array_equal(np.sort(order), np.arange(m))
    assert np.array_equal(order, index.order.numpy())
    # the points as queries take the index's own order
    assert torch.equal(cell_grid.query_order(dst_t, index), index.order)
    assert np.array_equal(index.points[:, :3].numpy(), dst[order])
    # fine keys within 2^21 a side, codes ascending
    top = index.iparams[3:6].numpy()
    assert (top >= 0).all() and (top < 1 << cell_grid.FINE_BITS).all()
    assert (np.diff(index.codes.numpy()) >= 0).all()
    # cell c holds exactly the points whose key names it, and each point lies
    # in its cell's box within the kernel's slack
    cell, lo, hi, slack = _cell_box(index)
    start = index.cell_start.numpy()
    assert start[0] == 0 and (np.diff(start[: n_cells + 1]) > 0).all() and start[n_cells] == m
    owner = np.repeat(np.arange(n_cells), np.diff(start[: n_cells + 1]))
    code = cell_grid.morton(torch.from_numpy(cell)).numpy()
    assert np.array_equal(code, index.cell_code.numpy()[owner])
    assert len(np.unique(index.cell_code.numpy()[:n_cells])) == n_cells
    p = index.points[:, :3].numpy()
    assert ((p >= lo - slack) & (p <= hi + slack)).all()
    # the level's mean occupancy is the nearest (in ratio) to the target's
    codes = index.codes.numpy()
    per_level = [len(np.unique(codes >> (3 * lv))) for lv in range(cell_grid.FINE_BITS)]
    assert per_level[ip_level(index)] == n_cells
    miss = np.abs(np.log(m / np.array(per_level)) - np.log(max(2.0, cell_grid.OCCUPANCY * 21)))
    assert miss[ip_level(index)] == miss.min() and (miss[ip_level(index) + 1:] > miss.min()).all()


def _grid_pass(src, dst, k, exclude_self, queries, d2_out, idx_out):
    """``csrc/knn.cu: knn_grid_kernel`` in numpy over the plain index: rings
    clipped to the occupied cells, cells beyond the k-th d2 skipped, the
    stop rule with its slack, the probe budget. Writes the finished
    queries' rows and returns the queries handed to the rescue pass."""
    index = cell_grid.cell_index(torch.from_numpy(dst), k)
    h, mag = index.fparams.tolist()
    ip = index.iparams.tolist()
    base, level = ip[:3], ip[6]
    kmax = [t >> level for t in ip[3:6]]
    pts, start = index.points.numpy(), index.cell_start.numpy()
    table = {c: i for i, c in enumerate(index.cell_code.numpy()[: int(index.n_cells)].tolist())}
    handed = []
    for i in queries:
        q = src[i]
        kq = [(int(np.floor(q[a] / h)) - base[a]) >> level for a in range(3)]
        slack = 1e-12 * (np.abs(q).max() + mag + h * 2.0**level)
        r = max(0, *(max(-kq[a], kq[a] - kmax[a]) for a in range(3)))
        ds, js, probes, kd = [np.empty(0)], [np.empty(0, np.int64)], 0, np.inf
        while True:
            axes = [np.arange(max(kq[a] - r, 0), min(kq[a] + r, kmax[a]) + 1) for a in range(3)]
            cells = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
            cells = cells[np.abs(cells - kq).max(1) == r]
            # a cell whose box lies beyond the k-th d2 so far is skipped
            lo = (np.array(base) + (cells << level)) * h
            hi = (np.array(base) + ((cells + 1) << level)) * h
            gap = np.maximum(np.maximum(np.maximum(lo - q, q - hi), 0.0) - slack, 0.0)
            least = ((gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1]) + gap[:, 2] * gap[:, 2]) * (
                1 - 1e-12)
            for c, cell_least in zip(cell_grid.morton(torch.from_numpy(cells)).tolist(), least):
                if cell_least > kd:
                    continue
                probes += 1
                if c in table:
                    p = pts[start[table[c]]:start[table[c] + 1]]
                    d = q - p[:, :3]
                    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                    j = p[:, 3].astype(np.int64)
                    keep = j != i if exclude_self else np.ones(len(j), bool)
                    ds.append(d2[keep])
                    js.append(j[keep])
                    d_all, j_all = np.concatenate(ds), np.concatenate(js)
                    best = np.lexsort((j_all, d_all))[:k]
                    kd = d_all[best[-1]] if len(best) == k else np.inf
            d_all, j_all = np.concatenate(ds), np.concatenate(js)
            best = np.lexsort((j_all, d_all))[:k]
            gap = np.inf
            for a in range(3):
                if kq[a] + r + 1 <= kmax[a]:
                    gap = min(gap, (base[a] + ((kq[a] + r + 1) << level)) * h - q[a])
                if kq[a] - r - 1 >= 0:
                    gap = min(gap, q[a] - (base[a] + ((kq[a] - r) << level)) * h)
            g = gap - slack
            if gap == np.inf or (g > 0 and kd < (g * g) * (1 - 1e-12)):
                d2_out[i], idx_out[i] = d_all[best], j_all[best]
                break
            if probes > kneighbors_cuda.PROBE_BUDGET:
                handed.append(i)
                break
            r += 1
    return handed


def _grid_search(src, dst, k, exclude_self):
    """The grid route in numpy; a query handed to the rescue pass takes the
    plain version's row, as that pass scans every point. Returns d2,
    indices and the number of queries rescued."""
    plain = kneighbors_cuda.knn_ref(torch.from_numpy(src), torch.from_numpy(dst), k, exclude_self)
    d2_out = np.full(plain[0].shape, np.nan)
    idx_out = np.full(plain[1].shape, -1)
    rescued = _grid_pass(src, dst, k, exclude_self, range(len(src)), d2_out, idx_out)
    d2_out[rescued], idx_out[rescued] = plain[0].numpy()[rescued], plain[1].numpy()[rescued]
    return d2_out, idx_out, len(rescued)


@pytest.mark.parametrize("case", [name for name, *_ in exp_knn.hazard_sets(0, scale=0.05)])
def test_grid_search_stop_rule_gives_the_plain_version(case):
    """The grid search, simulated over the plain cell index, on the hazard
    sets: bit for bit with the plain version (a query it hands to the rescue
    pass takes the plain row)."""
    name, src, dst, k, excl = next(s for s in exp_knn.hazard_sets(0, scale=0.05) if s[0] == case)
    d2, idx, rescued = _grid_search(src, dst, k, excl)
    want = kneighbors_cuda.knn_ref(torch.from_numpy(src), torch.from_numpy(dst), k, excl)
    print(f"{case}: {len(src)} queries, {len(dst)} points, k = {k}, rescued {rescued}")
    assert np.array_equal(_bits(d2), _bits(want[0].numpy()))
    assert np.array_equal(idx, want[1].numpy())


@pytest.mark.parametrize("eps", [0.3, 0.8])
def test_voxel_edges_plain_equals_a_numpy_pair_test(eps):
    rng = np.random.default_rng(int(eps * 10))
    pts = rng.uniform(-2, 2, size=(700, 3))
    ij = np.floor(pts / eps).astype(np.int64)
    keys, inv = np.unique(ij, axis=0, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(inv))])
    edges = cluster_cuda.voxel_edges(torch.from_numpy(pts[order]), torch.from_numpy(keys),
                                     torch.from_numpy(offsets), eps).numpy()
    lookup = {tuple(k): v for v, k in enumerate(keys)}
    want = np.full_like(edges, -1)
    for v, key in enumerate(keys):
        for o, off in enumerate(cluster_cuda.OFFSETS):
            nb = lookup.get(tuple(key + off))
            if nb is not None:
                a = pts[order][offsets[v]:offsets[v + 1]]
                b = pts[order][offsets[nb]:offsets[nb + 1]]
                if (((a[:, None] - b[None]) ** 2).sum(-1) <= eps * eps).any():
                    want[v, o] = nb
    assert np.array_equal(edges, want) and (edges >= 0).any()


# --- cleanup ---------------------------------------------------------------


@pytest.mark.parametrize("seed,k,std", [(0, 20, 2.0), (1, 10, 1.5), (2, 5, 1.0), (3, 50, 2.0)])
def test_sor_matches_jax(seed, k, std):
    xyz = _cloud(seed)
    dj = jclean._knn_mean_dists(xyz, k)
    dt = tclean._knn_mean_dists(xyz, k, device=CPU).numpy()
    rel = np.max(np.abs(dt - dj) / dj)
    print(f"SOR mean distances: max relative difference {rel:.3g}")
    assert rel <= 1e-12
    assert np.array_equal(tpp.sor_denoise(xyz, k, std, device=CPU), jpp.sor_denoise(xyz, k, std))


@pytest.mark.parametrize("seed,thr", [(0, 0.2), (3, 0.1), (4, 0.05)])
def test_ransac_matches_jax(seed, thr):
    xyz = _cloud(seed)
    pj, ij = jpp.ransac_ground_plane(xyz, thr, seed=seed)
    pt, it = tpp.ransac_ground_plane(xyz, thr, seed=seed, device=CPU)
    assert np.abs(pt - pj).max() <= 1e-9
    assert np.array_equal(it, ij)
    assert pt[2] > 0.99


@pytest.mark.parametrize("seed,eps,min_points", [(0, 0.5, 10), (1, 0.8, 5), (5, 0.3, 3)])
def test_euclidean_clusters_labels_equal_jax(seed, eps, min_points):
    xyz = _cloud(seed)
    lj = jpp.euclidean_clusters(xyz, eps, min_points)
    lt = tpp.euclidean_clusters(xyz, eps, min_points, device=CPU)
    assert lt.dtype == lj.dtype and np.array_equal(lt, lj)
    assert lj.max() >= 1 and (lj < 0).any()


def test_euclidean_clusters_chained_voxels_and_empty_input():
    # a chain of points ~eps apart over many voxels, visited out of order:
    # the union order decides the roots, hence the labels' numbering
    rng = np.random.default_rng(7)
    t = np.linspace(0, 30, 300)
    chains = [np.column_stack([t, np.sin(t) * 3 + c, np.cos(t) + c]) for c in (0, 10, 20)]
    xyz = rng.permutation(np.vstack(chains + [rng.uniform(-5, 35, (40, 3))]))
    for eps in (0.4, 0.6):
        assert np.array_equal(tpp.euclidean_clusters(xyz, eps, 4, device=CPU),
                              jpp.euclidean_clusters(xyz, eps, 4))
    assert tpp.euclidean_clusters(np.zeros((0, 3)), device=CPU).shape == (0,)


@pytest.mark.parametrize("kw", [
    {"sor_neighbors": 10, "sor_std": 1.5},
    {"sor_neighbors": 20, "sor_std": 2.0, "cluster_eps": 0.5, "cluster_min_points": 10},
    {"min_intensity": 10.0, "sor_neighbors": 8, "sor_std": 1.0, "cluster_eps": 0.7,
     "cluster_min_points": 5},
    {"sor_neighbors": 40, "sor_std": 2.0, "cluster_eps": 0.5, "cluster_min_points": 10},
])
def test_denoise_slam_map_matches_jax(kw):
    xyz = _cloud(11)
    inten = np.random.default_rng(11).uniform(0, 100, len(xyz))
    assert np.array_equal(tpp.denoise_slam_map(xyz, inten, device=CPU, **kw),
                          jpp.denoise_slam_map(xyz, inten, **kw))


def test_bounding_boxes_and_intensity_filter_match_jax():
    xyz = _cloud(3)
    labels = jpp.euclidean_clusters(xyz, 0.5, 5)
    bj, bt = jpp.cluster_bounding_boxes(xyz, labels), tpp.cluster_bounding_boxes(xyz, labels)
    assert len(bj) == len(bt) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
        for a, b in zip(bj, bt))
    inten = np.linspace(0, 10, 50)
    assert np.array_equal(tpp.intensity_filter(inten, 5.0), jpp.intensity_filter(inten, 5.0))


# --- alignment ---------------------------------------------------------------


def _path(n=200):
    t = np.linspace(0, 6, n)
    return np.column_stack([t * 15, 10 * np.sin(t)])


def test_match_by_timestamp_and_report_match_jax():
    rng = np.random.default_rng(2)
    a, b = np.sort(rng.uniform(0, 100, 80)), rng.uniform(0, 100, 60)
    for tol in (0.1, 0.5, 2.0):
        for x, y in zip(tpp.match_by_timestamp(a, b, tol), jpp.match_by_timestamp(a, b, tol)):
            assert np.array_equal(x, y)
    sim = jpp.Similarity2D(1.1, 0.3, 2.0, -1.0)
    src = _path()
    dst = src + rng.normal(size=src.shape)
    assert talign.alignment_report(talign.Similarity2D(**sim.to_dict()), src, dst) == \
        jalign.alignment_report(sim, src, dst)


@pytest.mark.parametrize("with_scale", [True, False])
def test_fit_similarity_matches_jax(with_scale):
    rng = np.random.default_rng(4)
    src = _path()
    dst = jpp.Similarity2D(1.3, 0.4, 5.0, -2.0).apply(src) + rng.normal(size=src.shape) * 0.3
    fj = jpp.fit_similarity_2d(src, dst, with_scale)
    ft = tpp.fit_similarity_2d(src, dst, with_scale, device=CPU)
    assert np.allclose(list(ft.to_dict().values()), list(fj.to_dict().values()),
                       rtol=0, atol=1e-9)


@pytest.mark.parametrize("trim,iters", [(0.9, 40), (1.0, 30)])
def test_icp_2d_matches_jax(trim, iters):
    rng = np.random.default_rng(5)
    src = _path()
    dst = jpp.Similarity2D(1.3, 0.4, 5.0, -2.0).apply(src)[rng.permutation(len(src))]
    init = jpp.Similarity2D(scale=1.15, theta=0.3, tx=8.0, ty=-5.0)
    sj, rj = jpp.icp_2d_with_scale(src, dst, iters, init, trim)
    st, rt = tpp.icp_2d_with_scale(src, dst, iters, talign.Similarity2D(**init.to_dict()), trim,
                                   device=CPU)
    assert np.allclose(list(st.to_dict().values()), list(sj.to_dict().values()),
                       rtol=0, atol=1e-9)
    assert abs(rt - rj) <= 1e-9


# --- georeferencing ----------------------------------------------------------


def _enu64(lat0, lon0, alt0, lat, lon, alt):
    """Float64 WGS84 -> ENU at (lat0, lon0, alt0): the numpy reference."""
    a, f = 6378137.0, 1.0 / 298.257223563
    e2 = f * (2 - f)

    def ecef(la, lo, h):
        la, lo = np.radians(la), np.radians(lo)
        n = a / np.sqrt(1 - e2 * np.sin(la) ** 2)
        return np.stack([(n + h) * np.cos(la) * np.cos(lo), (n + h) * np.cos(la) * np.sin(lo),
                         (n * (1 - e2) + h) * np.sin(la)], -1)

    la, lo = np.radians(lat0), np.radians(lon0)
    rot = np.array([[-np.sin(lo), np.cos(lo), 0],
                    [-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo), np.cos(la)],
                    [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)]])
    return (ecef(lat, lon, alt) - ecef(lat0, lon0, alt0)) @ rot.T


def test_georeference_trajectory_matches_jax_within_float32_geodesy(capsys):
    n = 60
    rng = np.random.default_rng(6)
    stamps = np.arange(n) * 1.0
    slam = np.column_stack([np.linspace(0, 150, n), np.sin(np.linspace(0, 6, n)) * 12,
                            rng.normal(size=n) * 0.1])
    enu = jpp.Similarity2D(1.02, 0.3, 100.0, -50.0).apply(slam[:, :2])
    # fixes from the ENU path, converted in float64 around a Hong Kong anchor
    lat0, lon0 = 22.3193, 114.1694
    m_lat, m_lon = 1 / 110_760.0, 1 / (111_320.0 * np.cos(np.radians(lat0)))
    gps_lat, gps_lon = lat0 + enu[:, 1] * m_lat, lon0 + enu[:, 0] * m_lon
    gps_alt = np.full(n, 10.0)
    gps_t = stamps + 0.05
    lj, oj, sj, rj = jgeoref.georeference_trajectory(stamps, slam, gps_t, gps_lat, gps_lon,
                                                     gps_alt)
    lt, ot, st, rt = tgeoref.georeference_trajectory(stamps, slam, gps_t, gps_lat, gps_lon,
                                                     gps_alt, device=CPU)
    truth = _enu64(gps_lat[0], gps_lon[0], gps_alt[0], gps_lat, gps_lon, gps_alt)
    ref = _enu64(gps_lat[0], gps_lon[0], gps_alt[0], lj, oj, np.zeros(n))
    port = _enu64(gps_lat[0], gps_lon[0], gps_alt[0], lt, ot, np.zeros(n))
    between = np.linalg.norm((port - ref)[:, :2], axis=1).max()
    to64_j = np.linalg.norm((ref - truth)[:, :2], axis=1).max()
    to64_t = np.linalg.norm((port - truth)[:, :2], axis=1).max()
    with capsys.disabled():
        print(f"\ngeoreference: port vs JAX {between:.3f} m; against float64: JAX "
              f"{to64_j:.3f} m, port {to64_t:.3f} m; theta diff "
              f"{abs(st.theta - sj.theta):.2e} rad, scale diff {abs(st.scale - sj.scale):.2e}")
    assert lt.dtype == lj.dtype == np.float32
    assert between <= 3.0 and to64_j <= 2.0 and to64_t <= 2.0
    assert abs(st.theta - sj.theta) <= 1e-3 and abs(st.scale - sj.scale) <= 1e-3
    assert rt["n_pairs"] == rj["n_pairs"] == n


def test_alignment_params_and_pcd_files_equal_jax(tmp_path):
    from fastliosam_tpu.io.pcd import write_pcd

    sim = jpp.Similarity2D(1.1, 0.2, 3.0, 4.0, 1.0)
    tgeoref.save_alignment_params(str(tmp_path / "t.json"), talign.Similarity2D(**sim.to_dict()),
                                  extra={"note": "x"})
    jgeoref.save_alignment_params(str(tmp_path / "j.json"), sim, extra={"note": "x"})
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tgeoref.load_alignment_params(str(tmp_path / "j.json")).to_dict() == sim.to_dict()
    rng = np.random.default_rng(8)
    cloud = np.zeros(100, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"), ("intensity", "f4")])
    for k in ("x", "y", "z", "intensity"):
        cloud[k] = rng.normal(size=100) * 10
    write_pcd(str(tmp_path / "in.pcd"), cloud)
    tgeoref.georeference_pcd(str(tmp_path / "in.pcd"), str(tmp_path / "t.pcd"),
                             talign.Similarity2D(**sim.to_dict()))
    jgeoref.georeference_pcd(str(tmp_path / "in.pcd"), str(tmp_path / "j.pcd"), sim)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()


# --- map matching -------------------------------------------------------------


def _roads():
    xs = np.linspace(-100, 100, 9)
    return [np.column_stack([xs, np.zeros(9)]), np.array([[0.0, -100.0], [0.0, 100.0]]),
            np.column_stack([xs, np.full(9, 40.0)]),
            np.array([[-100.0, -40.0], [-20.0, -45.0], [60.0, -38.0], [100.0, -40.0]])]


def test_project_and_match_trajectory_match_jax():
    rng = np.random.default_rng(9)
    jnet, tnet = jmm.RoadNetwork(_roads()), tmm.RoadNetwork(_roads())
    for p in rng.uniform(-120, 120, size=(20, 2)):
        for a, b in zip(tnet.project_point(p, device=CPU), jnet.project_point(p)):
            assert np.allclose(a, b, rtol=0, atol=1e-9)
    leg1 = np.column_stack([np.linspace(-50, 0, 26), rng.normal(size=26) * 2.0])
    leg2 = np.column_stack([rng.normal(size=25) * 2.0, np.linspace(2, 50, 25)])
    traj = np.vstack([leg1, leg2, [[500.0, 500.0]]])
    for kw in ({}, {"sigma_obs": 4.0, "beta_transition": 0.5}, {"max_candidate_dist": 3.0}):
        ej, sj, mj = jmm.match_trajectory(traj, jnet, **kw)
        et, st, mt = tmm.match_trajectory(traj, tnet, device=CPU, **kw)
        assert np.array_equal(et, ej) and np.array_equal(mt, mj)
        assert np.allclose(st, sj, rtol=0, atol=1e-9)
        assert abs(tmm.route_length(st[mt]) - jmm.route_length(sj[mj])) <= 1e-9
    e, s, m = tmm.match_trajectory(np.array([[500.0, 500.0]]), tnet, device=CPU)
    assert e[0] == -1 and not m[0]


def test_osm_reader_matches_jax(tmp_path):
    lat0, lon0 = 22.3193, 114.1694
    xml = ['<?xml version="1.0"?>', "<osm version='0.6'>"]
    for i, (dx, dy) in enumerate([(-200, 0), (-50, 3), (50, -2), (200, 0), (0, 150)]):
        xml.append(f"  <node id='{i + 1}' lat='{lat0 + dy * 9e-6:.9f}' "
                   f"lon='{lon0 + dx * 9.7e-6:.9f}'/>")
    xml += ["  <way id='100'>", *[f"    <nd ref='{k}'/>" for k in (1, 2, 3, 4)],
            "    <tag k='highway' v='residential'/>", "  </way>",
            "  <way id='101'><nd ref='2'/><nd ref='5'/><tag k='highway' v='service'/></way>",
            "  <way id='102'><nd ref='1'/><nd ref='5'/><tag k='building' v='yes'/></way>",
            "</osm>"]
    path = tmp_path / "net.osm"
    path.write_text("\n".join(xml))
    for kw in ({}, {"origin": (lat0, lon0)}, {"highway_only": False}):
        (jn, jo), (tn, to) = (jmm.RoadNetwork.from_osm_xml(str(path), **kw),
                              tmm.RoadNetwork.from_osm_xml(str(path), device=CPU, **kw))
        assert jo == to and len(jn.edges) == len(tn.edges)
        for a, b in zip(tn.edges, jn.edges):
            # float32 geodesy in both packages: a few ulps of 200 m
            assert np.allclose(a, b, rtol=0, atol=1e-4)


# --- detection -----------------------------------------------------------------


def _head(seed, n=200, nc=3, distinct=True):
    rng = np.random.default_rng(seed)
    p = np.zeros((4 + nc, n), np.float32)
    p[:2] = rng.uniform(50, 590, (2, n))
    p[2:4] = rng.uniform(10, 120, (2, n))
    p[4:] = rng.uniform(0, 1, (nc, n)) if distinct else rng.integers(0, 4, (nc, n)) / 4
    return p[None]


@pytest.mark.parametrize("seed,conf,classes", [(0, 0.25, None), (1, 0.5, [0, 2]), (2, 0.99, None)])
def test_decode_yolo_and_nms_equal_jax_on_distinct_scores(seed, conf, classes):
    raw = _head(seed)
    for layout in (raw, raw[0], raw[0].T.copy()):
        got = tdetect.decode_yolo(layout, conf, classes, device=CPU)
        want = jdetect.decode_yolo(layout, conf, classes)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    boxes = np.concatenate([raw[0, :2].T - raw[0, 2:4].T / 2, raw[0, :2].T + raw[0, 2:4].T / 2],
                           axis=1)
    scores = raw[0, 4]
    assert np.array_equal(tdetect.nms(boxes, scores, device=CPU), jdetect.nms(boxes, scores))
    # a head output already on a device decodes there
    t = tdetect.decode_yolo(torch.from_numpy(raw), conf, classes)
    assert all(np.array_equal(a, b) for a, b in zip(t, want))


def test_decode_yolo_tie_order_is_recorded(capsys):
    raw = _head(3, distinct=False)
    got = tdetect.decode_yolo(raw, 0.25, device=CPU)
    want = jdetect.decode_yolo(raw, 0.25)
    same_set = sorted(map(tuple, got[0].tolist())) == sorted(map(tuple, want[0].tolist()))
    with capsys.disabled():
        print(f"\ndecode_yolo on tied scores: {len(got[1])} vs {len(want[1])} detections, "
              f"same order {np.array_equal(got[0], want[0])}, same set {same_set}")


def test_torchscript_detector_matches_jax(tmp_path):
    class Head(torch.nn.Module):
        def forward(self, x):
            out = torch.zeros(1, 7, 16)
            out[0, :4, 0] = torch.tensor([64.0, 64.0, 32.0, 32.0])
            out[0, 4, 0] = 0.75
            out[0, :4, 1] = torch.tensor([20.0, 30.0, 10.0, 12.0])
            out[0, 6, 1] = 0.6 + x.mean()
            return out

    path = tmp_path / "head.pt"
    torch.jit.script(Head()).save(str(path))
    tdet = tdetect.YoloDetector(str(path), imgsz=64, conf=0.25, device=CPU)
    jdet = jdetect.YoloDetector(str(path), imgsz=64, conf=0.25)
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    raw = tdet.model(x)
    assert isinstance(raw, torch.Tensor) and raw.device.type == "cpu"
    assert np.array_equal(raw.numpy(), jdet.model(x))
    for a, b in zip(tdetect.decode_yolo(raw, 0.25), jdetect.decode_yolo(jdet.model(x), 0.25)):
        assert np.array_equal(a, b)
    if jimages.HAS_CV2:
        img = (np.random.default_rng(1).uniform(0, 255, (48, 64, 3))).astype(np.uint8)
        for a, b in zip(tdet(img), jdet(img)):
            assert np.array_equal(a, b)


@needs_cv2
def test_detector_pipeline_and_directory_match_jax(tmp_path):
    import cv2

    def model(x):
        return np.asarray(_head(int(x.sum()) % 7))

    img = np.random.default_rng(2).uniform(0, 255, (480, 640, 3)).astype(np.uint8)
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "a.png"), img)
    cv2.imwrite(str(src / "b.png"), img[::-1].copy())
    for mode in ("annotate", "blur"):
        mt = tdetect.predict_directory(str(src), str(tmp_path / f"t{mode}"),
                                       tdetect.YoloDetector(model, device=CPU), mode=mode)
        mj = jdetect.predict_directory(str(src), str(tmp_path / f"j{mode}"),
                                       jdetect.YoloDetector(model), mode=mode)
        assert mt == mj and sum(map(len, mt.values())) > 0
        for name in ("a.png", "b.png", "detections.json"):
            assert (tmp_path / f"t{mode}" / name).read_bytes() == \
                (tmp_path / f"j{mode}" / name).read_bytes()
    for a, b in zip(tdetect.letterbox(img, 320), jdetect.letterbox(img, 320)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(tdetect.to_chw(img), jdetect.to_chw(img))
    boxes = np.array([[10.0, 20.0, 30.0, 40.0]])
    assert np.array_equal(tdetect.scale_boxes(boxes, 0.5, (3, 7)),
                          jdetect.scale_boxes(boxes, 0.5, (3, 7)))


# --- images and plots ---------------------------------------------------------

CAM_ARGS = dict(fx=500.0, fy=510.0, cx=320.0, cy=240.0, width=640, height=480)


@needs_cv2
@pytest.mark.parametrize("dist", [[0.1, -0.05, 0.001, 0.001, 0.01, 0.02, -0.01, 0.005],
                                  [0.1, -0.05, 0.001, 0.001, 0.01], [0.0] * 4, []])
def test_camera_project_matches_cv2(dist):
    import cv2

    rng = np.random.default_rng(len(dist))
    pts = np.column_stack([rng.uniform(-2, 2, 300), rng.uniform(-2, 2, 300),
                           rng.uniform(-1, 9, 300)])
    cam = timages.CameraModel(dist_coeffs=dist, **CAM_ARGS)
    px, in_front = cam.project(pts, device=CPU)
    want, _ = cv2.projectPoints(pts.reshape(-1, 1, 3), np.zeros(3), np.zeros(3), cam.K,
                                cam.dist)
    err = np.abs(px - want.reshape(-1, 2)).max()
    print(f"project vs cv2.projectPoints: max {err:.3g} px")
    assert err <= 1e-9
    jpx, jfront = jimages.CameraModel(dist_coeffs=dist, **CAM_ARGS).project(pts)
    assert np.array_equal(in_front, jfront) and np.abs(px - jpx).max() <= 1e-9


@needs_cv2
def test_colorize_and_cluster_projection_match_jax():
    import cv2

    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
    pts = np.column_stack([rng.uniform(-3, 3, 500), rng.uniform(-2, 2, 500),
                           rng.uniform(-1, 8, 500)])
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    dist = [0.1, -0.05, 0.001, 0.001, 0.01, 0.0, 0.0, 0.0]
    tc, jc = (timages.CameraModel(dist_coeffs=dist, **CAM_ARGS),
              jimages.CameraModel(dist_coeffs=dist, **CAM_ARGS))
    for a, b in zip(timages.colorize_cloud(pts, img, tc, T, device=CPU),
                    jimages.colorize_cloud(pts, img, jc, T)):
        assert np.array_equal(a, b)
    cv2.setRNGSeed(0)
    out_t, lab_t = timages.project_clusters_to_image(pts, img, tc, T, k=3, device=CPU)
    cv2.setRNGSeed(0)
    out_j, lab_j = jimages.project_clusters_to_image(pts, img, jc, T, k=3)
    assert np.array_equal(lab_t, lab_j) and np.array_equal(out_t, out_j)


@needs_cv2
def test_image_ops_match_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
    bright = np.clip(img.astype(int) + 120, 0, 255).astype(np.uint8)
    for name in ("clahe_adjust", "fix_overexposure", "tonemap_hdr", "detect_exposure"):
        for x in (img, bright, img // 5):
            a, b = getattr(timages, name)(x), getattr(jimages, name)(x)
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    boxes = [(10, 10, 60, 50), (100, 20, 150, 90)]
    assert np.array_equal(timages.blur_regions(img, boxes), jimages.blur_regions(img, boxes))
    (a, na), (b, nb) = (timages.anonymize_image(img, lambda im: boxes),
                        jimages.anonymize_image(img, lambda im: boxes))
    assert na == nb and np.array_equal(a, b)


def test_plots_and_html_map_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    t = np.linspace(0, 6, 100)
    pos = np.column_stack([np.cos(t) * 10, np.sin(t) * 10, t * 0.1])
    for mod, tag in ((tplots, "t"), (jplots, "j")):
        mod.plot_trajectory(pos, str(tmp_path / f"{tag}.png"), gps_positions=pos[::10])
        mod.plot_trajectory_3d(pos, str(tmp_path / f"{tag}3d.png"))
        mod.write_html_map(22.3 + pos[:, 1] * 1e-5, 114.2 + pos[:, 0] * 1e-5,
                           str(tmp_path / f"{tag}.html"), gps_lat=pos[::7, 0],
                           gps_lon=pos[::7, 1])
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    for name in ("{}.png", "{}3d.png"):
        assert (tmp_path / name.format("t")).stat().st_size > 1000
