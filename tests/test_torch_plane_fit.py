"""The plane refresh of the port's map insert (``ops/plane_fit_cuda.py``:
the plain version of ``csrc/plane_fit.cu``) against the JAX package, and
the e_x fallback of ``core/eigh3.py`` without its host round trip.

Tolerances and why:
  * against JAX's ``insert(..., refresh_planes=True)``, both refitting the
    same moments (JAX's, carried across): ``plane_valid`` equal everywhere;
    where JAX's plane is valid, normals within 1e-5 / g and d within
    1e-5 (1 + |centre|) / g, g = min(1, (l1 - l0) / l2) of the voxel's
    covariance: two float32 closed forms whose eigenvalues differ by a few
    ulps of l2 turn the normal by about that over the relative gap (a
    4-point voxel with g = 0.005 differs by 5e-4, its d by 1.5e-4);
  * against the composition the plain version replaces (``_fit_planes``
    and its three drop-row scatters), and ``eigh3`` against its previous
    fallback: bit for bit, since the CPU results must not move.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.core import eigh3 as j_eigh3  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu_torch.convert import voxel_map_from_numpy  # noqa: E402
from fastliosam_tpu_torch.core import eigh3 as t_eigh3  # noqa: E402
from fastliosam_tpu_torch.core import segment  # noqa: E402
from fastliosam_tpu_torch.core.voxel import voxel_center  # noqa: E402
from fastliosam_tpu_torch.map import voxel_hash as tvh  # noqa: E402
from fastliosam_tpu_torch.ops import gather_cuda, insert_cuda, plane_fit_cuda  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402
from test_torch_voxel_hash import CFGS, _port_cfg, _surfels, j_insert  # noqa: E402


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# core/eigh3.py: the e_x fallback
# ---------------------------------------------------------------------------
def _old_eigvec(A, lam, other1, other2):
    """``core/eigh3.py: _eigvec`` as it was, its fallback set through a
    0-dim slice (a host round trip on the card)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - other1[..., None, None] * eye) @ (A - other2[..., None, None] * eye)
    norms = torch.sum(M * M, dim=-2)
    k = torch.argmax(norms, dim=-1)
    col = torch.gather(M, -1, k[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    n = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    fallback = torch.zeros_like(col)
    fallback[..., 0] = 1.0
    safe = n[..., 0] > 1e-20
    return torch.where(safe[..., None], col / torch.clamp(n, min=1e-12), fallback)


def _repeated():
    """Matrices with a repeated eigenvalue and the exact eigenvalues whose
    product (A - o1 I)(A - o2 I) is exactly zero: the fallback's case."""
    A = np.stack([np.diag([1.0, 1.0, 3.0]), np.diag([2.0, 5.0, 5.0]),
                  np.diag([0.5, 0.5, 0.5]), np.zeros((3, 3))]).astype(np.float32)
    o1 = np.array([1.0, 5.0, 0.5, 0.0], np.float32)
    o2 = np.array([3.0, 2.0, 0.5, 0.0], np.float32)
    return A, o1, o2


@pytest.mark.parametrize("batched", [False, True])
def test_eigvec_fallback_matches_jax(batched):
    A, o1, o2 = _repeated()
    cases = [(A, o1, o2)] if batched else [(A[k], o1[k], o2[k]) for k in range(len(A))]
    for a, p, q in cases:
        lam = np.zeros_like(p)
        got = t_eigh3._eigvec(T(a), T(lam), T(p), T(q))
        want = j_eigh3._eigvec(jnp.asarray(a), jnp.asarray(lam), jnp.asarray(p), jnp.asarray(q))
        assert got.shape == a.shape[:-1]
        np.testing.assert_array_equal(N(got), N(want))
        np.testing.assert_array_equal(N(got).reshape(-1, 3),
                                      np.tile([1.0, 0.0, 0.0], (N(got).size // 3, 1)))
        assert torch.equal(_bits(got), _bits(_old_eigvec(T(a), T(lam), T(p), T(q))))


@pytest.mark.parametrize("batched", [False, True])
def test_eigh3_unchanged_bit_for_bit(rng, monkeypatch, batched):
    """``eigh3`` and ``smallest_eigvec3`` give the words they gave with the
    old fallback, on seeded symmetric matrices and the repeated ones."""
    X = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = np.concatenate([X @ X.transpose(0, 2, 1), _repeated()[0]])
    mats = [T(A)] if batched else [T(a) for a in A[::17]]
    got = [(t_eigh3.eigh3(a), t_eigh3.smallest_eigvec3(a)) for a in mats]
    monkeypatch.setattr(t_eigh3, "_eigvec", _old_eigvec)
    for a, ((lam, V), (v0, lam0)) in zip(mats, got):
        (want_lam, want_V), (want_v0, want_lam0) = t_eigh3.eigh3(a), t_eigh3.smallest_eigvec3(a)
        for x, y in ((lam, want_lam), (V, want_V), (v0, want_v0), (lam0, want_lam0)):
            assert torch.equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# ops/plane_fit_cuda.py: the plane refresh
# ---------------------------------------------------------------------------
def _refresh_inputs(rng, cfg, lanes):
    """For each lane: the JAX map after a first insert (planes refreshed),
    JAX's second insert without and with the refresh, and the port's slots
    of that second insert (the probe is bit for bit JAX's). Returns the
    port's tables (moments of JAX's second insert, the first insert's plane
    tables; lane-major when ``lanes``), the slots, and JAX's refreshed maps."""
    pcfg = _port_cfg(cfg)
    before, after, refreshed, slots = [], [], [], []
    for lane in range(lanes or 1):
        pts, mask = _surfels(rng, shift=(0.3 * lane, -0.2, 0.0))
        pts2, mask2 = _surfels(rng, shift=(0.7, -0.4 + 0.5 * lane, 0.1))
        jm0, _ = j_insert(jvh.make_map(cfg), jnp.asarray(pts), jnp.asarray(mask), cfg, True)
        jm1, _ = j_insert(jm0, jnp.asarray(pts2), jnp.asarray(mask2), cfg, False)
        jm2, _ = j_insert(jm0, jnp.asarray(pts2), jnp.asarray(mask2), cfg, True)
        tm0 = voxel_map_from_numpy(tree_np(jm0), device="cpu")
        sl = insert_cuda.insert_claim_ref(
            tm0.fp, tm0.coords, tm0.moments, T(pts2), T(mask2), pcfg.voxel_size,
            max(pcfg.insert_probes, pcfg.claim_probes), pcfg.max_points_per_voxel)[2]
        before.append(tm0)
        after.append(voxel_map_from_numpy(tree_np(jm1), device="cpu"))
        refreshed.append(tree_np(jm2))
        slots.append(sl)
    stack = (lambda ts: torch.stack(ts)) if lanes else (lambda ts: ts[0])
    tables = (stack([m.moments for m in after]), stack([m.coords for m in after]),
              stack(slots), stack([m.normal for m in before]), stack([m.d for m in before]),
              stack([m.plane_valid for m in before]))
    return tables, refreshed


def _relative_gap(moments):
    """min(1, (l1 - l0) / l2) of each row's covariance, in float64."""
    m = moments.double()
    c = torch.clamp(m[:, 0], min=1.0)
    mean = m[:, 1:4] / c[:, None]
    cov = plane_fit_cuda.unpack_sym(m[:, 4:10]) / c[:, None, None] - (
        mean[:, :, None] * mean[:, None, :])
    lam = np.linalg.eigvalsh(N(cov))
    return np.minimum(1.0, (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-30))


def _cfg_args(cfg):
    return cfg.voxel_size, cfg.min_points, cfg.plane_var_thresh


@pytest.mark.parametrize("lanes", [None, 2])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_refresh_planes_ref_matches_jax(rng, name, lanes):
    cfg = CFGS[name]
    tables, refreshed = _refresh_inputs(rng, cfg, lanes)
    cap = cfg.capacity
    sl = tables[2]
    if name == "tight":
        assert bool((sl == cap).any())  # drop rows: the writes JAX drops
    normal, d, pv = plane_fit_cuda.refresh_planes_ref(*tables, *_cfg_args(cfg))
    for b, jm in enumerate(refreshed):
        pick = (lambda t: t[b]) if lanes else (lambda t: t)
        np.testing.assert_array_equal(N(pick(pv)), jm.plane_valid)
        v = jm.plane_valid > 0
        assert v.sum() > 10
        g = _relative_gap(pick(tables[0]))[v]
        centre = np.linalg.norm(N(pick(tables[1]))[v] * cfg.voxel_size, axis=-1)
        dn = np.abs(N(pick(normal))[v] - jm.normal[v]).max(-1)
        dd = np.abs(N(pick(d))[v] - jm.d[v])
        assert np.all(dn <= 1e-5 / g), (dn.max(), g[dn.argmax()])
        assert np.all(dd <= 1e-5 * (1.0 + centre) / g), (dd.max(), g[dd.argmax()])


def _old_refresh(moments, coords, slots, normal, d, plane_valid, cfg):
    """``map/voxel_hash.py``'s plane refresh as it was: ``_fit_planes`` (two
    row gathers, the covariance, ``smallest_eigvec3``) and three scatters
    through drop rows."""
    lm = moments.dim() == 3
    cap = cfg.capacity
    mom = gather_cuda.gather_rows(moments, slots, lane_major=lm)
    c = mom[..., 0]
    safe_c = torch.clamp(c, min=1.0)
    mean_rel = mom[..., 1:4] / safe_c[..., None]
    cov = plane_fit_cuda.unpack_sym(mom[..., 4:10]) / safe_c[..., None, None] - (
        mean_rel[..., :, None] * mean_rel[..., None, :])
    nrm, lam = t_eigh3.smallest_eigvec3(cov)
    center = voxel_center(gather_cuda.gather_rows(coords, slots, lane_major=lm), cfg.voxel_size)
    dd = -torch.sum(nrm * (center + mean_rel), dim=-1)
    pv = ((c >= cfg.min_points) & (lam[..., 0] < cfg.plane_var_thresh)).to(torch.int32)
    rows = segment.lane_rows(slots, cap + 1) if lm else slots
    out = []
    for table, value in ((normal, nrm), (d, dd), (plane_valid, pv)):
        t = segment.with_drop_row(table, lm)
        t[rows] = value
        out.append(segment.without_drop_row(t, cap, lm))
    return out


@pytest.mark.parametrize("lanes", [None, 2])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_refresh_planes_ref_bit_for_bit_the_old_composition(rng, name, lanes):
    cfg = CFGS[name]
    tables, _ = _refresh_inputs(rng, cfg, lanes)
    copies = [t.clone() for t in tables]
    launched = plane_fit_cuda.launches
    got = plane_fit_cuda.refresh_planes(*tables, *_cfg_args(cfg))
    assert plane_fit_cuda.launches == launched  # CPU tensors: the plain version
    for x, y in zip(got, _old_refresh(*tables, cfg)):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))
    for t, c in zip(tables, copies):  # the inputs stay untouched
        assert torch.equal(t, c)


@pytest.mark.parametrize("lanes", [None, 2])
def test_insert_refreshes_through_the_plain_version(rng, lanes):
    """``insert(refresh_planes=True)`` is the insert without it plus
    :func:`refresh_planes_ref` at the insert's slots, bit for bit, and only
    the touched rows change."""
    cfg = _port_cfg(CFGS["tight"])
    m = tvh.make_map(cfg, "cpu", lanes=lanes)
    batch = []
    for _ in range(lanes or 1):
        pts, mask = _surfels(rng)
        batch.append((T(pts), T(mask)))
    xyz = torch.stack([p for p, _ in batch]) if lanes else batch[0][0]
    mask = torch.stack([k for _, k in batch]) if lanes else batch[0][1]
    m, _ = tvh.insert(m, cfg, xyz, mask, refresh_planes=True)
    shifted = xyz + torch.tensor([0.6, -0.3, 0.05])
    plain, _ = tvh.insert(m, cfg, shifted, mask, refresh_planes=False)
    full, _ = tvh.insert(m, cfg, shifted, mask, refresh_planes=True)
    sl = insert_cuda.insert_claim_ref(m.fp, m.coords, m.moments, shifted, mask, cfg.voxel_size,
                                      max(cfg.insert_probes, cfg.claim_probes),
                                      cfg.max_points_per_voxel)[2]
    want = plane_fit_cuda.refresh_planes_ref(plain.moments, plain.coords, sl, m.normal, m.d,
                                             m.plane_valid, *_cfg_args(cfg))
    for name, w in zip(("normal", "d", "plane_valid"), want):
        assert torch.equal(_bits(getattr(full, name)), _bits(w))
    touched = torch.zeros(m.d.shape, dtype=torch.bool)
    if lanes:
        for b in range(lanes):
            touched[b, sl[b][sl[b] < cfg.capacity]] = True
    else:
        touched[sl[sl < cfg.capacity]] = True
    assert torch.equal(full.d[~touched], m.d[~touched])
    assert bool((full.plane_valid[touched] > 0).any())


def test_refresh_planes_hbm_bytes():
    cap = 1 << 10
    sl = np.array([0, 1, 1, cap, 40, 1000], np.int64)  # one drop row, one duplicate
    rows = np.array([0, 1, 40, 1000])
    want = (6 * 8 + gather_cuda.sector_bytes(rows, 10) + gather_cuda.sector_bytes(rows, 3)
            + 2 * cap * 20)
    assert plane_fit_cuda.hbm_bytes(sl, cap) == want
    lanes = plane_fit_cuda.hbm_bytes(np.stack([sl, sl]), cap, lanes=2)
    assert lanes == (12 * 8 + 2 * gather_cuda.sector_bytes(rows, 10)
                     + 2 * gather_cuda.sector_bytes(rows, 3) + 4 * cap * 20)
    assert plane_fit_cuda.hbm_bytes(np.full(4, cap), cap) == 4 * 8 + 2 * cap * 20
