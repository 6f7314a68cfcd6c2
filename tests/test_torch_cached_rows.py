"""The cached-mode iEKF's rows (``ops/cached_rows_cuda.py: cached_rows``,
the plain version on the CPU) against the composition they replace and
against the JAX package.

Tolerances and why:
  * ``cached_rows_ref`` against the composition it replaces (the cached
    query of ``odom/iekf.py: _query_planes`` and the row code of its
    ``_map_step`` and ``_degeneracy_remap`` before the kernel, copied
    below): bit for bit, every output (the same float32 operations in the
    same order), with the probe on, off, gated by a device flag either
    way, after a carried association, with the extrinsic estimated or
    not; and 3 lanes bit for bit with each lane alone.
  * the port's cached ``iekf_update`` against its own run through the
    composition it replaces (the plain route of ``query_fn``): bit for
    bit, per-scan gate, device gate and lanes.
  * the port's cached ``iekf_update`` against the JAX package's
    ``iekf_update`` in ``query_mode="cached"`` on the same numpy inputs:
    pose within 1e-4 and the match counts within 2, the tolerance of
    ``test_torch_query_modes.py::test_odometry_modes_match_jax`` (JAX runs
    eagerly there: its voxel of a point on a boundary may differ from the
    port's reciprocal multiply).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu.odom import iekf as jiekf  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch.convert import nav_state_from_numpy, voxel_map_from_numpy  # noqa: E402
from fastliosam_tpu_torch.map import voxel_hash as tvh  # noqa: E402
from fastliosam_tpu_torch.odom import iekf as tiekf  # noqa: E402
from fastliosam_tpu_torch.ops import cached_rows_cuda, query_cuda  # noqa: E402

from _torch_parity import N, T, random_rotations, tree_np  # noqa: E402
from test_torch_query_modes import cached_map  # noqa: E402, F401
from test_torch_voxel_hash import _port_cfg, _surfels  # noqa: E402

J_ODOM = jodom.OdomConfig(query_mode="cached")
T_ODOM = todom.OdomConfig(**J_ODOM._asdict())


def _so3(w):
    """Rotation matrix of a rotation vector (float64 Rodrigues, float32 out)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _bits(t):
    t = N(t)
    return t.view(np.int32) if t.dtype == np.float32 else t


def _assert_bits_equal(got, want):
    for name, g, w in zip(cached_rows_cuda.CachedRows._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


# ---------------------------------------------------------------------------
# the composition that cached_rows replaces, as odom/iekf.py ran it
# ---------------------------------------------------------------------------
def _old_query(R, p, pts, mask, m, cfg):
    """``_query_planes`` in the cached mode."""
    pw = pts @ R.mT + p[..., None, :]
    n, d, valid = tvh.query_planes(m, cfg, pw, mask)
    return n, d, valid, torch.zeros(valid.shape, dtype=torch.float32)


def _old_rows(R, p, R_ext, q_b, p_l, planes, cfg, ext):
    """``_map_step``'s rows and ``_degeneracy_remap``'s confident weights."""
    plane_n, plane_d, assoc, rvar = planes
    pw = q_b @ R.mT + p[..., None, :]
    n = plane_n
    r = torch.sum(n * pw, dim=-1) + plane_d
    valid = assoc & (torch.abs(r) < cfg.max_residual)
    w = valid.to(torch.float32) / (cfg.point_cov + rvar)
    v = n @ R
    cols = [torch.linalg.cross(q_b, v, dim=-1), n]
    if ext:
        v_ext = v @ R_ext
        cols.append(torch.linalg.cross(p_l, v_ext, dim=-1))
        cols.append(v)
    A = torch.cat(cols, dim=-1)
    Aw = A * w[..., None]
    wc = (
        valid & (rvar < cfg.degen_conf_ratio * cfg.point_cov)
    ).to(torch.float32) * (1.0 / cfg.point_cov)
    return n, r, valid, A, Aw, wc, n * wc[..., None], torch.sum(valid.to(torch.int32), dim=-1)


def _scene(cached_map, seed=3):
    """The fixture's map and config, a true pose, and the body points of
    the fixture's queries at that pose with their masks."""
    cfg, jm, xyz, mask, _ = cached_map
    rng = np.random.default_rng(seed)
    R_true = _so3(random_rotations(rng, 1, 0.05)[0])
    p_true = np.array([0.3, -0.2, 0.1], np.float32)
    pb = ((xyz - p_true) @ R_true).astype(np.float32)
    return cfg, jm, R_true, p_true, pb, mask


def _rows_inputs(scene, ext, offset):
    cfg, jm, R_true, p_true, pb, mask = scene
    m = voxel_map_from_numpy(tree_np(jm), device="cpu")
    R = T(R_true @ _so3([0.004, -0.003, 0.002]))
    p = T(p_true + np.asarray(offset, np.float32))
    pts, msk = T(pb), T(mask)
    if ext:
        R_ext, t_ext = T(_so3([0.01, 0.02, -0.015])), T(np.array([0.05, -0.02, 0.1], np.float32))
        p_l = (pts - t_ext) @ R_ext
        q_b = p_l @ R_ext.mT + t_ext
    else:
        R_ext = p_l = None
        q_b = pts
    return m, _port_cfg(cfg), R, p, pts, msk, R_ext, p_l, q_b


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("case", ["probe", "carried", "flag_on", "flag_off"])
def test_cached_rows_ref_equals_the_composition(cached_map, case, ext):
    """Every output of ``cached_rows_ref`` bit for bit against the cached
    query and rows it replaces: a probe (at the body points with the
    extrinsic, as the first iteration), the association carried from a
    probe at another state, and the device flag on (a fresh probe) and off
    (the carried association)."""
    m, mcfg, R, p, pts, msk, R_ext, p_l, q_b = _rows_inputs(_scene(cached_map), ext,
                                                            (0.03, -0.02, 0.01))
    table = (m.fp, m.normal, m.d, m.plane_valid)
    tail = (mcfg.voxel_size, mcfg.query_probes, T_ODOM.point_cov, T_ODOM.max_residual,
            T_ODOM.degen_conf_ratio)
    kw = dict(p_l=p_l, R_ext=R_ext)
    # the association of a state 0.3 m away: a carried one that differs
    R0, p0 = R @ T(_so3([0.0, 0.0, 0.02])), p + T(np.array([0.3, 0.0, 0.0], np.float32))
    before = cached_rows_cuda.launches
    first = cached_rows_cuda.cached_rows(R0, p0, q_b, msk, table, None, True, *tail,
                                         q_query=pts if ext else None, **kw)
    carried = _old_query(R0, p0, pts if ext else q_b, msk, m, mcfg)
    _assert_bits_equal(first, (*_old_rows(R0, p0, R_ext, q_b, p_l, carried, T_ODOM, ext),
                               first.slots))
    probe = {"probe": True, "carried": False, "flag_on": torch.tensor(True),
             "flag_off": torch.tensor(False)}[case]
    got = cached_rows_cuda.cached_rows(R, p, q_b, msk, table, first.slots, probe, *tail,
                                       q_query=pts if ext and case == "probe" else None, **kw)
    assert cached_rows_cuda.launches == before  # the CPU runs the plain version
    if case in ("probe", "flag_on"):
        planes = _old_query(R, p, pts if ext and case == "probe" else q_b, msk, m, mcfg)
    else:
        planes = carried
    want = _old_rows(R, p, R_ext, q_b, p_l, planes, T_ODOM, ext)
    _assert_bits_equal(got, (*want, got.slots))
    # the slots are the association: -1 exactly where nothing was found,
    # and the rows of the others are the carried or fresh planes'
    valid_assoc = N(planes[2])
    assert (N(got.slots) >= 0)[valid_assoc].all()
    assert int(N(got.valid).sum()) > 200
    if case in ("carried", "flag_off"):
        np.testing.assert_array_equal(N(got.slots), N(first.slots))
    else:
        assert (N(got.slots) != N(first.slots)).any()


def _lane_maps(cfg, lanes, seed=11):
    """``lanes`` port maps with planes fitted (the plain insert on the CPU),
    each from surfels of another shift, stacked lane-major; and each lane's
    world queries and masks."""
    rng = np.random.default_rng(seed)
    maps, qs, ks = [], [], []
    for b in range(lanes):
        shift = (0.1 * b, -0.2 * b, 0.05 * b)
        m = tvh.make_map(cfg, device="cpu")
        for k in range(3):
            pts, mask = _surfels(rng, n=2000, shift=shift)
            m, _ = tvh.insert(m, cfg, T(pts), T(mask), refresh_planes=True)
        maps.append(m)
        q, qm = _surfels(rng, n=600, shift=shift)
        qs.append(q)
        ks.append(qm)
    return tvh.VoxelMap(*(torch.stack(f) for f in zip(*maps))), np.stack(qs), np.stack(ks)


def _lane_states(rng, lanes):
    R = np.stack([_so3(w) for w in random_rotations(rng, lanes, 0.03)])
    p = rng.normal(size=(lanes, 3)).astype(np.float32) * 0.2
    return R, p


@pytest.mark.parametrize("ext", [False, True])
def test_cached_rows_ref_lanes_equal_each_lane(ext):
    """3 lanes in one call: a flag that probes lanes 0 and 2 only, after a
    probe at other states; each lane bit for bit with its own call."""
    cfg = _port_cfg(jvh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=4))
    lanes = 3
    lm, q, qm = _lane_maps(cfg, lanes)
    rng = np.random.default_rng(5)
    R, p = _lane_states(rng, lanes)
    pts = T(np.einsum("bnk,bkj->bnj", q - p[:, None], R).astype(np.float32))
    msk = T(qm)
    R, p = T(R), T(p + 0.05)
    R_ext = T(np.stack([_so3([0.01, 0.0, 0.02 * b + 0.01]) for b in range(lanes)])) if ext \
        else None
    p_l = pts @ R_ext if ext else None
    q_b = (p_l @ R_ext.mT).contiguous() if ext else pts
    tail = (cfg.voxel_size, cfg.query_probes, 0.001, 1.0, 1.0)
    table = (lm.fp, lm.normal, lm.d, lm.plane_valid)
    first = cached_rows_cuda.cached_rows_ref(R, p + 0.3, q_b, msk, table, None, True, *tail,
                                             p_l=p_l, R_ext=R_ext)
    flag = torch.tensor([True, False, True])
    got = cached_rows_cuda.cached_rows_ref(R, p, q_b, msk, table, first.slots, flag, *tail,
                                           p_l=p_l, R_ext=R_ext)
    assert got.n_matched.shape == (lanes,) and int(got.n_matched.min()) > 50
    for b in range(lanes):
        one_first = cached_rows_cuda.cached_rows_ref(
            R[b], p[b] + 0.3, q_b[b], msk[b], tuple(t[b] for t in table), None, True, *tail,
            p_l=None if p_l is None else p_l[b], R_ext=None if R_ext is None else R_ext[b])
        _assert_bits_equal([t[b] for t in first], one_first)
        one = cached_rows_cuda.cached_rows_ref(
            R[b], p[b], q_b[b], msk[b], tuple(t[b] for t in table), one_first.slots,
            bool(flag[b]), *tail,
            p_l=None if p_l is None else p_l[b], R_ext=None if R_ext is None else R_ext[b])
        _assert_bits_equal([t[b] for t in got], one)


# ---------------------------------------------------------------------------
# iekf_update in the cached mode: against the composition it replaces and
# against the JAX package
# ---------------------------------------------------------------------------
def _old_route(vmap, map_cfg, pw, mask):
    """The cached query as ``query_fn``: iekf_update's plain route, the
    composition that the cached mode ran before ``cached_rows``."""
    n, d, valid = tvh.query_planes(vmap, map_cfg, pw, mask)
    return n, d, valid, torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)


CASES = {  # name: (gate_on_device, extrinsic_est_en, offset of p in m, requery_thresh)
    "per_scan": (False, False, (0.15, -0.1, 0.05), 0.125),
    "per_scan_still": (False, False, (0.02, -0.01, 0.0), 5.0),
    "gate_on_device": (True, False, (0.15, -0.1, 0.05), 0.125),
    "gate_on_device_still": (True, False, (0.02, -0.01, 0.0), 5.0),
    "extrinsic": (False, True, (0.15, -0.1, 0.05), 0.125),
}


def _navs(scene, ext, offset, thresh):
    cfg, jm, R_true, p_true, pb, mask = scene
    jcfg = J_ODOM._replace(extrinsic_est_en=ext, requery_thresh=thresh)
    nav = jodom.init_state(cfg=jcfg)._replace(
        R=jnp.asarray(R_true @ _so3([0.004, -0.003, 0.002])),
        p=jnp.asarray(p_true + np.asarray(offset, np.float32)))
    if ext:
        nav = nav._replace(R_ext=jnp.asarray(_so3([0.01, 0.02, -0.015])),
                           t_ext=jnp.asarray(np.array([0.05, -0.02, 0.1], np.float32)))
    return jcfg, nav


@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_iekf_matches_its_composition_and_jax(cached_map, case):
    """The port's cached ``iekf_update`` bit for bit against its run through
    the composition it replaces, with no host read in the cached route, and
    within the stated tolerance of JAX's ``iekf_update`` in the cached
    mode. The 15 cm offsets trip the re-query gate at the default
    threshold; the "still" cases' 5 m threshold keeps it shut."""
    from fastliosam_tpu_torch.utils import host_reads

    gate, ext, offset, thresh = CASES[case]
    scene = _scene(cached_map)
    cfg, jm, _, _, pb, mask = scene
    jcfg, jnav = _navs(scene, ext, offset, thresh)
    tcfg = todom.OdomConfig(**jcfg._asdict())
    tm = voxel_map_from_numpy(tree_np(jm), device="cpu")
    mcfg = _port_cfg(cfg)
    tnav = nav_state_from_numpy(tree_np(jnav), device="cpu")

    q0, r0 = query_cuda.launches, host_reads()
    tx, tn = tiekf.iekf_update(tnav, T(pb), T(mask), tm, mcfg, tcfg, gate_on_device=gate)
    assert host_reads() == r0  # the gate is a device flag
    assert query_cuda.launches == q0
    ox, on = tiekf.iekf_update(tnav, T(pb), T(mask), tm, mcfg, tcfg, gate_on_device=gate,
                               query_fn=_old_route)
    for a, b in zip(tx, ox):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(tn) == int(on)

    jx, jn = jiekf.iekf_update(jnav, jnp.asarray(pb), jnp.asarray(mask), jm, cfg, jcfg)
    assert int(jn) > 200 and abs(int(tn) - int(jn)) <= 2
    np.testing.assert_allclose(N(tx.p), N(jx.p), atol=1e-4)
    np.testing.assert_allclose(N(tx.R), N(jx.R), atol=1e-4)
    if ext:
        np.testing.assert_allclose(N(tx.R_ext), N(jx.R_ext), atol=1e-4)
        np.testing.assert_allclose(N(tx.t_ext), N(jx.t_ext), atol=1e-4)


def test_cached_iekf_lanes_match_the_composition():
    """A batched cached ``iekf_update`` (3 lanes, the device gate) bit for
    bit against its run through the composition it replaces."""
    cfg = _port_cfg(jvh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=4))
    lanes = 3
    lm, q, qm = _lane_maps(cfg, lanes)
    rng = np.random.default_rng(9)
    R, p = _lane_states(rng, lanes)
    pts = T(np.einsum("bnk,bkj->bnj", q - p[:, None], R).astype(np.float32))
    nav = todom.init_state(cfg=T_ODOM, device="cpu")
    nav = type(nav)(*(torch.stack([t] * lanes) for t in nav))
    offs = np.array([[0.15, 0.0, 0.0], [0.002, 0.0, 0.0], [0.0, -0.2, 0.05]], np.float32)
    nav = nav._replace(R=T(R), p=T(p + offs))
    ocfg = T_ODOM._replace(requery_thresh=0.05)  # lanes 0 and 2 re-query, lane 1 does not
    tx, tn = tiekf.iekf_update(nav, pts, T(qm), lm, cfg, ocfg, gate_on_device=True)
    ox, on = tiekf.iekf_update(nav, pts, T(qm), lm, cfg, ocfg, gate_on_device=True,
                               query_fn=_old_route)
    for a, b in zip(tx, ox):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(N(tn), N(on))
    assert tn.shape == (lanes,) and int(tn.min()) > 50
