"""The point-to-plane ICP step's normal equations (``ops/p2pl_cuda.py``: the
plain versions of ``csrc/p2pl.cu``) and ``icp_align_p2pl`` built on them,
against the composition they replace and against the JAX package.

Tolerances and why:
  * the plain versions against the step's previous composition (three row
    gathers, the residuals, the rows, the two products) and the whole ICP
    against the previous step: bit for bit, since the CPU results must not
    move;
  * ``icp_align_p2pl`` against JAX's at trim 1.0 and 0.8: T within 1e-4 (m
    / rad), correspondence counts equal. Both converge onto the same exact
    alignment of the walls scene and stop on the same float32 step test;
    their Gram sums run in other orders.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu.loop import closure as jcl  # noqa: E402
from fastliosam_tpu.loop import icp as jicp  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu_torch.core import se3, so3  # noqa: E402
from fastliosam_tpu_torch.loop import icp as ticp  # noqa: E402
from fastliosam_tpu_torch.ops import gather_cuda, nn_cuda, p2pl_cuda  # noqa: E402

from _torch_parity import N, T  # noqa: E402
from test_torch_loop_modes import _walls_scene  # noqa: E402


def _bits(t):
    return t.contiguous().view(torch.int32)


def _step_inputs(rng, n_invalid=300):
    """The walls scene's source moved by a pose near the truth, its
    neighbours in the destination (the plain NN), JAX's surfel normals with
    ``n_invalid`` flags cleared, a ragged source mask, and the scene's
    ``max_d2`` (10 m)."""
    src, dst, _ = _walls_scene(rng)
    mask = np.ones(len(dst), bool)
    jmap, jcfg = jcl._dst_surfel_map(jnp.asarray(dst), jnp.asarray(mask), jcl.LoopConfig())
    nrm, _, nvalid = jvh.query_planes(jmap, jcfg, jnp.asarray(dst), jnp.asarray(mask))
    nvalid = N(nvalid).copy()
    nvalid[rng.choice(len(dst), n_invalid, replace=False)] = False
    src_mask = rng.uniform(size=len(src)) > 0.05
    T0 = se3.make(so3.exp(T(np.array([0.01, -0.02, 0.015], np.float32))),
                  T(np.array([1.1, -0.7, 0.45], np.float32)))
    ps = se3.apply(T0, T(src)[None])[0]
    idx, d2 = nn_cuda.nearest_neighbors_ref(ps, T(dst), T(mask))
    d2 = torch.where(torch.arange(len(src)) % 97 == 0, torch.tensor(200.0), d2)  # beyond max_d2
    return ps, idx, d2, T(src_mask), T(dst), T(N(nrm)), T(nvalid), 100.0


def _old_weights(idx, d2, src_mask, nvalid, max_d2, trim):
    """The step's weights as they were: the int32 flags' row gather and
    ``_trimmed``'s sort."""
    corr = src_mask & (d2 < max_d2) & (gather_cuda.gather_rows(nvalid.to(torch.int32), idx) != 0)
    if trim >= 1.0:
        return corr
    d2s = torch.sort(torch.where(corr, d2, 1.0e12)).values
    n_corr = torch.sum(corr.to(torch.int32))
    k = torch.clamp((n_corr.to(torch.float32) * trim).to(torch.int32), 1, len(d2) - 1)
    return corr & (d2 <= d2s.gather(0, k.to(torch.int64).reshape(1)))


def _old_system(ps, idx, w, dst, nrm):
    """The step's system as it was: three row gathers, the residuals, the
    rows and the two products."""
    w = w.to(torch.float32)
    n = gather_cuda.gather_rows(nrm, idx)
    q = gather_cuda.gather_rows(dst, idx)
    r = torch.sum(n * (ps - q), dim=-1)
    A = torch.cat([torch.linalg.cross(ps, n, dim=-1), n], dim=-1)
    Aw = A * w[:, None]
    return A.T @ Aw, Aw.T @ r


@pytest.mark.parametrize("trim", [1.0, 0.8])
def test_normal_eq_ref_bit_for_bit_the_old_step(rng, trim):
    ps, idx, d2, src_mask, dst, nrm, nvalid, max_d2 = _step_inputs(rng)
    launched = p2pl_cuda.launches
    thr = None
    if trim < 1.0:
        corr, key = p2pl_cuda.corr_keys(idx, d2, src_mask, nvalid, max_d2)
        want_corr = _old_weights(idx, d2, src_mask, nvalid, max_d2, 1.0)
        assert torch.equal(corr, want_corr)
        assert torch.equal(_bits(key), _bits(torch.where(want_corr, d2, 1.0e12)))
        thr = ticp._trim_threshold(corr, key, len(d2), trim)
    G, b = p2pl_cuda.normal_eq(ps, idx, d2, src_mask, dst, nrm, nvalid, max_d2, thr)
    assert p2pl_cuda.launches == launched  # CPU tensors: the plain versions
    w = _old_weights(idx, d2, src_mask, nvalid, max_d2, trim)
    assert 1000 < int(w.sum()) < int((src_mask & (d2 < max_d2)).sum())
    G_old, b_old = _old_system(ps, idx, w, dst, nrm)
    assert G.shape == (6, 6) and b.shape == (6,)
    assert torch.equal(_bits(G), _bits(G_old)) and torch.equal(_bits(b), _bits(b_old))


def test_normal_eq_index_rule_and_empty_weights(rng):
    """Negative indices wrap once and the rest clamps (``table[idx]``'s rule,
    as the row gather reads them); with no correspondence G and b are 0."""
    ps, idx, d2, src_mask, dst, nrm, nvalid, max_d2 = _step_inputs(rng)
    m = dst.shape[0]
    odd = idx.clone()
    odd[::5] -= m  # wraps back onto the same rows
    odd[1::50] = m + 7  # clamps to the last row
    want = idx.clone()
    want[1::50] = m - 1
    for x, y in zip(p2pl_cuda.normal_eq(ps, odd, d2, src_mask, dst, nrm, nvalid, max_d2),
                    p2pl_cuda.normal_eq(ps, want, d2, src_mask, dst, nrm, nvalid, max_d2)):
        assert torch.equal(_bits(x), _bits(y))
    G, b = p2pl_cuda.normal_eq(ps, idx, d2, torch.zeros_like(src_mask), dst, nrm, nvalid, max_d2)
    assert not bool(G.any()) and not bool(b.any())


def _old_icp_p2pl(src, src_mask, dst, dst_mask, dst_normals, dst_nvalid, max_iterations,
                  max_corr_dist, trim_fraction, convergence_eps=0.01):
    """``icp_align_p2pl`` with the step as it was."""
    max_d2 = max_corr_dist * max_corr_dist
    ridge = 1e-6 * torch.eye(6, dtype=torch.float32)

    def step(T):
        ps = se3.apply(T, src[None])[0]
        idx, d2 = nn_cuda.nearest_neighbors(ps.contiguous(), dst, dst_mask, 512)
        w = _old_weights(idx, d2, src_mask, dst_nvalid, max_d2, trim_fraction)
        G, b = _old_system(ps, idx, w, dst, dst_normals)
        dx = torch.linalg.solve_ex(G + ridge, -b).result
        return se3.compose(se3.make(so3.exp(dx[:3]), dx[3:]), T), torch.linalg.vector_norm(dx)

    return ticp._iterate(step, torch.eye(4, dtype=torch.float32), max_iterations,
                         convergence_eps)


@pytest.mark.parametrize("trim", [1.0, 0.8])
def test_icp_p2pl_matches_jax_and_the_old_step(rng, trim):
    src, dst, T_true = _walls_scene(rng)
    mask = np.ones(len(dst), bool)
    jmap, jcfg = jcl._dst_surfel_map(jnp.asarray(dst), jnp.asarray(mask), jcl.LoopConfig())
    nrm, _, nvalid = jvh.query_planes(jmap, jcfg, jnp.asarray(dst), jnp.asarray(mask))
    kw = dict(max_iterations=30, max_corr_dist=10.0, trim_fraction=trim)
    jT, jfit, jn = jicp.icp_align_p2pl(jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
                                       jnp.asarray(mask), nrm, nvalid, nn_chunk=512, **kw)
    args = (T(src), T(mask), T(dst), T(mask), T(N(nrm)), T(N(nvalid)))
    launched = (p2pl_cuda.launches, gather_cuda.launches)
    tT, tfit, tn = ticp.icp_align_p2pl(*args, nn_chunk=512, **kw)
    assert (p2pl_cuda.launches, gather_cuda.launches) == launched  # CPU: plain versions
    np.testing.assert_allclose(N(tT), N(jT), atol=1e-4)
    assert int(tn) == int(jn) > 2000
    np.testing.assert_allclose(float(tfit), float(jfit), rtol=1e-2, atol=1e-6)
    err = N(tT) @ np.linalg.inv(T_true)
    assert np.abs(err[:3, 3]).max() < 1e-3
    assert torch.equal(_bits(tT), _bits(_old_icp_p2pl(*args, **kw)))


def test_p2pl_hbm_bytes():
    m = 1000
    idx = np.array([0, 1, 8, 9, 40, -1, 5000], np.int64)  # -1 -> 999, 5000 -> 999
    live = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    w = np.array([1, 0, 1, 0, 0, 1, 1], bool)
    rows = np.array([0, 8, 999, 999])
    flags = len(np.unique(np.array([0, 1, 8, 9, 999, 999]) // 32)) * 32
    want = 7 * 21 + flags + 2 * gather_cuda.sector_bytes(rows, 3) + 42 * 4
    assert p2pl_cuda.hbm_bytes(idx, live, w, m) == want
    assert p2pl_cuda.hbm_bytes(idx, live, np.zeros(7, bool), m) == 7 * 21 + flags + 42 * 4
