"""The port's row gather and take_along_axis (plain versions, which the CUDA
kernels are held to bit for bit on the card) against JAX, the gather
experiment entry point on the CPU, and the fixed-order scatter-add that
makes the card path deterministic.

Tolerance: none. A gather is a copy, so the plain versions must equal
jnp's ``table[idx]`` and ``jnp.take_along_axis`` exactly, bit for bit
(NaN fill included): these are the references the JAX scripts hold their
Pallas kernels against (``scripts/exp_assoc_kernels.py:131-133``,
``scripts/exp_pallas_gather.py:102, 132, 162``). The scatter-add must equal
``index_add_`` on the CPU bit for bit: it sums in the same order.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu_torch.core import segment  # noqa: E402
from fastliosam_tpu_torch.ops import gather_cuda, take_along_cuda  # noqa: E402
from fastliosam_tpu_torch.scripts import exp_gather  # noqa: E402

from _torch_parity import N, T  # noqa: E402

C = 1 << 12


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _indices(rng, n=3000):
    """In range, negative (wrap once), below -C and at/after C (clamp)."""
    idx = rng.integers(-2 * C, 2 * C, size=n)
    idx[:6] = [-1, -C, -C - 1, C, C + 7, 0]
    return idx


@pytest.mark.parametrize("shape,dtype", [((C, 16), np.float32), ((C, 10), np.float32),
                                         ((C,), np.int32)])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_rows_ref_equals_jax_indexing(rng, shape, dtype, idx_dtype):
    if dtype == np.int32:
        table = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
    else:
        table = rng.normal(size=shape).astype(np.float32)
    idx = _indices(rng).astype(idx_dtype)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = N(gather_cuda.gather_rows(T(table), T(idx)))  # CPU tensor: plain version
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # masked rows are zero: jnp.where(valid, table[idx], 0)
    valid = rng.uniform(size=idx.shape) > 0.4
    keep = valid.reshape(valid.shape + (1,) * (len(shape) - 1))
    want_m = np.asarray(jnp.where(jnp.asarray(keep), jnp.asarray(want), 0))
    got_m = N(gather_cuda.gather_rows(T(table), T(idx), T(valid)))
    np.testing.assert_array_equal(_bits(got_m), _bits(want_m))


@pytest.mark.parametrize("tab_shape,idx_shape,axis", [
    ((64, 16), (9, 16), 0), ((8, 40), (8, 70), 1), ((4096, 128), (64, 128), 0),
    ((8, 512), (8, 512), 1),
])
def test_take_along_axis_ref_equals_jax(rng, tab_shape, idx_shape, axis):
    tab = rng.normal(size=tab_shape).astype(np.float32)
    extent = tab_shape[axis]
    idx = rng.integers(-extent - 4, extent + 4, size=idx_shape).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=axis))
    got = N(take_along_cuda.take_along_axis(T(tab), T(idx), axis))
    assert np.isnan(want).any()  # the fill mode is really exercised
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_kernels_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        gather_cuda.gather_rows_cuda(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        take_along_cuda.take_along_axis_cuda(torch.zeros((4, 2)),
                                             torch.zeros((3, 2), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        take_along_cuda.take_along_axis_ref(torch.zeros((4, 2)),
                                            torch.zeros((3, 5), dtype=torch.int32), 0)


def test_exp_gather_entry_point_plain_path_on_cpu():
    lines = []
    recs = exp_gather.run("cpu", reps=2, print_fn=lines.append, exps=exp_gather.experiments(
        c=1 << 10, n=64, small_c=1 << 8, tal=(256, 8, 16), tal1=(4, 32)))
    assert [r["name"] for r in recs] == ["A_int_indexing", "B_fori_dynamic_slice",
                                         "tal_axis0", "tal_axis1", "tal_big"]
    assert len(lines) == 5
    for r in recs:
        assert r["equal"] and r["library_equal"]
        assert r["ms"] is None and r["bound_by"] == "bytes" and r["bytes"] > 0
    # bytes: 64 rows of 64 B = 2 sectors each (distinct rows) + idx + output
    a = recs[0]
    assert a["bytes"] <= 64 * 64 + 64 * 4 + 64 * 64


def test_exp_gather_lane_turns_plain_path_on_cpu(capsys):
    rec = exp_gather.lane_gather_turns("cpu", reps=2, lanes=3, c=1 << 10, n=64)
    assert rec["table"] == [3, 1 << 10, 10] and rec["idx"] == [3, 64]
    assert rec["kernel_ms"] == [] and rec["library_ms"] == []  # untimed on the CPU
    assert exp_gather.main(["--lanes", "--device", "cpu", "--reps", "1"]) == 0
    assert '"name": "lane_rows"' in capsys.readouterr().out


@pytest.mark.parametrize("row_shape", [(), (3,), (10,), (6, 6)])
def test_fixed_order_scatter_add_equals_index_add_on_cpu(rng, row_shape):
    for n, size in ((1, 1), (5000, 300), (4096, 1 << 12), (700, 2)):
        idx = T(rng.integers(0, size, size=n))
        vals = T((rng.normal(size=(n,) + row_shape) * 1e3).astype(np.float32))
        table = T((rng.normal(size=(size,) + row_shape) * 1e4).astype(np.float32))
        want = table.clone().index_add_(0, idx, vals)
        got = segment.index_add_(table.clone(), segment.segment_plan(idx), vals)
        assert torch.equal(got, want)
        assert torch.equal(segment.scatter_add(idx, vals, size),
                           torch.zeros_like(table).index_add_(0, idx, vals))
        # dead lanes go to a drop row (the last) that no live lane uses: the
        # live rows are index_add_'s, bit for bit
        dead = T(rng.uniform(size=n) < 0.3)
        didx = torch.where(dead, size, idx)
        drop = torch.cat([table, table[:1]])
        want = drop.clone().index_add_(0, didx, vals)[:size]
        got = segment.index_add_(drop.clone(), segment.segment_plan(didx, dead), vals)
        assert torch.equal(got[:size], want)
