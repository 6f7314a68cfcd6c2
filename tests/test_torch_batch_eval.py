"""The port's batched odometry rollout (``eval/batch_eval.py``) against its
unbatched path and against the JAX package, on the room feed of
``tests/test_batch_eval.py`` (128 x 8 rays, 4 scans) at ``test_rollout``'s
``MAP_CFG`` / ``ODOM_CFG``.

Tolerances and why:
  * the lane-batched plain versions of the map kernels (association,
    insert, cached query, row gather), the lane-batched segment plan and
    the per-lane downsample: bit for bit against the unbatched plain
    version on each lane's own table (the same operations per lane; the
    card holds the kernels to these);
  * lane isolation: bit for bit (a lane never reads another lane's data),
    the two assertions of ``tests/test_batch_eval.py``;
  * one batched step against the unbatched ``odom_step`` from the same
    carried state, every lane and scan, in every query mode: 1e-5 m and
    1e-6 on R (measured up to 1.5e-7 m, 1.7e-8). Not bitwise: the batched
    3x3 products of the IMU propagation and the iEKF run as ``bmm`` where
    the unbatched step runs ``mm`` / ``mv``, which round differently in the
    last bit (the downsample and the deskew are bit for bit per lane from
    equal inputs);
  * a lane against the port's unbatched ``odom_rollout`` of the same
    sequence over the 4 scans: 5 mm, the JAX test's bound, in the merged
    modes (measured up to 6.6e-5 m in ``merged``). That last-bit rounding
    can put a point on a voxel boundary into the neighbouring voxel, as
    between JAX's own batched and unbatched runs; a lane whose solve has
    few matches then amplifies it: in the ``cached`` mode seed 7's lane
    matches 2 and 42 points in scans 1-2 and parts by 4.9 cm by scan 3
    (JAX's unbatched run and the port's differ there by 1.5 mm), so that
    mode is held by the per-step test;
  * a lane against JAX's jitted ``odom_rollout``: 1 cm, the tolerance of
    ``test_torch_odom.py::test_odom_scans_track_jax`` (the room's floor on
    a voxel boundary decides a few points by float32 rounding);
  * the state conversion to and from the JAX package's stacked pytree:
    exact;
  * launches: one association per query pass and one insert per step,
    whatever the lane count (counted on the dispatch, since the CPU runs
    the plain versions).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu.eval import batch_eval as jbe  # noqa: E402
from fastliosam_tpu.map import voxel_hash as jvh  # noqa: E402
from fastliosam_tpu.odom.pipeline import odom_rollout as j_odom_rollout  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch.convert import odom_state_from_numpy, odom_state_to_numpy  # noqa: E402
from fastliosam_tpu_torch.core import segment  # noqa: E402
from fastliosam_tpu_torch.core.pointcloud import (  # noqa: E402
    Cloud, voxel_downsample, voxel_downsample_lanes,
)
from fastliosam_tpu_torch.eval.batch_eval import batched_rollout, stack_states  # noqa: E402
from fastliosam_tpu_torch.map import VoxelMapConfig as TMapCfg  # noqa: E402
from fastliosam_tpu_torch.map import voxel_hash as tvh  # noqa: E402
from fastliosam_tpu_torch.ops import assoc_cuda, gather_cuda, insert_cuda, query_cuda  # noqa: E402
from tests.test_rollout import MAP_CFG, ODOM_CFG  # noqa: E402

from _torch_parity import N, T, tree_np  # noqa: E402

T_MAP = TMapCfg(**MAP_CFG._asdict())
T_ODOM = todom.OdomConfig(**ODOM_CFG._asdict())
N_SCANS = 4


def build_seq(seed, n_scans=N_SCANS):
    """``tests/test_batch_eval.py: build_seq`` as numpy: ``(scans (xyz,
    t_offset, mask) stacked over scans, imus (stamps, gyro, acc, mask)
    stacked and padded to 32, (R0, p0, v0), scan_dt)``."""
    world = PlaneWorld.room(size=24.0, height=5.0, n_boxes=5, seed=seed)
    traj = Trajectory.circle(radius=8.0, period=40.0)
    cfg = SimConfig(n_azimuth=128, n_elev=8, seed=seed)
    data = simulate_sequence(world, traj, cfg, n_scans=n_scans)
    cap = 32
    scans = tuple(np.stack([s[i] for s in data["scans"]]) for i in range(3))

    def pad_imu(b):
        ts, gy, ac = b
        n = len(ts)
        return (np.pad(ts, (0, cap - n), constant_values=1e9).astype(np.float32),
                np.pad(gy, ((0, cap - n), (0, 0))).astype(np.float32),
                np.pad(ac, ((0, cap - n), (0, 0))).astype(np.float32),
                np.arange(cap) < n)

    imus_np = [pad_imu(b) for b in data["imu"]]
    imus = tuple(np.stack([i[k] for i in imus_np]) for k in range(4))
    R0, p0 = traj.pose(0.0)
    start = (R0.astype(np.float32), p0.astype(np.float32),
             traj.velocity(0.0).astype(np.float32))
    return scans, imus, start, data["scan_dt"]


@pytest.fixture(scope="module")
def seqs():
    return {seed: build_seq(seed) for seed in (1, 7, 13)}


def _jax_state(start):
    R0, p0, v0 = start
    st = jodom.init_odom(MAP_CFG)
    return st._replace(nav=st.nav._replace(R=jnp.asarray(R0), p=jnp.asarray(p0),
                                           v=jnp.asarray(v0)))


def _port_state(start, cfg=T_ODOM):
    R0, p0, v0 = start
    st = todom.init_odom(T_MAP, cfg, device="cpu")
    return st._replace(nav=st.nav._replace(R=T(R0), p=T(p0), v=T(v0)))


def _port_inputs(seq_list, first=0):
    """Lane-stacked ``(Scan, ImuBatch)`` of the sequences, from scan
    ``first`` on."""
    scans = todom.Scan(*(T(np.stack([s[0][i][first:] for s in seq_list])) for i in range(3)))
    imus = todom.ImuBatch(*(T(np.stack([s[1][i][first:] for s in seq_list]))
                            for i in range(4)))
    return scans, imus


def _port_batch(seq_list, cfg=T_ODOM):
    states = stack_states([_port_state(s[2], cfg) for s in seq_list])
    scans, imus = _port_inputs(seq_list)
    return batched_rollout(states, scans, imus, seq_list[0][3], cfg, T_MAP, device="cpu")


def _unbatched(seq, cfg=T_ODOM, state=None, first=0):
    scans, imus = _port_inputs([seq], first)
    st = _port_state(seq[2], cfg) if state is None else state
    return todom.odom_rollout(st, todom.Scan(*(t[0] for t in scans)),
                              todom.ImuBatch(*(t[0] for t in imus)), seq[3], cfg, T_MAP,
                              device="cpu")


# ---------------------------------------------------------------------------
# the lane-batched plain versions, lane by lane against the unbatched ones
# ---------------------------------------------------------------------------
def _lane_maps(rng, lanes, cap=1 << 10, n=600):
    """``lanes`` maps with different contents (each from its own unbatched
    insert of ``n`` random points), stacked lane-major, and their configs."""
    cfg = TMapCfg(capacity=cap, voxel_size=0.5, min_points=3)
    maps = []
    for b in range(lanes):
        pts = T(rng.normal(size=(n, 3)).astype(np.float32) * (3 + b))
        m, _ = tvh.insert(tvh.make_map(cfg, "cpu"), cfg, pts, torch.ones(n, dtype=torch.bool))
        maps.append(m)
    return maps, tvh.VoxelMap(*(torch.stack(f) for f in zip(*maps))), cfg


def _queries(rng, lanes, n, scale=4.0, masked=0.1):
    xyz = T(rng.normal(size=(lanes, n, 3)).astype(np.float32) * scale)
    mask = T(rng.uniform(size=(lanes, n)) > masked)
    return xyz, mask


@pytest.mark.parametrize("lanes", [1, 3])
def test_merged_moments_lanes_match_unbatched(lanes):
    rng = np.random.default_rng(lanes)
    maps, lm, cfg = _lane_maps(rng, lanes)
    xyz, mask = _queries(rng, lanes, 257)
    for pools_fn in (tvh.merged3_pools, tvh.merged2_pools, tvh.merged_pools):
        coords0, pools = pools_fn(xyz, cfg.voxel_size)
        got = assoc_cuda.merged_moments_ref(lm.fp, lm.moments, pools, coords0, mask, 0.5, 2)
        assert got.shape == (lanes, 257, 13)
        for b, m in enumerate(maps):
            c1, p1 = pools_fn(xyz[b], cfg.voxel_size)
            assert torch.equal(pools[:, b], p1) and torch.equal(coords0[b], c1)
            want = assoc_cuda.merged_moments_ref(m.fp, m.moments, p1, c1, mask[b], 0.5, 2)
            assert torch.equal(got[b].view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("lanes", [1, 3])
def test_insert_claim_lanes_match_unbatched(lanes):
    rng = np.random.default_rng(10 + lanes)
    for cap, n, rounds in ((1 << 10, 500, 2), (1 << 6, 300, 4)):  # roomy; tight, with drops
        maps, lm, cfg = _lane_maps(rng, lanes, cap=cap, n=40)
        xyz, mask = _queries(rng, lanes, n)
        got = insert_cuda.insert_claim_ref(lm.fp, lm.coords, lm.moments, xyz, mask, 0.5,
                                           rounds, 1000.0)
        assert got[4].shape == (lanes,)
        for b, m in enumerate(maps):
            want = insert_cuda.insert_claim_ref(m.fp, m.coords, m.moments, xyz[b], mask[b],
                                                0.5, rounds, 1000.0)
            for g, w in zip(got, want):
                assert torch.equal(g[b], w)
        if cap == 1 << 6:
            assert int(got[4].min()) > 0  # the tight tables drop points in every lane


@pytest.mark.parametrize("refresh", [False, True])
def test_lane_insert_matches_unbatched_and_keeps_tables_contiguous(refresh):
    """``insert`` of a lane-major map: each lane's map as the unbatched
    insert's, bit for bit (the lane plan of the moment scatter, the
    plane refresh), and every field contiguous, as the kernels of the next
    call (and the plane refresh's gather inside this one) take them."""
    rng = np.random.default_rng(40)
    maps, lm, cfg = _lane_maps(rng, 3, n=300)
    xyz, mask = _queries(rng, 3, 500)
    got, dropped = tvh.insert(lm, cfg, xyz, mask, refresh_planes=refresh)
    assert all(t.is_contiguous() for t in got) and dropped.shape == (3,)
    for b, m in enumerate(maps):
        want, d1 = tvh.insert(m, cfg, xyz[b], mask[b], refresh_planes=refresh)
        assert int(d1) == int(dropped[b])
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)


@pytest.mark.parametrize("lanes", [1, 3])
def test_query_cached_and_gather_lanes_match_unbatched(lanes):
    rng = np.random.default_rng(20 + lanes)
    maps, lm, cfg = _lane_maps(rng, lanes)
    xyz, mask = _queries(rng, lanes, 300)
    got = query_cuda.query_cached_ref(lm.fp, lm.normal, lm.d, lm.plane_valid, xyz, mask,
                                      0.5, 4)
    idx = T(rng.integers(-1100, 1100, size=(lanes, 300)))  # wrap and clamp per lane
    rows = gather_cuda.gather_rows_ref(lm.moments, idx, valid=mask, lane_major=True)
    words = gather_cuda.gather_rows_ref(lm.fp, idx, lane_major=True)
    for b, m in enumerate(maps):
        want = query_cuda.query_cached_ref(m.fp, m.normal, m.d, m.plane_valid, xyz[b],
                                           mask[b], 0.5, 4)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)
        assert torch.equal(rows[b], gather_cuda.gather_rows_ref(m.moments, idx[b],
                                                                valid=mask[b]))
        assert torch.equal(words[b], gather_cuda.gather_rows_ref(m.fp, idx[b]))


@pytest.mark.parametrize("lanes", [1, 3])
def test_lane_plan_matches_per_lane_plans(lanes):
    """The batched segment plan: lane b's rows from b * (C + 1), its drop
    row its own; each lane's sums are its own plan's, bit for bit."""
    rng = np.random.default_rng(30 + lanes)
    rows = 65  # 64 rows and the drop row
    idx = T(rng.integers(0, rows, size=(lanes, 400)))
    vals = T(rng.normal(size=(lanes, 400, 4)).astype(np.float32))
    table = T(rng.normal(size=(lanes, rows, 4)).astype(np.float32))
    dead = idx == rows - 1
    plan = segment.lane_plan(idx, rows, dead=dead)
    got = segment.index_add_(table.reshape(-1, 4).clone(), plan, vals.reshape(-1, 4))
    got = got.reshape(lanes, rows, 4)[:, :-1]
    for b in range(lanes):
        want = segment.index_add_(table[b].clone(), segment.segment_plan(idx[b], dead[b]),
                                  vals[b])[:-1]
        assert torch.equal(got[b], want)
        assert torch.equal(got[b], table[b].index_add(0, idx[b], vals[b])[:-1])


@pytest.mark.parametrize("lanes", [1, 3])
def test_voxel_downsample_lanes_matches_per_lane(lanes, seqs):
    """Each lane downsampled as the unbatched downsample does, the output
    packed per lane; an all-masked lane gives an empty cloud."""
    xyz = T(np.stack([seqs[s][0][0][1] for s in (1, 7, 13)][:lanes]))
    mask = T(np.stack([seqs[s][0][2][1] for s in (1, 7, 13)][:lanes]))
    if lanes > 1:
        mask[1] = False
    got = voxel_downsample_lanes(Cloud(xyz, mask), 0.4)
    for b in range(lanes):
        want = voxel_downsample(Cloud(xyz[b], mask[b]), 0.4)
        assert torch.equal(got.xyz[b], want.xyz) and torch.equal(got.mask[b], want.mask)
    assert lanes == 1 or int(got.mask[1].sum()) == 0


# ---------------------------------------------------------------------------
# the batched rollout
# ---------------------------------------------------------------------------
def test_lane_isolation_bitexact(seqs):
    """A lane's batched result is bit-identical whatever its partner lane
    carries, and two lanes carrying one sequence are bit-identical (the two
    assertions of tests/test_batch_eval.py)."""
    s1, s2, s3 = seqs[1], seqs[7], seqs[13]
    _, aux_a = _port_batch([s1, s2])
    _, aux_b = _port_batch([s1, s3])
    fin_c, aux_c = _port_batch([s1, s1])
    assert torch.equal(aux_a["p"][0], aux_b["p"][0])
    assert torch.equal(aux_a["R"][0], aux_b["R"][0])
    assert torch.equal(aux_c["p"][0], aux_c["p"][1])
    for f in fin_c.vmap:
        assert torch.equal(f[0], f[1])
    assert aux_a["p"].shape == (2, N_SCANS, 3) and aux_a["R"].shape == (2, N_SCANS, 3, 3)
    assert aux_a["n_matched"].shape == (2, N_SCANS)


@pytest.mark.parametrize("query_mode", ["merged", "merged3", "merged2", "cached"])
def test_batched_step_matches_unbatched_step(seqs, query_mode):
    """At every scan, one batched step of the three lanes from the states
    of their unbatched runs against each lane's unbatched step (see the
    module docstring)."""
    cfg = T_ODOM._replace(query_mode=query_mode)
    lanes = [seqs[1], seqs[7], seqs[13]]
    states = [_port_state(s[2], cfg) for s in lanes]
    inputs = [_port_inputs([s]) for s in lanes]
    for k in range(N_SCANS):
        steps = [todom.odom_step(st, todom.Scan(*(t[0, k] for t in sc)),
                                 todom.ImuBatch(*(t[0, k] for t in im)), lanes[0][3], cfg,
                                 T_MAP, device="cpu")
                 for st, (sc, im) in zip(states, inputs)]
        scans, imus = _port_inputs(lanes)
        _, aux = todom.odom_step_batched(
            stack_states(states), todom.Scan(*(t[:, k] for t in scans)),
            todom.ImuBatch(*(t[:, k] for t in imus)), lanes[0][3], cfg, T_MAP, device="cpu")
        for b, (_, ref) in enumerate(steps):
            np.testing.assert_allclose(N(aux["p"][b]), N(ref["p"]), atol=1e-5)
            np.testing.assert_allclose(N(aux["R"][b]), N(ref["R"]), atol=1e-6)
            assert abs(int(aux["n_matched"][b]) - int(ref["n_matched"])) <= 2
        states = [st for st, _ in steps]


@pytest.mark.parametrize("query_mode", ["merged", "merged3", "merged2"])
def test_lanes_match_unbatched_rollout(seqs, query_mode):
    """Each lane against the port's unbatched rollout of its sequence over
    the 4 scans: 5 mm (see the module docstring)."""
    cfg = T_ODOM._replace(query_mode=query_mode)
    lanes = [seqs[1], seqs[7], seqs[13]]
    fin, aux = _port_batch(lanes, cfg)
    for b, seq in enumerate(lanes):
        st, ref = _unbatched(seq, cfg)
        np.testing.assert_allclose(N(aux["p"][b]), N(ref["p"]), atol=5e-3)
        np.testing.assert_allclose(N(aux["R"][b]), N(ref["R"]), atol=5e-3)
        assert np.all(np.abs(N(aux["n_matched"][b]) - N(ref["n_matched"]))
                      <= 0.02 * N(ref["n_matched"]) + 2)
        assert int(aux["n_matched"][b, 2:].min()) > 0
    assert N(fin.scan_idx).tolist() == [N_SCANS] * 3 and bool(fin.initialized.all())


def test_batched_update_needs_the_device_gate():
    """A batched iEKF update gates its re-query per lane on the device; the
    host read of the per-scan path has no per-lane form, so it raises."""
    st = todom.init_odom(T_MAP, T_ODOM, device="cpu", lanes=2)
    assert T_ODOM.requery_thresh > 0.0
    with pytest.raises(ValueError, match="gate_on_device"):
        todom.iekf_update(st.nav, torch.zeros((2, 8, 3)), torch.ones((2, 8), dtype=torch.bool),
                          st.vmap, T_MAP, T_ODOM)


def test_per_lane_selects_match_unbatched(seqs):
    """Lanes whose ``lax.cond`` predicates differ, over scans 1-3: one
    fresh, one fresh without IMU (the coordinated-turn prediction), and one
    initialized by its unbatched scan 0 and a scan along, so that it evicts
    on other steps (every 2nd scan, 10 m): each lane as the unbatched rollout
    from its own state, within 5 mm, its map's voxels within 2%; and the
    eviction cleared voxels in every lane."""
    cfg = T_ODOM._replace(evict_every=2, det_range=10.0)
    s1, s7, s13 = seqs[1], seqs[7], seqs[13]
    no_imu = (s7[0], s7[1][:3] + (np.zeros_like(s7[1][3]),), s7[2], s7[3])
    sc13, im13 = _port_inputs([s13])
    st13, _ = todom.odom_step(_port_state(s13[2], cfg), todom.Scan(*(t[0, 0] for t in sc13)),
                              todom.ImuBatch(*(t[0, 0] for t in im13)), s13[3], cfg, T_MAP,
                              device="cpu")
    assert st13.initialized and st13.scan_idx == 1
    starts = [_port_state(s1[2], cfg), _port_state(no_imu[2], cfg), st13]
    scans, imus = _port_inputs([s1, no_imu, s13], first=1)
    fin, aux = batched_rollout(stack_states(starts), scans, imus, s1[3], cfg, T_MAP,
                               device="cpu")
    kept, _ = batched_rollout(stack_states(starts), scans, imus, s1[3],
                              cfg._replace(evict_every=10_000), T_MAP, device="cpu")
    for b, (seq, st0) in enumerate(zip([s1, no_imu, s13], starts)):
        st, ref = _unbatched(seq, cfg, state=st0, first=1)
        np.testing.assert_allclose(N(aux["p"][b]), N(ref["p"]), atol=5e-3)
        assert int(fin.scan_idx[b]) == st.scan_idx
        occupied = int((fin.vmap.fp[b] != 0).sum())
        assert abs(occupied - int((st.vmap.fp != 0).sum())) <= 0.02 * occupied
        assert occupied < int((kept.vmap.fp[b] != 0).sum())


def test_lanes_track_jax_rollout(seqs):
    """Each lane against JAX's jitted ``odom_rollout`` of its sequence
    (1 cm, see the module docstring)."""
    lanes = [seqs[1], seqs[7]]
    _, aux = _port_batch(lanes)
    dt = lanes[0][3]
    roll = jax.jit(lambda s, sc, im: j_odom_rollout(s, sc, im, dt, ODOM_CFG, MAP_CFG))
    for b, seq in enumerate(lanes):
        scans = jodom.Scan(*map(jnp.asarray, seq[0]))
        imus = jodom.ImuBatch(*map(jnp.asarray, seq[1]))
        _, ref = roll(_jax_state(seq[2]), scans, imus)
        np.testing.assert_allclose(N(aux["p"][b]), np.asarray(ref["p"]), atol=1e-2)
        assert int(aux["n_matched"][b, 2:].min()) > 200


def test_convert_round_trip_batched():
    """JAX's stacked state (``stack_states``) as numpy becomes the port's
    batched state and goes back, exactly; the unbatched state too."""
    rng = np.random.default_rng(5)
    states = []
    for k in range(3):
        st = jodom.init_odom(MAP_CFG)
        pts = jnp.asarray(rng.normal(size=(200, 3)).astype(np.float32) * 4)
        vm, _ = jvh.insert(st.vmap, MAP_CFG, pts, jnp.ones(200, bool))
        states.append(st._replace(vmap=vm, scan_idx=jnp.int32(k), initialized=jnp.bool_(k > 0),
                                  w_cv=jnp.asarray(rng.normal(size=3).astype(np.float32))))
    stacked = tree_np(jbe.stack_states(states))
    port = odom_state_from_numpy(stacked, device="cpu")
    assert port.scan_idx.dtype == torch.int32 and port.initialized.dtype == torch.bool
    assert N(port.scan_idx).tolist() == [0, 1, 2] and N(port.initialized).tolist() == [
        False, True, True]
    back = odom_state_to_numpy(port)
    for name, ref in (("nav", stacked.nav), ("vmap", stacked.vmap)):
        for f, a in ref._asdict().items():
            assert back[name][f].dtype == a.dtype and np.array_equal(back[name][f], a)
    for f in ("scan_idx", "initialized", "w_cv"):
        ref = getattr(stacked, f)
        assert back[f].dtype == ref.dtype and np.array_equal(back[f], ref)
    # the port's own stacking of the unbatched states gives the same state
    ours = stack_states([odom_state_from_numpy(tree_np(s), device="cpu") for s in states])
    for a, b in zip(tree_np(ours), tree_np(port)):
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b))):
            assert np.array_equal(x, y)
    one = odom_state_to_numpy(odom_state_from_numpy(tree_np(states[1]), device="cpu"))
    assert one["scan_idx"].shape == () and int(one["scan_idx"]) == 1 and bool(one["initialized"])
    # and back into the JAX package
    jst = jodom.pipeline.OdomState(
        nav=jodom.NavState(**back["nav"]), vmap=jvh.VoxelMap(**back["vmap"]),
        scan_idx=back["scan_idx"], initialized=back["initialized"], w_cv=back["w_cv"])
    for x, y in zip(jax.tree.leaves(jst), jax.tree.leaves(jbe.stack_states(states))):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_launch_counts_equal_at_1_and_8_lanes(seqs, monkeypatch):
    """One association per query pass and one insert per step at 1 lane and
    at 8: the map's kernels are called once for all lanes (counted on the
    dispatch, which launches the kernel on the card)."""
    counts = {"merged_moments": 0, "insert_claim": 0}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(tvh, "merged_moments", counted("merged_moments", tvh.merged_moments))
    monkeypatch.setattr(tvh, "insert_claim", counted("insert_claim", tvh.insert_claim))
    per_step = {}
    for lanes in (1, 8):
        seq_list = [seqs[(1, 7, 13)[b % 3]] for b in range(lanes)]
        for k in counts:
            counts[k] = 0
        states = stack_states([_port_state(s[2]) for s in seq_list])
        scans, imus = _port_inputs(seq_list)
        todom.odom_step_batched(states, todom.Scan(*(t[:, 0] for t in scans)),
                                todom.ImuBatch(*(t[:, 0] for t in imus)), seq_list[0][3],
                                T_ODOM, T_MAP, device="cpu")
        per_step[lanes] = dict(counts)
    # the first query and the always-computed re-query; one insert
    assert per_step[1] == per_step[8] == {"merged_moments": 1 + T_ODOM.requery_iters,
                                          "insert_claim": 1}


@pytest.mark.slow
def test_matches_jax_batched_rollout(seqs):
    """The port's batched rollout against JAX's own ``batched_rollout``
    (``vmap``) of the same two lanes: 1 cm, as against the unbatched JAX
    rollout (JAX's own lanes differ from its unbatched rollout by ~1 mm,
    ``tests/test_batch_eval.py``). Slow as JAX's test of it is."""
    lanes = [seqs[1], seqs[7]]
    _, aux = _port_batch(lanes)
    dt = lanes[0][3]
    jstates = jbe.stack_states([_jax_state(s[2]) for s in lanes])
    jscans = jodom.Scan(*(jnp.asarray(np.stack([s[0][i] for s in lanes])) for i in range(3)))
    jimus = jodom.ImuBatch(*(jnp.asarray(np.stack([s[1][i] for s in lanes]))
                             for i in range(4)))
    _, ref = jbe.batched_rollout(jstates, jscans, jimus, dt, ODOM_CFG, MAP_CFG)
    np.testing.assert_allclose(N(aux["p"]), np.asarray(ref["p"]), atol=1e-2)
    np.testing.assert_allclose(N(aux["R"]), np.asarray(ref["R"]), atol=1e-2)


@pytest.mark.slow
def test_figure8_windows_jax_reference():
    """The accuracy reference of ``chip_smoke.py``'s batched phase: the JAX
    package's jitted ``odom_rollout`` over each lane's window of the
    figure-8 feed at the phase's full width (2048 x 16 rays, 8192 iEKF
    points, a 2^19-slot map), started as the lane is (the ground truth's
    pose and velocity at the window's start), in the merged3 mode (75
    scans) and the cached mode (20 scans). The phase holds each lane's ATE
    to max(0.10 m, this reading + 1 cm): three windows started mid-path read
    0.11-0.18 m in the reference itself (the empty map they start from:
    ``test_figure8_windows_drift_source``). Asserts the readings the script
    carries (within 1 mm: another CPU's float32 kernels) and prints them.
    ~4 min (the feed's rendering included)."""
    import chip_smoke as cs
    from fastliosam_tpu.map import VoxelMapConfig as JMapCfg
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    feed = cs.load_feed(cs.figure8_feed(150))
    engine = make_bench_engine("cpu")
    map_cfg = JMapCfg(**engine.map_cfg._asdict())
    traj = cs.figure8_traj()
    dt = float(feed["scan_dt"])
    firsts = [cs.BATCH_STRIDE * b for b in range(cs.BATCH_LANES)]
    for mode, n_scans, carried in (("merged3", cs.BATCH_SCANS, cs.BATCH_JAX_ATE_M),
                                   ("cached", cs.BATCH_CACHED_SCANS, cs.BATCH_CACHED_JAX_ATE_M)):
        cfg = jodom.OdomConfig(**engine.odom_cfg._replace(query_mode=mode)._asdict())
        roll = jax.jit(lambda s, sc, im, cfg=cfg: j_odom_rollout(s, sc, im, jnp.float32(dt), cfg,
                                                                  map_cfg))
        ates = []
        for f in firsts:
            t = float(feed["stamps"][f] - feed["stamps"][0])
            R, p = traj.pose(t)
            st = jodom.init_odom(map_cfg, cfg)
            st = st._replace(nav=st.nav._replace(R=jnp.asarray(R, jnp.float32),
                                                 p=jnp.asarray(p, jnp.float32),
                                                 v=jnp.asarray(traj.velocity(t), jnp.float32)))
            sl = slice(f, f + n_scans)
            scans = jodom.Scan(*(jnp.asarray(feed[k][sl]) for k in ("xyz", "toff", "mask")))
            imus = jodom.ImuBatch(*(jnp.asarray(feed[k][sl])
                                    for k in ("imu_t", "imu_g", "imu_a", "imu_m")))
            _, aux = roll(st, scans, imus)
            err = np.asarray(aux["p"]) - feed["gt_p"][sl]
            ates.append(float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1)))))
        print(f"{mode}: JAX ATE per window (m): {[round(a, 4) for a in ates]}")
        np.testing.assert_allclose(ates, carried, atol=1e-3)


@pytest.mark.slow
def test_figure8_windows_drift_source():
    """What makes three of ``chip_smoke.py``'s batched windows (started at
    scans 10, 20 and 40 of the figure-8 feed) read more than 0.10 m, in both
    packages at the phase's full width: not the filter's start state but the
    empty map. Given the map that the window from scan 0 built up to the
    window's start, a fresh filter (the ground truth's pose and velocity,
    zero biases, the initial covariance) reads under 0.03 m; the empty map
    leaves merged3's association under 100 matches in scan 1 (the merged
    stencil over 500) while the error builds over the next 30 scans, and the
    merged stencil from an empty map reads under 0.10 m. Prints every
    reading. ~2 min."""
    import chip_smoke as cs
    from fastliosam_tpu.map import VoxelMapConfig as JMapCfg
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    torch.set_num_threads(4)
    feed = cs.load_feed(cs.figure8_feed(150))
    engine = make_bench_engine("cpu")
    t_map = engine.map_cfg
    j_map = JMapCfg(**t_map._asdict())
    dt = float(feed["scan_dt"])
    starts, n_scans = (10, 20, 40), cs.BATCH_SCANS
    traj = cs.figure8_traj()

    def ate(p, f):
        return float(np.sqrt(np.mean(np.sum((np.asarray(p) - feed["gt_p"][f:f + n_scans]) ** 2,
                                            axis=-1))))

    def j_inputs(f, n):
        sl = slice(f, f + n)
        return (jodom.Scan(*(jnp.asarray(feed[k][sl]) for k in ("xyz", "toff", "mask"))),
                jodom.ImuBatch(*(jnp.asarray(feed[k][sl])
                                 for k in ("imu_t", "imu_g", "imu_a", "imu_m"))))

    def j_fresh_nav(cfg, f):
        t = float(feed["stamps"][f] - feed["stamps"][0])
        R, p = traj.pose(t)
        return jodom.init_odom(j_map, cfg).nav._replace(
            R=jnp.asarray(R, jnp.float32), p=jnp.asarray(p, jnp.float32),
            v=jnp.asarray(traj.velocity(t), jnp.float32))

    readings = {}
    for mode in ("merged3", "merged"):
        t_cfg = engine.odom_cfg._replace(query_mode=mode)
        j_cfg = jodom.OdomConfig(**t_cfg._asdict())
        roll = jax.jit(lambda s, sc, im, cfg=j_cfg: j_odom_rollout(s, sc, im, jnp.float32(dt),
                                                                    cfg, j_map))
        # JAX: each window from an empty map, and (merged3) on scan 0's map
        empty = [roll(jodom.init_odom(j_map, j_cfg)._replace(nav=j_fresh_nav(j_cfg, f)),
                      *j_inputs(f, n_scans))[1] for f in starts]
        readings[f"jax {mode} empty map"] = [ate(a["p"], f) for a, f in zip(empty, starts)]
        readings[f"jax {mode} scan-1 matches"] = [int(a["n_matched"][1]) for a in empty]
        # the port's batched rollout of the three windows from empty maps
        states = cs.batch_states("cpu", feed, list(starts), t_cfg, t_map)
        scans, imus, _ = cs.batch_inputs("cpu", feed, list(starts), n_scans)
        _, aux = batched_rollout(states, scans, imus, dt, t_cfg, t_map, device="cpu")
        readings[f"port {mode} empty map"] = [ate(aux["p"][b].numpy(), f)
                                              for b, f in enumerate(starts)]
        readings[f"port {mode} scan-1 matches"] = aux["n_matched"][:, 1].tolist()
        if mode != "merged3":
            continue
        j_warm, t_warm = [], []
        j_st = jodom.init_odom(j_map, j_cfg)._replace(nav=j_fresh_nav(j_cfg, 0))
        t_st = todom.init_odom(t_map, t_cfg, device="cpu")
        t_st = t_st._replace(nav=type(t_st.nav)(*(t[0] for t in
                                                   cs.batch_states("cpu", feed, [0], t_cfg,
                                                                   t_map).nav)))
        k = 0
        for f in starts:  # the run from scan 0, stopped at each window's start
            j_st, _ = roll(j_st, *j_inputs(k, f - k))
            sc, im, _ = cs.batch_inputs("cpu", feed, [k], f - k)
            t_st, _ = todom.odom_rollout(t_st, todom.Scan(*(t[0] for t in sc)),
                                         todom.ImuBatch(*(t[0] for t in im)), dt, t_cfg, t_map,
                                         device="cpu")
            k = f
            j_warm.append(roll(j_st._replace(nav=j_fresh_nav(j_cfg, f)),
                               *j_inputs(f, n_scans))[1])
            fresh = cs.batch_states("cpu", feed, [f], t_cfg, t_map).nav
            t_warm.append(t_st._replace(nav=type(fresh)(*(t[0] for t in fresh))))
        readings["jax merged3 fresh filter on scan 0's map"] = [
            ate(a["p"], f) for a, f in zip(j_warm, starts)]
        _, aux = batched_rollout(stack_states(t_warm), scans, imus, dt, t_cfg, t_map,
                                 device="cpu")
        readings["port merged3 fresh filter on scan 0's map"] = [
            ate(aux["p"][b].numpy(), f) for b, f in enumerate(starts)]
    for name, vals in readings.items():
        print(f"windows {starts}: {name}: {np.round(vals, 4).tolist()}")
    for pkg in ("jax", "port"):
        assert min(readings[f"{pkg} merged3 empty map"]) > 0.10
        assert max(readings[f"{pkg} merged3 fresh filter on scan 0's map"]) < 0.03
        assert max(readings[f"{pkg} merged3 scan-1 matches"]) < 100
        assert min(readings[f"{pkg} merged scan-1 matches"]) > 500
        assert max(readings[f"{pkg} merged empty map"]) < 0.10
