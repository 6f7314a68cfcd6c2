"""The port's feed and engine functions (``eval/feeds.py``) and the scripts
built on them (``profile_pipeline``, ``exp_gps_noinit_probe``,
``roofline_odom``, the XLA parts of ``exp_gather`` and ``microbench_gather``)
against ``bench.py`` and the JAX scripts, on the CPU.

Tolerances, each with its reason:
  * the sequences: equal, key by key and dtype by dtype (the same
    numpy simulation); the engine configurations: equal, field for field;
  * the identity-start rollout (``make_rollout``, the no-init probe): 2 mm a
    scan, the batched rollout's parity tolerance against JAX's
    (``tests/test_torch_batch_eval.py``): the same float32 odometry in
    another order of operations;
  * the pipeline variants: the same keyframes, loops and solves; the
    realtime trajectories within 3 cm over the first 10 scans
    (``tests/test_torch_chunked.py: test_process_chunk_matches_jax``'s
    tolerance on the same feed and length) and within 6 cm over all 80: the
    JAX engine itself moves by up to 4.26 cm (at scan 35) over these 80
    scans when its start moves by 1 µm (measured, three shifts), and the
    port lies 5.12 cm from it at most (scan 34), the odometry's float32
    rounding on this feed, the same in every variant;
  * ``io_bytes``: equal but for the leaves the port keeps on the host (named
    below); the counts of two calls: equal;
  * the one-hot gather, the windows, the chained gather and the
    microbenchmark's gathers: equal, bit for bit; the float sums JAX's
    microbenchmark returns: relative 1e-5 (the same terms summed in another
    order); the scatter-adds (fixed order here, XLA's order there): relative
    1e-6, absolute 1e-6.
The JAX scripts' functions are read from their files (``ast``) and run at
the small sizes with their own code; their timing and Pallas parts are not
run.
"""
import ast
import copy
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.odom.pipeline import odom_step as jodom_step  # noqa: E402
from fastliosam_tpu_torch import runtime as trt  # noqa: E402
from fastliosam_tpu_torch.eval import feeds  # noqa: E402
from fastliosam_tpu_torch.scripts import (  # noqa: E402
    exp_gather, exp_gps_noinit_probe, microbench_gather, profile_pipeline, roofline_odom)
from fastliosam_tpu_torch.sim import SimConfig, simulate_sequence  # noqa: E402

from _torch_parity import N  # noqa: E402
from test_torch_engine import CFGS, JAX_CLS, PORT_CLS, loop_feed  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
# the pipeline variants' engine: tests/test_engine.py's, its loop clouds cut
# (the CPU's plain nearest neighbours dominate a verification) so that four
# variants of both packages fit the file's time
PIPE_CFGS = copy.deepcopy(CFGS)
PIPE_CFGS["cfg"]["kf_cloud_points"] = 1024
PIPE_CFGS["loop_cfg"]["submap_points"] = 4096
PIPE_SCANS, PIPE_CHUNK = 80, 4  # the first loop closes after ~70 scans


@pytest.fixture(scope="module")
def bench():
    """``bench.py``, imported without its compilation-cache setting leaking
    into the environment of later tests."""
    saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    sys.path.insert(0, str(REPO))
    try:
        import bench as mod
    finally:
        sys.path.remove(str(REPO))
        if saved is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved
    return mod


def _jax_functions(path, names, env, outer=None, unsum=()):
    """The functions ``names`` of a JAX script, read from its file (inside
    the function ``outer`` where they are nested) and defined in ``env``; in
    those listed in ``unsum`` a ``return a.sum(), b.sum()`` returns ``a, b``."""
    tree = ast.parse(Path(path).read_text())
    body = tree.body
    if outer is not None:
        body = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == outer).body
    defs = [n for n in body if isinstance(n, ast.FunctionDef) and n.name in names]
    for d in defs:
        if d.name in unsum:
            ret = d.body[-1]
            ret.value = ast.Tuple([e.func.value for e in ret.value.elts], ast.Load())
    mod = ast.fix_missing_locations(ast.Module(defs, []))
    ns = dict(env)
    exec(compile(mod, str(path), "exec"), ns)
    return [ns[n] for n in names]


# ---------------------------------------------------------------------------
# the feeds and the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["build_sequence", "build_fig8_sequence",
                                  "build_corridor_sequence", "build_livox_sequence"])
def test_sequences_match_bench(bench, name, monkeypatch):
    for const in ("PIPE_SCANS", "CORR_SCANS", "N_SCANS"):
        monkeypatch.setattr(bench, const, 3)
    monkeypatch.setattr(bench, "N_WARM", 0)  # N_SCANS + N_WARM = 3 scans
    want = getattr(bench, name)()
    got = getattr(feeds, name)(3)
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert len(got["xyz"]) == 3


def test_cached_sequence_round_trip(tmp_path):
    built = {"calls": 0}

    def build():
        built["calls"] += 1
        return {"a": np.arange(3, dtype=np.float32), "dt": np.float32(0.1)}

    path = tmp_path / "sub" / "feed.npz"
    first = feeds._cached(path, build)
    second = feeds._cached(path, build)
    assert built["calls"] == 1 and path.exists() and not list(path.parent.glob("*.tmp.npz"))
    for k in first:
        np.testing.assert_array_equal(first[k], second[k])
        assert np.asarray(first[k]).dtype == second[k].dtype
    assert feeds.cache_path("fig8", 150) == feeds.CACHE_DIR / "fig8_150.npz"
    assert str(feeds.CACHE_DIR).endswith(os.path.join("build", "feeds"))


@pytest.mark.parametrize("kw", [{}, {"chunk": 4, "max_kf": 256, "max_between": 512,
                                     "max_gps": 256}])
def test_make_engine_for_matches_bench(bench, kw):
    je = bench.make_engine_for(None, **kw)
    te = feeds.make_engine_for(None, device="cpu", **kw)
    for name in ("odom_cfg", "map_cfg", "loop_cfg", "pgo_cfg", "cfg"):
        j, t = getattr(je, name), getattr(te, name)
        assert type(t).__name__ == type(j).__name__
        assert t._asdict() == j._asdict(), name
    assert te.device.type == "cpu" and te.kf.n == 0


def _narrow_feed(n_scans=15, n_azimuth=512):
    """``build_sequence``'s world, path and sensor at 512 x 16 rays."""
    from fastliosam_tpu_torch.sim import PlaneWorld, Trajectory

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=7)
    traj = Trajectory.circle(radius=8.0, period=40.0, z_amp=0.3)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=n_azimuth, n_elev=16, max_range=120.0,
                    gyro_noise=0.001, acc_noise=0.01, seed=7, time_groups=32)
    return feeds.pack_sequence(simulate_sequence(world, traj, cfg, n_scans=n_scans), traj)


def test_make_rollout_and_noinit_probe_match_jax(bench):
    """The identity-start rollout of both packages' ``make_rollout`` on one
    packed feed (512 x 16 rays, 2048 iEKF points, 15 scans), and the no-init
    probe's per-scan errors against JAX's rollout."""
    data = _narrow_feed()
    raw_pts, num_ds = 8192, 2048
    jctx = bench.make_rollout(data, raw_pts=raw_pts, num_ds=num_ds)
    tctx = feeds.make_rollout(data, raw_pts=raw_pts, num_ds=num_ds, device="cpu")
    assert tctx["S"] == jctx["S"] == 15
    assert tctx["odom_cfg"]._asdict() == jctx["odom_cfg"]._asdict()
    assert tctx["map_cfg"]._asdict() == jctx["map_cfg"]._asdict()
    for a, b in zip(tctx["scans"], jctx["scans"]):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    for jit in (0.0, 2e-4):
        js, ts = jctx["gt_state"](jit), tctx["gt_state"](jit)
        for f in ("R", "p", "v"):
            np.testing.assert_array_equal(N(getattr(ts.nav, f)), np.asarray(getattr(js.nav, f)))
    _, jaux = jctx["roll"](jctx["identity_state"](), jctx["scans"], jctx["imus"])
    out, detail = exp_gps_noinit_probe.probe_no_init("cpu", data, raw_pts=raw_pts,
                                                     num_ds=num_ds)
    jp = np.asarray(jaux["p"])
    assert np.abs(detail["p"] - jp).max() < 2e-3
    gt_local = (data["gt_p"][:15] - data["p0"]) @ data["R0"]
    jerr = np.linalg.norm(jp - gt_local, axis=1)
    np.testing.assert_allclose(detail["err"], jerr, atol=2e-3)
    assert len(out["per_scan_err"]) == 15 and np.all(np.isfinite(detail["err"]))
    assert out["ate_all"] == round(float(np.sqrt(np.mean(detail["err"] ** 2))), 4)
    assert set(out) == {"per_scan_err", "ate_all", "ate_skip5", "ate_skip10"}


# start draws: p moved on every axis by -12..12 µm in 1 µm steps and 5 more
NOINIT_SHIFTS_M = tuple(k * 1e-6 for k in range(-12, 13)) + (-1e-5, 2e-5, -2e-5, 5e-5, 1e-4)


@pytest.mark.slow
def test_noinit_probe_jax_reading(bench):
    """The JAX package's no-init reading on the bench's odometry feed at full
    width (43 scans of 2048 x 16 rays, 8192 iEKF points, a 2^19-slot map),
    from the identity state and from it moved by 1-100 µm (30 draws): the
    first scans' errors are the same in every draw (0.1259 m at scan 0: the
    zero start velocity), but float32 rounding then spreads the run's RMS
    over 0.0847-0.1532 m (median 0.1022), so ``chip_smoke.py`` phase 14
    gates the port's card reading at the largest of these draws
    (``NOINIT_JAX_ATE_M``) + 1 cm. Prints the readings (~90 s)."""
    data = feeds.get_sequence()
    ctx = bench.make_rollout(data)
    gt_local = (data["gt_p"][: ctx["S"]] - data["p0"]) @ data["R0"]
    readings = []
    for shift in NOINIT_SHIFTS_M:
        st = ctx["identity_state"]()
        st = st._replace(nav=st.nav._replace(p=st.nav.p + jnp.float32(shift)))
        _, aux = ctx["roll"](st, ctx["scans"], ctx["imus"])
        err = np.linalg.norm(np.asarray(aux["p"]) - gt_local, axis=1)
        readings.append(float(np.sqrt(np.mean(err ** 2))))
        print(f"JAX no-init ate_all, start moved {shift:g} m: {readings[-1]:.6f} m, "
              f"scans 0-4 {np.round(err[:5], 4).tolist()}")
    print(f"JAX no-init ate_all over {len(readings)} draws: {min(readings):.6f}-"
          f"{max(readings):.6f} m, median {np.median(readings):.6f} m")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert abs(max(readings) - chip_smoke.NOINIT_JAX_ATE_M) < 5e-5


# ---------------------------------------------------------------------------
# profile_pipeline
# ---------------------------------------------------------------------------
def _packed_loop_feed(loop_feed, n):
    data, traj = loop_feed
    data = dict(data, scans=data["scans"][:n], imu=data["imu"][:n], gt=data["gt"][:n],
                stamps=data["stamps"][:n])
    return feeds.pack_sequence(data, traj)


def _jax_variants(bench, data, chunk):
    """``scripts/profile_pipeline.py``'s ``run`` on the JAX engine with the
    test's configuration, once a variant: ``{variant: (stats, traj)}``."""
    import jax.numpy as jnp

    engine = jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in PIPE_CFGS.items()})
    engine_nokf = jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in PIPE_CFGS.items()})
    engine_nokf.cfg = engine_nokf.cfg._replace(keyframe_threshold=1e9)
    engine_nokf._build_programs()
    S = data["xyz"].shape[0]
    feed = []
    for c in range(0, S - (S % chunk), chunk):
        sl = slice(c, c + chunk)
        feed.append((jodom.Scan(*(jnp.asarray(data[k][sl]) for k in ("xyz", "toff", "mask"))),
                     jodom.ImuBatch(*(jnp.asarray(data[k][sl])
                                      for k in ("imu_t", "imu_g", "imu_a", "imu_m"))),
                     data["stamps"][sl], float(data["scan_dt"])))
    out = {}
    for variant, deferred in profile_pipeline.VARIANTS:
        v = variant.replace("_deferred", "")
        e = engine_nokf if v == "no_kf" else engine
        bench._init_engine_at(e, data)
        if v == "no_verify":
            e._loop_processed_kf = 1 << 30
        step = e.process_chunk_deferred if deferred else e.process_chunk
        for scans, imus, stamps, sdt in feed:
            step(scans, imus, stamps, sdt)
            if v == "no_verify":
                e._loop_processed_kf = 1 << 30
        e.finish()
        out[variant] = ((e.kf.n, len(e.loop_pairs), e.solve_count), np.stack(e.realtime_traj))
    return out


def _port_ctx(data, chunk):
    engine = trt.SlamEngine(**{k: PORT_CLS[k](**v) for k, v in PIPE_CFGS.items()},
                            device="cpu")
    engine_nokf = trt.SlamEngine(**{k: PORT_CLS[k](**v) for k, v in PIPE_CFGS.items()},
                                 device="cpu")
    engine_nokf.cfg = engine_nokf.cfg._replace(keyframe_threshold=1e9)
    feed, _ = feeds._stage_chunks(data, chunk, "cpu", raw_pts=data["xyz"].shape[1])
    return {"data": data, "engine": engine, "engine_nokf": engine_nokf, "feed": feed,
            "n_fed": len(feed) * chunk}


def test_profile_pipeline_variants_match_jax(bench, loop_feed):
    data = _packed_loop_feed(loop_feed, PIPE_SCANS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both grow their graphs
        want = _jax_variants(bench, data, PIPE_CHUNK)
        ctx = _port_ctx(data, PIPE_CHUNK)
        got = {variant: profile_pipeline.run(ctx, variant.replace("_deferred", ""), deferred)
               for variant, deferred in profile_pipeline.VARIANTS}
    for variant, (stats, traj) in want.items():
        _, t_stats, t_traj, t_loops = got[variant]
        assert t_stats == stats, variant
        np.testing.assert_allclose(t_traj[:10], traj[:10], atol=3e-2, err_msg=variant)
        np.testing.assert_allclose(t_traj, traj, atol=6e-2, err_msg=variant)
    # the variants measure what they are named for: loops and solves in the
    # full runs, none without verification, one keyframe without keyframes
    assert want["full"][0][1] >= 1 and want["full"][0][2] >= 1
    assert want["full_deferred"][0][1] >= 1
    assert want["no_verify"][0][1:] == (0, 0)
    assert want["no_kf"][0][0] == 1


def test_profile_pipeline_record_and_threshold_read_at_call_time(loop_feed):
    """``profile`` on a short stretch of the feed (no loops): the JAX
    script's keys, each timed run equal to its warm run, and the no_kf
    engine's threshold read at call time (a threshold cached anywhere would
    make no_kf measure full)."""
    data = _packed_loop_feed(loop_feed, 12)
    ctx = _port_ctx(data, PIPE_CHUNK)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ctx["engine_nokf"].cfg = ctx["engine_nokf"].cfg._replace(keyframe_threshold=0.5)
        assert profile_pipeline.run(ctx, "no_kf")[1][0] > 1
        ctx["engine_nokf"].cfg = ctx["engine_nokf"].cfg._replace(keyframe_threshold=1e9)
        out, runs = profile_pipeline.profile(ctx, reps=1)
    assert set(out) == {v for v, _ in profile_pipeline.VARIANTS} | {"attribution_s"}
    for variant, _ in profile_pipeline.VARIANTS:
        rec = out[variant]
        assert set(rec) >= {"wall_s", "scans_per_sec", "kf_loops_solves"}
        assert rec["replay_equal"] and rec["wall_s"] > 0
        assert rec["launches"]["nearest_neighbors"] == 0  # the CPU runs no kernel
        assert runs[variant]["traj"].shape == (12, 4, 4)
    assert out["no_kf"]["kf_loops_solves"][0] == 1 < out["full"]["kf_loops_solves"][0]
    assert set(out["attribution_s"]) == {"verify_plus_solve", "keyframe_commit", "chunked_odom"}


# ---------------------------------------------------------------------------
# roofline_odom
# ---------------------------------------------------------------------------
def test_roofline_counts_and_io_bytes(bench):
    data = _narrow_feed(n_scans=2)
    raw_pts, num_ds = 8192, 2048
    rec1 = roofline_odom.measure(torch.device("cpu"), raw_pts, num_ds, reps=1, chip="cpu",
                                 data=data)
    rec2 = roofline_odom.measure(torch.device("cpu"), raw_pts, num_ds, reps=1, chip="cpu",
                                 data=data)
    keys = ("flops_per_step", "xla_bytes_accessed", "io_bytes_per_step", "matmul_flops",
            "elementwise_flops", "counted_ops")
    assert {k: rec1[k] for k in keys} == {k: rec2[k] for k in keys}
    assert rec1["flops_per_step"] > rec1["matmul_flops"] > 0 and rec1["finite"]
    assert rec1["xla_bytes_accessed"] > rec1["io_bytes_per_step"] > 0
    assert rec1["kernel_bytes"] == {}  # the CPU runs the plain versions: all seen
    assert set(roofline_odom.PEAKS) == {"h100", "cpu"}
    assert not any("tpu" in k for k in roofline_odom.PEAKS)
    for k in ("metric", "backend", "raw_pts", "num_ds_points", "measured_ms",
              "roofline_flops_ms", "roofline_xla_bytes_ms", "roofline_io_bytes_ms", "bound",
              "pct_of_xla_bytes_roofline", "speed_of_light_ms"):
        assert k in rec1
    # io_bytes against the JAX script's count at the same shapes
    ctx = bench.make_rollout(data, raw_pts=raw_pts, num_ds=num_ds)
    dt = jnp.float32(data["scan_dt"])
    scan0 = jax.tree.map(lambda x: x[0], ctx["scans"])
    imu0 = jax.tree.map(lambda x: x[0], ctx["imus"])
    shapes = jax.eval_shape(lambda st, sc, im: jodom_step(st, sc, im, dt, ctx["odom_cfg"],
                                                          ctx["map_cfg"]),
                            ctx["gt_state"](), scan0, imu0)
    jax_io = sum(np.prod(s.shape) * s.dtype.itemsize for s in jax.tree.leaves(shapes)) + sum(
        np.prod(x.shape) * x.dtype.itemsize for x in jax.tree.leaves((scan0, imu0)))
    # the leaves whose dtype differs: the port's state keeps scan_idx (JAX:
    # an int32 scalar) and initialized (JAX: a bool scalar) on the host, and
    # its aux["n_matched"] is an int64 scalar (JAX: int32)
    state, aux = shapes
    host_leaves = state.scan_idx.dtype.itemsize + state.initialized.dtype.itemsize
    assert host_leaves == 4 + 1 and aux["n_matched"].dtype == jnp.int32
    assert rec1["io_bytes_per_step"] == float(jax_io - host_leaves + (8 - 4))


# ---------------------------------------------------------------------------
# the gather experiments
# ---------------------------------------------------------------------------
def _bits(x):
    a = np.ascontiguousarray(N(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_xla_experiments_match_jax():
    c, n, c1, c2 = 1 << 12, 1024, 8, 512
    host = exp_gather.xla_tables(c)
    tabs = {k: torch.from_numpy(v) for k, v in host.items()}
    i7 = exp_gather.xla_indices(7, n, c)
    i3 = exp_gather.xla_indices(3, n, c) & (c - 5)
    # exp_c: the inner `run` of exp_c_onehot_mxu, with its table reshaped
    table = jnp.asarray(host["assoc16"])
    (jrun,) = _jax_functions(SCRIPTS / "exp_assoc_kernels.py", ["run"],
                             {"jax": jax, "jnp": jnp, "C1": c1, "C2": c2,
                              "tab_r": table.reshape(c1, c2 * 16)}, outer="exp_c_onehot_mxu")
    got = exp_gather.onehot_gather(tabs["assoc16"], torch.from_numpy(i7), c1, c2)
    np.testing.assert_array_equal(_bits(got), _bits(jrun(jnp.asarray(i7))))
    np.testing.assert_array_equal(_bits(got), _bits(table[i7]))  # the exactness check
    # exp_d: the window and the four gathers
    jwin, jfour = _jax_functions(SCRIPTS / "exp_assoc_kernels.py", ["window", "four_gathers"],
                                 {"jax": jax, "jnp": jnp, "table": table, "C": c},
                                 outer="exp_d_probe_windows")
    win = exp_gather.window_rows(tabs["assoc16"], torch.from_numpy(i3))
    four = exp_gather.four_gathers(tabs["assoc16"], torch.from_numpy(i3))
    np.testing.assert_array_equal(_bits(win), _bits(jwin(jnp.asarray(i3))))
    np.testing.assert_array_equal(_bits(four), _bits(jfour(jnp.asarray(i3))))
    np.testing.assert_array_equal(_bits(win), _bits(four))
    # exp_pallas_gather.py's chained gather and scatter-add
    env = {"jax": jax, "jnp": jnp, "C": c, "N": n,
           **{name: jnp.asarray(host[k]) for name, k in (("table16", "t16"), ("table1d", "t1d"))}}
    jchain, jscat = _jax_functions(SCRIPTS / "exp_pallas_gather.py", ["chain", "scat"], env,
                                   outer="main")
    i0 = exp_gather.xla_indices(0, n, c)
    got = exp_gather.chained_gather(tabs["t1d"], torch.from_numpy(i0))
    np.testing.assert_array_equal(N(got), np.asarray(jax.jit(jchain)(jnp.asarray(i0))))
    got = exp_gather.scatter_rows(tabs["t16"], torch.from_numpy(i0), n)
    np.testing.assert_allclose(N(got), np.asarray(jax.jit(jscat)(jnp.asarray(i0))),
                               rtol=1e-6, atol=1e-6)
    # the row gathers of the timings
    for k in ("t16", "t10", "t128", "t1d"):
        np.testing.assert_array_equal(
            _bits(exp_gather.gather_cuda.gather_rows(tabs[k], torch.from_numpy(i0))),
            _bits(jnp.asarray(host[k])[i0]))
    # the entry point's records on the CPU
    recs = exp_gather.run_xla("cpu", reps=2, c=c, n=n, c1=c1, c2=c2, print_fn=lambda _: None)
    assert recs[0]["exact"] and recs[1]["equal_four_gathers"]
    assert all(r["ms"] is None and r["equal_cpu"] is None for r in recs)


def test_chained_gather_cast_truncates_toward_zero():
    """The float read of the chain is cast to int32 as XLA's convert casts:
    toward zero, for negative and positive values alike."""
    vals = np.array([-2.9, -1.5, -0.5, -0.0, 0.4, 1.0, 1.7, 2.5, -3.99, 3.99], np.float32)
    table = np.resize(vals, 16).astype(np.float32)
    idx = np.arange(16, dtype=np.int32)
    got = exp_gather.chained_gather(torch.from_numpy(table), torch.from_numpy(idx), links=1)
    want = (jnp.asarray(table)[idx].astype(jnp.int32) ^ idx) & 15
    np.testing.assert_array_equal(N(got), np.asarray(want))


def test_microbench_gather_matches_jax():
    c, n = 1 << 12, 1024
    narrow, bucketed, scatter = _jax_functions(
        SCRIPTS / "microbench_gather.py", ["narrow", "bucketed", "narrow_scatter"],
        {"jax": jax, "jnp": jnp, "C": c, "B": c // 4, "N": n}, unsum=("narrow", "bucketed"))
    sums = _jax_functions(SCRIPTS / "microbench_gather.py", ["narrow", "bucketed"],
                          {"jax": jax, "jnp": jnp, "C": c, "B": c // 4, "N": n})
    x = microbench_gather.inputs("cpu", c, n, 0)
    # the JAX script's arrays, drawn in its order
    rng = np.random.default_rng(0)
    fp = jnp.asarray(rng.integers(1, 1 << 30, size=(c,), dtype=np.int32))
    moments = jnp.asarray(rng.normal(size=(c, 10)).astype(np.float32))
    tbl = jnp.concatenate([jax.lax.bitcast_convert_type(fp, jnp.float32).reshape(c // 4, 4, 1),
                           moments.reshape(c // 4, 4, 10)], axis=-1)
    idx = jnp.asarray(rng.integers(0, c, size=(n,), dtype=np.int32))
    np.testing.assert_array_equal(_bits(x["tbl"]), _bits(tbl))
    np.testing.assert_array_equal(N(x["idx"]), np.asarray(idx))
    for port, jfn, jsum, args in (
            (microbench_gather.narrow, narrow, sums[0], (fp, moments, idx)),
            (microbench_gather.bucketed, bucketed, sums[1], (tbl, idx >> 2))):
        acc, tot = port("cpu", c, n, 0)
        jacc, jtot = jfn(*args)
        np.testing.assert_array_equal(_bits(acc), _bits(jacc))
        np.testing.assert_array_equal(N(tot), np.asarray(jtot))
        jacc_sum, jtot_sum = jsum(*args)
        np.testing.assert_allclose(float(acc.sum()), float(jacc_sum), rtol=1e-5)
        assert int(tot.to(torch.int64).sum()) == int(jtot_sum)
    got = microbench_gather.narrow_scatter("cpu", c, n, 0)
    want = scatter(moments, idx, jnp.ones((n, 10), jnp.float32))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    rec = microbench_gather.run("cpu", c, n, 0, reps=1)
    assert rec["narrow_ms"] is None and rec["bucketed_ms"] is None
    assert rec["narrow_sums"][1] == int(sums[0](fp, moments, idx)[1])
    assert rec["bucketed_sums"][1] == int(sums[1](tbl, idx >> 2)[1])
