"""The port's result export and checkpoint/resume
(``fastliosam_tpu_torch/runtime/persistence.py``) against the JAX
package's, on the first scans of the loop feed of ``tests/test_engine.py``.

Tolerances and why:
  * ``save_results``: the same file set, npz keys, shapes and dtypes, PCD
    header fields and row counts as the JAX export of the same run. The
    map's point count within 2% (the map assembles keyframe clouds that
    sit within the engine tolerance below, voxelized again).
  * A checkpoint round-trip in the port restores every tensor bit for bit,
    and the restored engine continues exactly as the original one does.
  * A JAX-written checkpoint restores into the port bit for bit; from that
    state both packages continue 5 scans with realtime positions within
    2 cm and the same keyframe decisions, the engine tolerance of
    ``tests/test_torch_engine.py`` (float32 rounding alone moves the JAX
    engine by 1.37 cm over 10 scans of this feed).
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch import runtime as trt  # noqa: E402

from _torch_parity import N, T  # noqa: E402
from test_torch_engine import CFGS, JAX_CLS, PORT_CLS, _imu  # noqa: E402

N_FIRST, N_MORE = 10, 5


@pytest.fixture(scope="module")
def feed():
    """The first scans of the loop feed of tests/test_engine.py."""
    world = PlaneWorld.room(size=30.0, height=6.0, n_boxes=10, seed=1)
    traj = Trajectory.circle(radius=8.0, period=16.0)
    cfg = SimConfig(scan_rate=5.0, n_azimuth=256, n_elev=10, gyro_noise=0.001,
                    acc_noise=0.01, gyro_bias=(0, 0, 0), acc_bias=(0, 0, 0), seed=3)
    return simulate_sequence(world, traj, cfg, n_scans=N_FIRST + N_MORE), traj


def _jax_engine(traj):
    e = jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in CFGS.items()})
    R0, p0 = traj.pose(0.0)
    e.odom = e.odom._replace(nav=e.odom.nav._replace(
        R=jnp.asarray(R0, jnp.float32), p=jnp.asarray(p0, jnp.float32),
        v=jnp.asarray(traj.velocity(0.0), jnp.float32)))
    return e


def _port_engine(traj=None):
    e = trt.SlamEngine(**{k: PORT_CLS[k](**v) for k, v in CFGS.items()}, device="cpu")
    if traj is not None:
        R0, p0 = traj.pose(0.0)
        e.odom = e.odom._replace(nav=e.odom.nav._replace(
            R=T(R0, np.float32), p=T(p0, np.float32), v=T(traj.velocity(0.0), np.float32)))
    return e


def _drive(e, data, ks, pkg):
    mk_scan, mk_imu, arr = ((jodom.Scan, jodom.ImuBatch, jnp.asarray) if pkg == "jax"
                            else (todom.Scan, todom.ImuBatch, T))
    for k in ks:
        e.process(mk_scan(*map(arr, data["scans"][k])), mk_imu(*map(arr, _imu(data, k))),
                  data["stamps"][k], data["scan_dt"])
    return e


@pytest.fixture(scope="module")
def runs(feed):
    """Both engines after the first N_FIRST scans."""
    data, traj = feed
    j = _drive(_jax_engine(traj), data, range(N_FIRST), "jax")
    t = _drive(_port_engine(traj), data, range(N_FIRST), "port")
    assert t.kf.n == j.kf.n > 3
    return j, t


def _pcd_header(path):
    head = {}
    with open(path, "rb") as f:
        for line in f:
            key, _, val = line.decode().strip().partition(" ")
            head[key] = val
            if key == "DATA":
                break
    return head


def test_save_results_matches_jax_export(runs, tmp_path):
    j, t = runs
    jp = jrt.save_results(j, str(tmp_path / "jax"), "seq")
    tp = trt.save_results(t, str(tmp_path / "port"), "seq")
    assert set(tp) == set(jp) == {"kitti", "tum", "tum_scans", "map_pcd", "viewer",
                                   "keyframes", "meta"}
    for key in tp:
        assert tp[key].split("/")[-1] == jp[key].split("/")[-1]
    a, b = np.load(tp["keyframes"]), np.load(jp["keyframes"])
    assert set(a.files) == set(b.files) == {"poses", "stamps", "clouds", "masks"}
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    np.testing.assert_allclose(a["poses"], b["poses"], atol=2e-2)
    np.testing.assert_array_equal(a["stamps"], b["stamps"])
    ha, hb = _pcd_header(tp["map_pcd"]), _pcd_header(jp["map_pcd"])
    assert set(ha) == set(hb)
    for key in ("VERSION", "FIELDS", "SIZE", "TYPE", "COUNT", "HEIGHT", "VIEWPOINT", "DATA"):
        assert ha[key] == hb[key], key
    n_a, n_b = int(ha["POINTS"]), int(hb["POINTS"])
    assert n_a == int(ha["WIDTH"]) and abs(n_a - n_b) <= 0.02 * n_b
    for key in ("kitti", "tum", "tum_scans"):
        la, lb = open(tp[key]).read().splitlines(), open(jp[key]).read().splitlines()
        assert len(la) == len(lb) > 0 and len(la[0].split()) == len(lb[0].split())
    ma, mb = json.load(open(tp["meta"])), json.load(open(jp["meta"]))
    assert ma == mb
    assert open(tp["viewer"]).read().startswith("<!DOCTYPE html>")


def _state_arrays(e):
    """Every array of an engine's checkpointed state, as numpy."""
    from fastliosam_tpu_torch.runtime.persistence import _tree_to_dict

    out = _tree_to_dict("odom", e.odom)
    out.update(_tree_to_dict("graph", e.graph))
    for name in ("clouds", "masks", "raw_poses", "stamps"):
        out[f"kf.{name}"] = N(getattr(e.kf, name))
    return out


def test_checkpoint_roundtrip_bitwise(feed, runs, tmp_path):
    data, traj = feed
    _, t = runs
    path = str(tmp_path / "port_ckpt.npz")
    trt.save_checkpoint(t, path)
    r = trt.load_checkpoint(_port_engine(), path)
    want, got = _state_arrays(t), _state_arrays(r)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    for name in ("scan_count", "solve_count", "traj_len", "loop_pairs", "scan_stamps",
                 "_n_bt_host", "_n_gps_host"):
        assert getattr(r, name) == getattr(t, name), name
    assert r.kf.n == t.kf.n and r.pgo_cfg == t.pgo_cfg
    np.testing.assert_array_equal(np.stack(r.realtime_traj), np.stack(t.realtime_traj))
    np.testing.assert_array_equal(np.stack(r.raw_traj), np.stack(t.raw_traj))
    assert r._kf_n_dev is None and not r._pending_chunks and r.match_counts == []
    assert r.odom.vmap.fp.device == r.device
    # the original and the restored engine continue identically
    t2 = trt.load_checkpoint(_port_engine(), path)  # leave the module's engine untouched
    _drive(t2, data, range(N_FIRST, N_FIRST + N_MORE), "port")
    _drive(r, data, range(N_FIRST, N_FIRST + N_MORE), "port")
    np.testing.assert_array_equal(np.stack(r.realtime_traj), np.stack(t2.realtime_traj))
    np.testing.assert_array_equal(r.keyframe_poses(), t2.keyframe_poses())


def test_checkpoint_refuses_chunks_in_flight(feed, tmp_path):
    data, traj = feed
    e = _port_engine(traj)
    ks = range(4)
    e.process_chunk_deferred(todom.Scan(*(T(np.stack([data["scans"][k][i] for k in ks]))
                                          for i in range(3))),
                             todom.ImuBatch(*(T(np.stack([_imu(data, k)[i] for k in ks]))
                                              for i in range(4))),
                             [data["stamps"][k] for k in ks], data["scan_dt"])
    with pytest.raises(RuntimeError, match="in flight"):
        trt.save_checkpoint(e, str(tmp_path / "x.npz"))
    e.finish()
    trt.save_checkpoint(e, str(tmp_path / "x.npz"))
    assert trt.load_checkpoint(_port_engine(), str(tmp_path / "x.npz")).scan_count == 4


def test_jax_checkpoint_loads_into_port_and_continues(feed, runs, tmp_path):
    data, traj = feed
    j, _ = runs
    path = str(tmp_path / "jax_ckpt.npz")
    jrt.save_checkpoint(j, path)
    t = trt.load_checkpoint(_port_engine(), path)
    blob = np.load(path)
    got = _state_arrays(t)
    for k, v in got.items():
        assert v.dtype == blob[k].dtype and np.array_equal(v, blob[k]), k
    assert t.kf.n == j.kf.n and t.scan_count == j.scan_count == N_FIRST
    assert t.odom.scan_idx == int(j.odom.scan_idx) and t.odom.initialized
    # both continue from the same state
    j2 = jrt.load_checkpoint(_jax_engine(traj), path)
    _drive(j2, data, range(N_FIRST, N_FIRST + N_MORE), "jax")
    _drive(t, data, range(N_FIRST, N_FIRST + N_MORE), "port")
    assert t.kf.n == j2.kf.n and t._n_bt_host == j2._n_bt_host
    tp, jp = np.stack(t.realtime_traj), np.stack(j2.realtime_traj)
    np.testing.assert_array_equal(tp[:N_FIRST], jp[:N_FIRST])
    np.testing.assert_allclose(tp[N_FIRST:], jp[N_FIRST:], atol=2e-2)
    np.testing.assert_allclose(t.keyframe_poses(), np.asarray(j2.keyframe_poses()), atol=2e-2)


def test_port_checkpoint_loads_into_jax(runs, tmp_path):
    """The reverse: the JAX package restores the port's checkpoint, every
    array bit for bit with the JAX dtypes."""
    from fastliosam_tpu.runtime.persistence import _tree_to_dict as jax_tree

    _, t = runs
    path = str(tmp_path / "port_ckpt.npz")
    trt.save_checkpoint(t, path)
    j = jrt.load_checkpoint(jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in CFGS.items()}),
                            path)
    blob = np.load(path)
    restored = jax_tree("odom", j.odom)
    restored.update(jax_tree("graph", j.graph))
    for k, v in restored.items():
        assert v.dtype == blob[k].dtype and np.array_equal(v, blob[k]), k
    assert j.kf.n == t.kf.n and j.scan_count == t.scan_count and j.loop_pairs == t.loop_pairs
    np.testing.assert_array_equal(np.asarray(j.kf.clouds), blob["kf.clouds"])
