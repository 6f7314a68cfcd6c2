"""The port's dataset entry point: ``runtime/drivers.py: drive_kitti``
against the JAX package's on the same synthetic KITTI directory, the
port's q16 upload against its float32 upload, the synthetic-KITTI
generator against the JAX script byte for byte, and the port's
``run_slam`` / ``localize`` scripts through their ``main`` on the CPU.

Tolerances and why:
  * Port against JAX over 30 scans of the generator's circuit (512 x 16
    rays, chunk 3, LiDAR-only, inputs equal bit for bit after the device
    prep): the same keyframe decisions and loop pairs, realtime positions
    within 2 cm, the engine tolerance of ``tests/test_torch_engine.py``
    (float32 rounding alone moves the JAX engine itself by 1.37 cm over 10
    scans of its loop feed when its start moves by 1 µm). Measured: 3.6 mm
    at most. At 256 x 10 rays the second update matches only 64-69 points
    on a two-scan map, and from the same state the two packages' float32
    plane fits already land 3.2 cm apart there, so the feed is denser.
  * q16 against f32 through the port: 3 cm, and the same keyframe count,
    the JAX test's tolerance (``tests/test_datasets.py:38``): int16 steps
    of 1/256 m move points by up to 2 mm.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402, F401

from fastliosam_tpu import loop as jloop  # noqa: E402
from fastliosam_tpu import map as jmap  # noqa: E402
from fastliosam_tpu import odom as jodom  # noqa: E402
from fastliosam_tpu import pgo as jpgo  # noqa: E402
from fastliosam_tpu import runtime as jrt  # noqa: E402
from fastliosam_tpu.runtime.drivers import drive_kitti as jax_drive_kitti  # noqa: E402
from fastliosam_tpu_torch import loop as tloop  # noqa: E402
from fastliosam_tpu_torch import map as tmap  # noqa: E402
from fastliosam_tpu_torch import odom as todom  # noqa: E402
from fastliosam_tpu_torch import pgo as tpgo  # noqa: E402
from fastliosam_tpu_torch import runtime as trt  # noqa: E402
from fastliosam_tpu_torch.runtime.drivers import drive_kitti  # noqa: E402
from fastliosam_tpu_torch.scripts import make_kitti_synth  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N_SCANS = 30

# the bench's long-run engine (bench.py: _make_longrun_engine) at test width
LONGRUN = dict(
    odom_cfg=dict(point_filter_num=2, blind=1.0, filter_size_surf=0.5, num_ds_points=1024,
                  det_range=60.0, evict_every=10, query_mode="merged3"),
    map_cfg=dict(capacity=1 << 15, voxel_size=0.5, min_points=5),
    loop_cfg=dict(radius=10.0, time_gap=4.0, num_submap_keyframes=5, voxel_res=0.3,
                  submap_points=2048, icp_score_threshold=0.5, max_sqrt_info=1.0),
    pgo_cfg=dict(max_keyframes=32, max_between=64, max_gps=8, lm_iters=8, loop_gnc_barc=2.0,
                 gnc_hop_trans_var=0.1),
    cfg=dict(keyframe_threshold=1.0, loop_check_every=3, kf_cloud_points=512,
             kf_cloud_voxel=0.3),
)
JAX_CLS = dict(odom_cfg=jodom.OdomConfig, map_cfg=jmap.VoxelMapConfig, loop_cfg=jloop.LoopConfig,
               pgo_cfg=jpgo.PoseGraphConfig, cfg=jrt.EngineConfig)
PORT_CLS = dict(odom_cfg=todom.OdomConfig, map_cfg=tmap.VoxelMapConfig,
                loop_cfg=tloop.LoopConfig, pgo_cfg=tpgo.PoseGraphConfig, cfg=trt.EngineConfig)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_make_kitti_synth",
                                                  REPO / "scripts" / "make_kitti_synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_synth")
    make_kitti_synth.generate(str(root), "00", n_scans=N_SCANS, n_azimuth=512, n_elev=16,
                              progress=False)
    return str(root)


def _files(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_make_kitti_synth_bytes_equal_jax_script(tmp_path):
    """The same arguments write the same bytes, with one process or two."""
    kw = dict(n_scans=4, n_azimuth=128, n_elev=8, progress=False)
    _jax_script().generate(str(tmp_path / "jax"), "03", **kw)
    make_kitti_synth.generate(str(tmp_path / "port"), "03", **kw)
    make_kitti_synth.BLOCK, block = 3, make_kitti_synth.BLOCK
    try:  # two blocks of a smaller size, on two worker processes
        make_kitti_synth.generate(str(tmp_path / "port2"), "03", workers=2, **kw)
    finally:
        make_kitti_synth.BLOCK = block
    want = _files(tmp_path / "jax")
    assert len(want) == 4 + 3 and "sequences/03/velodyne/000003.bin" in want
    assert _files(tmp_path / "port") == want
    assert _files(tmp_path / "port2") == want


def _engines():
    j = jrt.SlamEngine(**{k: JAX_CLS[k](**v) for k, v in LONGRUN.items()})
    t = trt.SlamEngine(**{k: PORT_CLS[k](**v) for k, v in LONGRUN.items()}, device="cpu")
    return j, t


def test_drive_kitti_matches_jax(kitti_root):
    j, t = _engines()
    jout = jax_drive_kitti(j, kitti_root, "00", scan_capacity=4096, chunk=3, progress=False)
    tout = drive_kitti(t, kitti_root, "00", scan_capacity=4096, chunk=3, progress=False)
    # the q16 reader applied the stride: both engines run with stride 1 now
    assert t.odom_cfg.point_filter_num == j.odom_cfg.point_filter_num == 1
    assert set(tout) == set(jout) >= {"scans_per_sec", "ate_m", "rpe_1s_m", "kf_ate_m",
                                      "n_loops", "n_keyframes", "n_solves", "n_scans"}
    for key in ("n_scans", "n_keyframes", "n_loops", "n_solves"):
        assert tout[key] == jout[key], key
    assert t.loop_pairs == j.loop_pairs
    assert tout["n_keyframes"] > 2
    tp = np.stack(t.realtime_traj)[:, :3, 3]
    jp = np.stack(j.realtime_traj)[:, :3, 3]
    assert tp.shape == (N_SCANS, 3)
    err = np.abs(tp - jp).max()
    assert err < 0.02, f"realtime positions differ by {err:.4f} m"
    np.testing.assert_allclose(t.keyframe_poses(), np.asarray(j.keyframe_poses()), atol=0.02)
    for key in ("ate_m", "kf_ate_m", "rpe_1s_m"):
        assert abs(tout[key] - jout[key]) < 0.02, key


def _plane_fixture(root):
    """The 9-scan plane box of tests/test_datasets.py: test_drive_kitti_q16_matches_f32."""
    seq_dir = root / "sequences" / "00"
    velo = seq_dir / "velodyne"
    velo.mkdir(parents=True)
    for i in range(9):
        r = np.random.default_rng(50 + i)
        world = np.concatenate([
            np.stack([r.uniform(-8, 8, 400), r.uniform(-8, 8, 400), np.full(400, -1.0)], 1),
            np.stack([np.full(300, 8.0), r.uniform(-8, 8, 300), r.uniform(-1, 3, 300)], 1),
            np.stack([r.uniform(-8, 8, 324), np.full(324, -8.0), r.uniform(-1, 3, 324)], 1),
        ]).astype(np.float32)
        body = world - np.asarray([0.2 * i, 0.0, 0.0], np.float32)
        np.concatenate([body, np.full((len(body), 1), 0.5, np.float32)], axis=1).tofile(
            velo / f"{i:06d}.bin")
    np.savetxt(seq_dir / "times.txt", np.arange(9) * 0.1)
    (seq_dir / "calib.txt").write_text("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")


def test_drive_kitti_q16_matches_f32(tmp_path):
    _plane_fixture(tmp_path)

    def build():
        return trt.SlamEngine(
            odom_cfg=todom.OdomConfig(point_filter_num=1, blind=0.5, filter_size_surf=0.3,
                                      num_ds_points=512, evict_every=10_000, det_range=60.0),
            map_cfg=tmap.VoxelMapConfig(capacity=1 << 13, voxel_size=0.4, min_points=4),
            loop_cfg=tloop.LoopConfig(radius=0.1, time_gap=1e9, num_submap_keyframes=1,
                                      submap_points=256, max_iterations=2, nn_chunk=64),
            pgo_cfg=tpgo.PoseGraphConfig(max_keyframes=16, max_between=32, max_gps=4,
                                         lm_iters=2, pcg_iters=8),
            cfg=trt.EngineConfig(keyframe_threshold=0.15, loop_check_every=100,
                                 kf_cloud_points=256),
            device="cpu",
        )

    e_q, e_f = build(), build()
    drive_kitti(e_q, str(tmp_path), "00", scan_capacity=1024, chunk=3, progress=False,
                upload="q16")
    drive_kitti(e_f, str(tmp_path), "00", scan_capacity=1024, chunk=3, progress=False,
                upload="f32")
    tq = np.stack(e_q.realtime_traj)[:, :3, 3]
    tf = np.stack(e_f.realtime_traj)[:, :3, 3]
    assert e_q.kf.n == e_f.kf.n and len(tq) == 9
    np.testing.assert_allclose(tq, tf, rtol=0, atol=0.03)


def test_drive_kitti_rejects_unknown_upload(kitti_root):
    _, t = _engines()
    with pytest.raises(ValueError, match="upload"):
        drive_kitti(t, kitti_root, "00", scan_capacity=4096, upload="f16", progress=False)


def test_run_slam_sim_and_localize_scripts(tmp_path, capsys):
    """The port's scripts through their main() on the CPU at tiny sizes:
    a sim run with export, then localization of the same feed against its
    keyframe bundle (as a generic-format recording)."""
    from fastliosam_tpu_torch.io.pcd import read_pcd
    from fastliosam_tpu_torch.io.poses import read_kitti_poses, read_tum_trajectory
    from fastliosam_tpu_torch.scripts import localize, run_slam

    out = tmp_path / "run"
    assert run_slam.main([
        "--dataset", "sim", "--n-scans", "12", "--chunk", "4", "--device", "cpu",
        "--num-ds-points", "512", "--map-capacity-log2", "14", "--max-keyframes", "16",
        "--point-filter-num", "2", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "ATE (aligned):" in text and "saved:" in text
    ate = float(text.split("ATE (aligned):")[1].split()[0])
    assert ate < 0.5
    kf = np.load(out / "sim_keyframes.npz")
    assert set(kf.files) == {"poses", "stamps", "clouds", "masks"}
    n_kf = len(kf["poses"])
    assert read_kitti_poses(str(out / "sim_kitti.txt")).shape == (n_kf, 4, 4)
    assert len(read_tum_trajectory(str(out / "sim_scans_tum.txt"))[0]) == 12
    assert len(read_pcd(str(out / "sim_map.pcd"))) > 100

    # the first sim scans as a generic recording: one PCD per scan
    from fastliosam_tpu_torch.io.pcd import write_pcd
    from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    data = simulate_sequence(PlaneWorld.room(size=50.0, height=8.0, n_boxes=20, seed=1),
                             Trajectory.circle(radius=8.0, period=40.0),
                             SimConfig(n_azimuth=1024, n_elev=16, time_groups=32, seed=1),
                             n_scans=3)
    rec = tmp_path / "rec" / "clouds"
    rec.mkdir(parents=True)
    imu_rows = []
    for k, (pts, _, hit) in enumerate(data["scans"]):
        write_pcd(str(rec / f"{data['stamps'][k]:.6f}.pcd"), pts[hit])
        ts, gy, ac = data["imu"][k]
        t_start = data["stamps"][k] - data["scan_dt"]
        imu_rows.append(np.column_stack([t_start + ts + 1e-6, gy, ac]))
    np.savetxt(tmp_path / "rec" / "imu.txt", np.concatenate(imu_rows))
    loc_out = tmp_path / "loc"
    assert localize.main([
        "--map", str(out / "sim_keyframes.npz"), "--dataset", "generic",
        "--root", str(tmp_path / "rec"), "--device", "cpu", "--num-ds-points", "512",
        "--map-capacity-log2", "14", "--scan-capacity", "16384", "--out", str(loc_out)]) == 0
    text = capsys.readouterr().out
    assert "global init fitness" in text
    stamps, poses = read_tum_trajectory(str(loc_out / "localized_tum.txt"))
    np.testing.assert_allclose(stamps, data["stamps"], atol=1e-6)
    # the recording replays the run's first scans with their IMU: the
    # localized poses land near the run's own realtime poses of them
    _, run_poses = read_tum_trajectory(str(out / "sim_scans_tum.txt"))
    err = np.linalg.norm(poses[:, :3, 3] - run_poses[:3, :3, 3], axis=1)
    assert err.max() < 0.3, err
