"""The bench's 1160-scan KITTI long run (``bench.py: bench_kitti_longrun``)
through ``drive_kitti`` on the CPU: the JAX package against the port at
reduced width, and the JAX package alone at full width (the accuracy
reference printed beside the port's run on the card; the port at full
width on a CPU runs at ~0.43x JAX's rate, ~1.8 h); and the figure-8 runs
of ``chip_smoke.py``'s modes phase at half width, both packages. Each
takes minutes to tens of minutes, so they are marked ``slow``:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_longrun.py -m slow -s

Both print their results. Tolerances and why: the feed's loop trust is
chaotic (``DESIGN.md`` §2h–2l: self-similar canyon, ICP slides accepted
at low fitness), so the two packages are held to the same keyframe count
within 1% and realtime ATE within 25% of each other, not to equal loops.
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(4)

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

pytestmark = pytest.mark.slow


def _cfgs(ds_points, submap_points):
    """bench.py: _make_longrun_engine, with the iEKF and submap budgets
    given."""
    return dict(
        odom_cfg=dict(point_filter_num=1, blind=1.0, filter_size_surf=0.5,
                      num_ds_points=ds_points, det_range=60.0, evict_every=50,
                      query_mode="merged3"),
        map_cfg=dict(capacity=1 << 19, voxel_size=0.5, min_points=5, query_probes=2,
                     insert_probes=2, claim_probes=2),
        loop_cfg=dict(radius=10.0, time_gap=4.0, num_submap_keyframes=5, voxel_res=0.3,
                      submap_points=submap_points, icp_score_threshold=0.5, max_sqrt_info=1.0),
        pgo_cfg=dict(max_keyframes=1024, max_between=2048, max_gps=64, lm_iters=8,
                     loop_gnc_barc=2.0, gnc_hop_trans_var=0.1),
        cfg=dict(keyframe_threshold=1.0, loop_check_every=5, kf_cloud_points=4096,
                 kf_cloud_voxel=0.3),
    )


def _drive(pkg, root, n_azimuth, ds_points, submap_points):
    cls = (dict(odom_cfg=jodom.OdomConfig, map_cfg=jmap.VoxelMapConfig,
                loop_cfg=jloop.LoopConfig, pgo_cfg=jpgo.PoseGraphConfig, cfg=jrt.EngineConfig)
           if pkg == "jax" else
           dict(odom_cfg=todom.OdomConfig, map_cfg=tmap.VoxelMapConfig,
                loop_cfg=tloop.LoopConfig, pgo_cfg=tpgo.PoseGraphConfig, cfg=trt.EngineConfig))
    kw = {k: cls[k](**v) for k, v in _cfgs(ds_points, submap_points).items()}
    if pkg == "jax":
        engine, drive = jrt.SlamEngine(**kw), jax_drive_kitti
    else:
        engine, drive = trt.SlamEngine(**kw, device="cpu"), drive_kitti
    out = drive(engine, root, "00", scan_capacity=n_azimuth * 16, chunk=5, progress=False)
    out["loop_pairs"] = [list(map(int, p)) for p in engine.loop_pairs]
    print(pkg, n_azimuth, "x 16:", json.dumps(out), flush=True)
    return out


def _feed(tmp_path_factory, n_azimuth):
    root = str(tmp_path_factory.mktemp(f"kitti_{n_azimuth}"))
    make_kitti_synth.generate(root, "00", n_scans=1160, n_azimuth=n_azimuth, progress=False,
                              workers=5)
    return root


def test_longrun_reduced_width_jax_vs_port(tmp_path_factory):
    """512 x 16 rays, 2048 iEKF points, 4096-point loop submaps."""
    root = _feed(tmp_path_factory, 512)
    j = _drive("jax", root, 512, 2048, 4096)
    t = _drive("port", root, 512, 2048, 4096)
    assert abs(t["n_keyframes"] - j["n_keyframes"]) <= 0.01 * j["n_keyframes"]
    assert abs(t["ate_m"] - j["ate_m"]) <= 0.25 * j["ate_m"]


def test_longrun_full_width_jax_reference(tmp_path_factory):
    """The bench's own widths (2048 x 16 rays, 8192 iEKF points, 16,384-point
    submaps), the JAX package on the CPU, held to the same package's run on
    a TPU (``BENCH_r05.json``: 574 keyframes): the keyframe count within
    1% and a finite ATE. The ATE is printed, not gated: which loops are
    accepted differs between platforms on this feed."""
    out = _drive("jax", _feed(tmp_path_factory, 2048), 2048, 8192, 16384)
    assert np.isfinite(out["ate_m"])
    assert abs(out["n_keyframes"] - 574) <= 0.01 * 574


# chip_smoke.py's modes phase: the bench's figure-8 pipeline (bench.py:
# make_engine_for) with the other query and loop-ICP modes, each on its path
MODES = {
    "cached_p2pl": (dict(query_mode="cached"), dict(icp_method="p2pl"), False),
    "merged2_multistart": (dict(query_mode="merged2"),
                           dict(icp_multistart=5, multistart_step=4.0, multistart_iters=12),
                           True),
}


def _figure8_half_width(n_scans=150):
    """``chip_smoke.py: figure8_feed`` at 1024 x 16 rays (half the bench's
    width)."""
    from fastliosam_tpu.sim import PlaneWorld, SimConfig, Trajectory, simulate_sequence

    world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=11)
    traj = Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
    cfg = SimConfig(scan_rate=10.0, n_azimuth=1024, n_elev=16, max_range=120.0,
                    gyro_noise=0.001, acc_noise=0.01, seed=11, time_groups=32)
    return simulate_sequence(world, traj, cfg, n_scans=n_scans), traj


def _figure8_run(pkg, data, traj, odom_kw, loop_kw, chunked):
    """The figure-8 feed through one package's engine: 4096 iEKF points,
    2^16 slots and 4096-point loop submaps (the half-width cut)."""
    import jax.numpy as jnp

    kw = dict(
        odom_cfg=dict(point_filter_num=1, blind=1.0, filter_size_surf=0.5, num_ds_points=4096,
                      det_range=150.0, evict_every=10_000, **odom_kw),
        map_cfg=dict(capacity=1 << 16, voxel_size=0.5, min_points=5, query_probes=2,
                     insert_probes=2, claim_probes=2),
        loop_cfg=dict(radius=10.0, time_gap=4.0, num_submap_keyframes=5, voxel_res=0.3,
                      submap_points=4096, **loop_kw),
        pgo_cfg=dict(max_keyframes=128, max_between=256, max_gps=64),
        cfg=dict(keyframe_threshold=1.0, loop_check_every=5, kf_cloud_points=4096,
                 kf_cloud_voxel=0.3),
    )
    cls = (dict(odom_cfg=jodom.OdomConfig, map_cfg=jmap.VoxelMapConfig,
                loop_cfg=jloop.LoopConfig, pgo_cfg=jpgo.PoseGraphConfig, cfg=jrt.EngineConfig)
           if pkg == "jax" else
           dict(odom_cfg=todom.OdomConfig, map_cfg=tmap.VoxelMapConfig,
                loop_cfg=tloop.LoopConfig, pgo_cfg=tpgo.PoseGraphConfig, cfg=trt.EngineConfig))
    cfgs = {k: cls[k](**v) for k, v in kw.items()}
    if pkg == "jax":
        e, arr, mod = jrt.SlamEngine(**cfgs), jnp.asarray, jodom
    else:
        e, arr, mod = trt.SlamEngine(**cfgs, device="cpu"), torch.from_numpy, todom
    R0, p0 = traj.pose(0.0)
    e.odom = e.odom._replace(nav=e.odom.nav._replace(
        R=arr(np.float32(R0)), p=arr(np.float32(p0)), v=arr(np.float32(traj.velocity(0.0)))))
    cap = max(len(b[0]) for b in data["imu"])

    def imu(k):
        ts, gy, ac = data["imu"][k]
        m = len(ts)
        return (np.pad(ts, (0, cap - m), constant_values=1e9).astype(np.float32),
                np.pad(gy, ((0, cap - m), (0, 0))).astype(np.float32),
                np.pad(ac, ((0, cap - m), (0, 0))).astype(np.float32), np.arange(cap) < m)

    n = len(data["scans"])
    chunk = 5 if chunked else 1
    for c in range(0, n - n % chunk, chunk):
        ks = range(c, c + chunk)
        scans = [np.stack([data["scans"][k][i] for k in ks]) for i in range(3)]
        imus = [np.stack([imu(k)[i] for k in ks]) for i in range(4)]
        if chunked:
            e.process_chunk_deferred(mod.Scan(*map(arr, scans)), mod.ImuBatch(*map(arr, imus)),
                                     [data["stamps"][k] for k in ks], data["scan_dt"])
        else:
            e.process(mod.Scan(*(arr(a[0]) for a in scans)),
                      mod.ImuBatch(*(arr(a[0]) for a in imus)), data["stamps"][c],
                      data["scan_dt"])
    e.finish()
    rt = np.stack([np.asarray(p) for p in e.realtime_traj])[:, :3, 3]
    gt = np.stack([g[1] for g in data["gt"]])[: len(rt)]
    out = {"ate_m": float(np.sqrt(np.mean(np.sum((rt - gt) ** 2, axis=1)))),
           "keyframes": int(e.kf.n), "verifications": len(e.loop_attempts),
           "loop_pairs": [list(map(int, p)) for p in e.loop_pairs]}
    print(pkg, "figure-8 at 1024 x 16:", json.dumps(out), flush=True)
    return out


@pytest.mark.parametrize("name", sorted(MODES))
def test_figure8_modes_half_width_jax_vs_port(name):
    """The accuracy reference of ``chip_smoke.py``'s modes phase, taken on
    the CPU at half the bench's width (its full width is a run for the
    card): the JAX package and the port, each printed; held to the same
    keyframe count within 1% and ATE within 25% of each other."""
    odom_kw, loop_kw, chunked = MODES[name]
    data, traj = _figure8_half_width()
    j = _figure8_run("jax", data, traj, odom_kw, loop_kw, chunked)
    t = _figure8_run("port", data, traj, odom_kw, loop_kw, chunked)
    assert abs(t["keyframes"] - j["keyframes"]) <= 0.01 * j["keyframes"]
    assert abs(t["ate_m"] - j["ate_m"]) <= 0.25 * j["ate_m"]
