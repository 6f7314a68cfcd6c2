"""The frozen copies against what they were copied from, on the CPU: the
feed equals the program's figure-8 feed, and the reference's step equals
the program's unbatched ``odom_step`` bit for bit in both association
modes (the batched step differs from both in rounding only)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import check, feed, run

from .conftest import small_cell


def test_feed_equals_the_programs_figure8_feed():
    from fastliosam_tpu_torch.eval.feeds import build_fig8_sequence
    from fastliosam_tpu_torch.sim import Trajectory

    spec = run.load_json("traffic", "fleet99")["feed"]
    spec["n_scans"] = 2
    ours = feed.build(spec)
    theirs = build_fig8_sequence(2)
    for k in ("xyz", "toff", "mask", "imu_t", "imu_g", "imu_a", "imu_m"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    traj = Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)
    for k in range(2):
        R, p = traj.pose(k * 0.1)
        np.testing.assert_array_equal(ours["R0"][k], R.astype(np.float32))
        np.testing.assert_array_equal(ours["p0"][k], p.astype(np.float32))
        np.testing.assert_array_equal(ours["v0"][k], traj.velocity(k * 0.1).astype(np.float32))


@pytest.mark.parametrize("workload", ["lio.hdl64.fleet99", "lio.hdl64-cached.fleet99"])
def test_reference_step_equals_the_programs_unbatched_step(workload, feed_cache):
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import ImuBatch, OdomConfig, Scan, init_odom, odom_step

    config, traffic = small_cell(workload)
    host = feed.load(traffic["feed"])
    f = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items() if k != "scan_dt"}
    f["scan_dt"] = float(host["scan_dt"])
    start, steps = 2, 8
    p0 = f["p0"][start].numpy() + np.float32(0.004)
    ref = check.replay(f, start, steps, p0, config)

    cfg = OdomConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config["odom"].items()})
    map_cfg = VoxelMapConfig(**config["map"])
    st = init_odom(map_cfg, cfg, device="cpu")
    st = st._replace(nav=st.nav._replace(R=f["R0"][start].clone(), p=torch.from_numpy(p0),
                                         v=f["v0"][start].clone()))
    Rs, ps = [], []
    for k in range(start, start + steps):
        st, aux = odom_step(st, Scan(f["xyz"][k], f["toff"][k], f["mask"][k]),
                            ImuBatch(f["imu_t"][k], f["imu_g"][k], f["imu_a"][k], f["imu_m"][k]),
                            f["scan_dt"], cfg, map_cfg, device="cpu")
        Rs.append(aux["R"].numpy())
        ps.append(aux["p"].numpy())
    np.testing.assert_array_equal(np.stack(ps), ref["p"])
    np.testing.assert_array_equal(np.stack(Rs), ref["R"])
    occ = (st.vmap.fp != 0).numpy()
    assert check.count_gap(st.vmap.coords.numpy()[occ], st.vmap.moments.numpy()[occ, 0],
                           ref["coords"], ref["counts"]) == 0.0
    assert len(ref["counts"]) > 100


def test_count_gap_and_rot_gap_by_hand():
    a = np.array([[0, 0, 0], [1, 0, 0]])
    b = np.array([[1, 0, 0], [0, 2, 0]])
    # union {000: 3|0, 100: 2|4, 020: 0|1}: |3| + |2 - 4| + |1| over 5
    assert check.count_gap(a, np.array([3.0, 2.0]), b, np.array([4.0, 1.0])) == 6 / 5
    th = 1e-4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    assert check.rot_gap(R[None], np.eye(3)[None])[0] == pytest.approx(th, rel=1e-6)
