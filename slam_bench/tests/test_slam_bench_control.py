"""The control on the card: the reference's step from a lane's state
computed with TF32 matmuls (the precision below the configurations'
float32), on the cell's own feed and widths, fails the cell's limits,
where the float32 step taken twice agrees with itself exactly."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import check, feed, run
from slam_bench.reference import odometry as ro

from .conftest import BENCH

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_tf32_reference_fails_the_limits(workload, cuda, feed_cache):
    w, c = run.cell(BENCH, workload)
    config = run.load_json("configs", c["name"])
    spec = run.load_json("traffic", w["traffic"])["feed"]
    spec["n_scans"] = 40
    host = feed.load(spec)
    f = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in host.items() if k != "scan_dt"}
    f["scan_dt"] = float(host["scan_dt"])
    limits = run.load_json("limits", workload)
    p0 = f["p0"][3].cpu().numpy() + np.float32(0.005)

    # a lane's state after 30 scans, then one step from it in each precision
    cfg, map_cfg = check.reference_configs(config)
    st = ro.init_odom(map_cfg, cfg, cuda, f["R0"][3].clone(), torch.from_numpy(p0).to(cuda),
                      f["v0"][3].clone())
    for k in range(3, 33):
        imu = ro.ImuBatch(f["imu_t"][k], f["imu_g"][k], f["imu_a"][k], f["imu_m"][k])
        st, _ = ro.odom_step(st, f["xyz"][k], f["toff"][k], f["mask"][k], imu, f["scan_dt"],
                             cfg, map_cfg)
    state = [*st.nav, *st.vmap, torch.tensor(st.scan_idx), torch.tensor(st.initialized),
             st.w_cv]
    one = check.step_from(f, 33, state, config)
    assert set(check.compare_step(check.step_from(f, 33, state, config), one).values()) == {0.0}
    control = check.compare_step(check.step_from(f, 33, state, config, tf32=True), one)
    assert any(control.get(k, 0.0) > limit for k, limit in limits.items()), (control, limits)
