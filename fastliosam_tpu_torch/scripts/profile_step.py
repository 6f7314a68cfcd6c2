"""Per-component timing of the odometry step (port of
``scripts/profile_step.py``).

    python -m fastliosam_tpu_torch.scripts.profile_step [component ...] [--points 32768]
        [--ds-points 8192] [--map-log2 19] [--reps 20] [--seed 0] [--device cpu] [--out FILE]

The JAX script's 8 components at its shapes, on N = 32,768 points drawn
uniformly in a 120 m cube (seed 0), 8192 of them the downsampled points, a
2^19-slot map holding the N points: ``step`` (``odom_step`` from a fresh
state, gated on the device as the engine runs it), ``insert`` (the N
points, planes refreshed), ``query_merged`` (the 7-voxel stencil, the
default query mode), ``query_cached``, ``ds`` (``voxel_downsample``),
``compact``, ``propagate`` (32 IMU samples) and ``iekf`` (3 iterations).
As in the JAX script each component is called ``--reps`` times on the
same inputs, with no data dependence between the calls. Reported as
``profile_step2.py`` reports, one JSON line a component.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import torch

from .profile_step2 import Stage, imu_batch, parse_args, repeated, run_script

STAGES = ("step", "insert", "query_merged", "query_cached", "ds", "compact", "propagate",
          "iekf")


def make_inputs(n: int = 32768, nds: int = 8192, map_log2: int = 19, seed: int = 0,
                device=None) -> SimpleNamespace:
    """The JAX script's inputs: ``pts`` (numpy, uniform in [-60, 60)^3),
    on ``device`` the map holding them and a fresh odometry state."""
    from ..map import VoxelMapConfig, insert, make_map
    from ..odom import OdomConfig, Scan, init_odom
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    map_cfg = VoxelMapConfig(capacity=1 << map_log2, voxel_size=0.5, min_points=5)
    odom_cfg = OdomConfig(point_filter_num=1, num_ds_points=nds, evict_every=10_000)
    pts_np = rng.uniform(-60, 60, size=(n, 3)).astype(np.float32)
    pts = torch.from_numpy(pts_np).to(dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    m, _ = insert(make_map(map_cfg, dev), map_cfg, pts, mask)
    return SimpleNamespace(
        dev=dev, map_cfg=map_cfg, odom_cfg=odom_cfg, pts_np=pts_np, pts=pts, mask=mask,
        pts_ds=pts[:nds], mask_ds=mask[:nds], vmap=m, state=init_odom(map_cfg, device=dev),
        imu=imu_batch(dev), scan=Scan(xyz=pts, t_offset=torch.zeros((n,), device=dev),
                                      mask=mask))


def stages(inp: SimpleNamespace) -> list:
    """The JAX script's components over ``inp``: each a call repeated."""
    from ..core.pointcloud import Cloud, compact, voxel_downsample
    from ..map import insert, query_planes, query_planes_merged
    from ..odom import iekf_update, odom_step, propagate

    mc, oc, dev, m = inp.map_cfg, inp.odom_cfg, inp.dev, inp.vmap
    n, nds = inp.pts.shape[0], inp.pts_ds.shape[0]

    return [
        Stage("step", "full odom_step", repeated(lambda: odom_step(
            inp.state, inp.scan, inp.imu, 0.1, oc, mc, device=dev, gate_on_device=True)), None),
        Stage("insert", f"map insert {n}", repeated(lambda: insert(m, mc, inp.pts, inp.mask)),
              None),
        Stage("query_merged", f"query merged {nds}", repeated(lambda: query_planes_merged(
            m, mc, inp.pts_ds, inp.mask_ds)), None),
        Stage("query_cached", f"query cached {nds}", repeated(lambda: query_planes(
            m, mc, inp.pts_ds, inp.mask_ds)), None),
        Stage("ds", f"voxel_downsample {n}", repeated(lambda: voxel_downsample(
            Cloud(inp.pts, inp.mask), 0.5)), None),
        Stage("compact", f"compact {n}", repeated(lambda: compact(Cloud(inp.pts, inp.mask))), None),
        Stage("propagate", "imu propagate", repeated(lambda: propagate(
            inp.state.nav, inp.imu, oc, 0.1)), None),
        Stage("iekf", "iekf_update (3 it)", repeated(lambda: iekf_update(
            inp.state.nav, inp.pts_ds, inp.mask_ds, m, mc, oc, gate_on_device=True)), None),
    ]


def main(argv=None) -> int:
    args = parse_args(argv, __doc__.split("\n")[0], STAGES, 32768, 8192, 20)
    run_script("profile_step", args, lambda a, dev: stages(
        make_inputs(a.points, a.ds_points, a.map_log2, a.seed, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
