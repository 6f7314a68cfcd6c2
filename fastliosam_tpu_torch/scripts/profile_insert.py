"""The odometry step's sub-stages at step shapes (port of
``scripts/profile_insert.py``): the map insert's parts and the isolated
scatters, gathers and sorts beside them.

    python -m fastliosam_tpu_torch.scripts.profile_insert [stage ...] [--points 32768]
        [--ds-points 8192] [--map-log2 19] [--reps 30] [--seed 0] [--device cpu] [--out FILE]

On N = 32,768 points drawn uniformly in a 120 m cube (seed 0), the first
8192 of them the step's points, and a 2^19-slot map holding the N points
(no plane refresh), as in the JAX script. The port's counterpart of each of
its isolated operations:

- ``insert``: ``insert`` of the 8192 points, no plane refresh;
- ``query``: one merged3 association;
- ``find_slots``: the JAX probe alone (4 probes); the port fuses the probe
  into the association kernel, so this is ``merged_moments`` on the own
  voxel's pool, probe and moment read together (``"fused_into"``);
- ``hash_fp``: ``core/voxel.py: hash_slot`` and ``fingerprint``;
- ``scatter_add`` (8192, 10) float: the port's fixed-order sum
  (``core/segment.py``: plan and segment sums; no float atomics);
- ``scatter_max`` (8192,) int32: ``scatter_reduce_(..., "amax")``;
- ``gather`` (8192, 10) and ``gather_int`` (8192,) int32: ``gather_rows``;
- ``ds``: ``voxel_downsample`` of the N points; ``sort``: ``torch.sort`` of
  N int32 keys; ``propagate`` (32 IMU samples); ``deskew`` of the N points.

Each is called ``--reps`` times on the same inputs, as in the JAX script,
and reported as ``profile_step2.py`` reports, one JSON line a stage.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import torch

from .profile_step2 import Stage, imu_batch, parse_args, repeated, run_script

STAGES = ("insert", "query", "find_slots", "hash_fp", "scatter_add", "scatter_max", "gather",
          "gather_int", "ds", "sort", "propagate", "deskew")


def make_inputs(n: int = 32768, nds: int = 8192, map_log2: int = 19, seed: int = 0,
                device=None) -> SimpleNamespace:
    """The JAX script's inputs in its order of draws: the points, the map
    holding them, the random slots ``idx_np``, the sort keys ``keys_np``,
    and the propagated state of a body at rest for the deskew."""
    from ..map import VoxelMapConfig, insert, make_map
    from ..odom import OdomConfig, init_state, propagate
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    map_cfg = VoxelMapConfig(capacity=1 << map_log2, voxel_size=0.5, min_points=5)
    odom_cfg = OdomConfig(point_filter_num=1, num_ds_points=nds)
    pts_np = rng.uniform(-60, 60, size=(n, 3)).astype(np.float32)
    pts32 = torch.from_numpy(pts_np).to(dev)
    mask32 = torch.ones((n,), dtype=torch.bool, device=dev)
    m, _ = insert(make_map(map_cfg, dev), map_cfg, pts32, mask32, refresh_planes=False)
    idx_np = rng.integers(0, map_cfg.capacity, size=(nds,), dtype=np.int32)
    keys_np = rng.integers(0, 1 << 31, size=(n,), dtype=np.int32)
    state = init_state(None, odom_cfg, device=dev)
    imu = imu_batch(dev)
    nav_prop, traj = propagate(state, imu, odom_cfg, 0.1)
    return SimpleNamespace(
        dev=dev, map_cfg=map_cfg, odom_cfg=odom_cfg, pts_np=pts_np, idx_np=idx_np,
        keys_np=keys_np, pts32=pts32, mask32=mask32, pts=pts32[:nds], mask=mask32[:nds],
        vmap=m, idx=torch.from_numpy(idx_np).to(dev), keys=torch.from_numpy(keys_np).to(dev),
        upd=torch.ones((nds, 10), device=dev), state=state, imu=imu, nav_prop=nav_prop,
        traj=traj, toff=torch.from_numpy(
            np.linspace(0, 0.1, n, endpoint=False, dtype=np.float32)).to(dev))


def stages(inp: SimpleNamespace) -> list:
    """The JAX script's sub-stages over ``inp``: each a call repeated."""
    from ..core import segment
    from ..core.pointcloud import Cloud, voxel_downsample
    from ..core.voxel import fingerprint, hash_slot, voxel_coords
    from ..map import insert, query_planes_merged3
    from ..odom import deskew, propagate
    from ..ops.assoc_cuda import merged_moments
    from ..ops.gather_cuda import gather_rows

    mc, oc, dev, m = inp.map_cfg, inp.odom_cfg, inp.dev, inp.vmap
    n, nds = inp.pts32.shape[0], inp.pts.shape[0]
    idx64 = inp.idx.to(torch.int64)
    arange = torch.arange(nds, dtype=torch.int32, device=dev)

    def find_slots():
        coords = voxel_coords(inp.pts, mc.voxel_size)
        return merged_moments(m.fp, m.moments, coords[None], coords, inp.mask, mc.voxel_size,
                              mc.query_probes)

    def hash_fp():
        coords = voxel_coords(inp.pts, 0.5)
        return hash_slot(coords, mc.capacity), fingerprint(coords)

    return [
        Stage("insert", f"insert {nds} (no refresh)", repeated(lambda: insert(
            m, mc, inp.pts, inp.mask, refresh_planes=False)), None),
        Stage("query", f"query merged3 {nds}", repeated(lambda: query_planes_merged3(
            m, mc, inp.pts, inp.mask)), None),
        Stage("find_slots", f"merged_moments {nds} x 1 pool ({mc.query_probes} probes; "
              "probe fused with the moment read)", repeated(find_slots), None,
              fused_into="merged_moments"),
        Stage("hash_fp", f"hash+fp only {nds}", repeated(hash_fp), None),
        Stage("scatter_add", f"scatter-add ({nds},10), fixed order (core/segment.py)",
              repeated(lambda: segment.index_add_(m.moments.clone(), segment.segment_plan(inp.idx),
                                              inp.upd)), None),
        Stage("scatter_max", f"scatter-max ({nds},) int", repeated(lambda: torch.zeros(
            (mc.capacity,), dtype=torch.int32, device=dev).scatter_reduce_(
                0, idx64, arange, "amax")), None),
        Stage("gather", f"gather ({nds},10)", repeated(lambda: gather_rows(
            m.moments, inp.idx).sum()), None),
        Stage("gather_int", f"gather ({nds},) int", repeated(lambda: gather_rows(
            m.fp, inp.idx).sum()), None),
        Stage("ds", f"voxel_downsample {n}", repeated(lambda: voxel_downsample(
            Cloud(inp.pts32, inp.mask32), 0.5)), None),
        Stage("sort", f"sort {n} int32", repeated(lambda: torch.sort(inp.keys)), None),
        Stage("propagate", "propagate (32 imu)", repeated(lambda: propagate(
            inp.state, inp.imu, oc, 0.1)), None),
        Stage("deskew", f"deskew {n}", repeated(lambda: deskew(
            inp.pts32, inp.toff, inp.mask32, inp.traj, inp.nav_prop, oc, inp.imu.mask, 0.1)),
            None),
    ]


def main(argv=None) -> int:
    args = parse_args(argv, __doc__.split("\n")[0], STAGES, 32768, 8192, 30)
    run_script("profile_insert", args, lambda a, dev: stages(
        make_inputs(a.points, a.ds_points, a.map_log2, a.seed, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
