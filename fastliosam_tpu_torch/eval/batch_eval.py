"""Batched (data-parallel) odometry evaluation (port of
``fastliosam_tpu/eval/batch_eval.py``).

The DP axis of SURVEY.md §2.3: B sequences evaluated at once, each lane
with its own filter state and voxel map, for parameter sweeps and
regression fleets on one card. The JAX package ``vmap``s its whole
``odom_rollout`` over the lanes; here the lane is a batch dimension
written out (``odom/pipeline.py: odom_step_batched``): every tensor
operation and every kernel launch of a step covers all B lanes, the map
kernels (association, insert, and in the cached mode the cached query and
the plane refresh's gather) take the lane axis, and each ``lax.cond``
with a per-lane predicate is a per-lane select, as ``vmap`` makes it.

Lane isolation is exact: a lane's result never depends on what the other
lanes carry. Against the unbatched rollout a lane agrees to float32
rounding of the batched products (see ``tests/test_torch_batch_eval.py``).
"""
from __future__ import annotations

import torch

from ..map.voxel_hash import VoxelMap, VoxelMapConfig
from ..odom.imu import ImuBatch
from ..odom.pipeline import OdomState, Scan, odom_rollout_batched
from ..odom.state import NavState, OdomConfig


def batched_rollout(
    states: OdomState,  # batched: leaves have leading dim B
    scans: Scan,  # (B, S, N, ...) stacked
    imus: ImuBatch,  # (B, S, M, ...)
    scan_dt,
    cfg: OdomConfig,
    map_cfg: VoxelMapConfig,
    device=None,
):
    """Run B sequences of S scans each, every step one pass over all lanes.

    Returns ``(states, aux)`` with every output carrying a leading batch
    dim; ``aux`` holds ``R (B, S, 3, 3)``, ``p (B, S, 3)`` and ``n_matched
    (B, S)``. Memory scales with B voxel maps: size ``map_cfg.capacity``
    accordingly.
    """
    return odom_rollout_batched(states, scans, imus, scan_dt, cfg, map_cfg, device=device)


def stack_states(states: list) -> OdomState:
    """Stack a list of per-sequence OdomStates into one batched state.

    Every tensor leaf (the nav state's nine fields, the map's six, ``w_cv``)
    is stacked along a new leading lane dim. ``scan_idx`` and
    ``initialized``, host values in an unbatched state of the port (0-dim
    leaves in the JAX package's), become ``(B,)`` int32 and bool tensors
    on the states' device, as ``jax.tree.map(jnp.stack)`` makes them.
    """
    dev = states[0].w_cv.device

    def host(values, dtype):
        return torch.stack([torch.as_tensor(v, dtype=dtype).to(dev).reshape(())
                            for v in values])

    return OdomState(
        nav=NavState(*(torch.stack(ts) for ts in zip(*(s.nav for s in states)))),
        vmap=VoxelMap(*(torch.stack(ts) for ts in zip(*(s.vmap for s in states)))),
        scan_idx=host([s.scan_idx for s in states], torch.int32),
        initialized=host([s.initialized for s in states], torch.bool),
        w_cv=torch.stack([s.w_cv for s in states]),
    )
