"""The pose-graph builder of the scaling harness (port of
``scripts/bench_scaling.py: build_graph``): a noisy ring of ``K`` keyframes,
its odometry chain and one loop factor closing it, the input of the
dense-against-PCG crossover (``bench_pgo_crossover.py``).

The harness's sharded solve and scan-match timings are not ported yet.
"""
from __future__ import annotations

import numpy as np


def build_graph(cfg, K, seed=0, device=None):
    """A ``PoseGraph`` of ``K`` poses on a circle of 0.5 m steps with 2 cm
    of translation noise a step (numpy's draws from ``seed``, as the JAX
    harness draws them), ``K - 1`` odometry factors and the loop ``K - 1 ->
    0``. ``device`` as :func:`pgo.from_arrays` (``None`` means ``cuda``)."""
    from ..pgo import from_arrays

    rng = np.random.default_rng(seed)
    a = 2 * np.pi / K
    ca, sa = np.cos(a), np.sin(a)
    step_T = np.eye(4, dtype=np.float32)
    step_T[:2, :2] = [[ca, -sa], [sa, ca]]
    step_T[0, 3] = 0.5
    poses = [np.eye(4, dtype=np.float32)]
    rels = []
    for _ in range(1, K):
        noise = np.eye(4, dtype=np.float32)
        noise[:3, 3] = rng.normal(size=3) * 0.02
        rel = step_T @ noise
        poses.append(poses[-1] @ rel)
        rels.append(rel)
    bt_i = np.arange(K - 1)
    bt_j = np.arange(1, K)
    si = np.tile(np.asarray([10.0] * 3 + [100.0] * 3, np.float32), (K - 1, 1))
    bt_i = np.append(bt_i, K - 1)
    bt_j = np.append(bt_j, 0)
    rels.append(np.linalg.inv(poses[-1]).astype(np.float32))
    si = np.vstack([si, np.asarray([[100.0] * 3 + [1000.0] * 3], np.float32)])
    return from_arrays(
        cfg, np.stack(poses), bt_i=bt_i, bt_j=bt_j, bt_rel=np.stack(rels),
        bt_sqrt_info=si, device=device,
    )
