"""Loop-candidate search: vectorized radius + time-gap gating (port of
``fastliosam_tpu/loop/detect.py``)."""
from __future__ import annotations

import torch


def fetch_closest_keyframe_idx(
    positions,  # (K, 3) keyframe translations (corrected)
    stamps,  # (K,) keyframe timestamps (s)
    kf_valid,  # (K,) bool
    query_idx,  # int, or a device integer scalar (read without a sync)
    radius: float,
    time_gap: float,
):
    """Nearest keyframe within ``radius`` whose stamp differs from the
    query's by more than ``time_gap``. Returns ``(idx, found)`` as device
    scalars; idx == -1 when no candidate qualifies."""
    if isinstance(query_idx, torch.Tensor):
        # a 1-element index: indexing with a 0-dim tensor would read it back
        q = query_idx.to(torch.int64).reshape(1)
        qpos, qstamp = positions[q][0], stamps[q][0]
    else:
        qpos, qstamp = positions[query_idx], stamps[query_idx]
    d = torch.linalg.vector_norm(positions - qpos, dim=-1)
    ok = kf_valid & (d < radius) & (torch.abs(qstamp - stamps) > time_gap)
    d_masked = torch.where(ok, d, torch.inf)
    idx = torch.argmin(d_masked)
    found = torch.isfinite(d_masked.gather(0, idx.reshape(1)))[0]  # no sync
    return torch.where(found, idx.to(torch.int32), -1), found
