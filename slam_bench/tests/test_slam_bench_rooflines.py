"""The roofline counts at small shapes, each checked by hand."""
from __future__ import annotations

import pytest

from slam_bench import rooflines
from slam_bench.rooflines import cached_rows, insert_claim, merged_moments, refresh_planes

# 2 lanes of 4 points, 6 of the 8 valid, 5 matched, 1 left unassigned, 3 pools
S = {"B": 2, "n": 4, "V": 6, "M": 5, "dropped": 1, "P": 3}


def test_merged_moments_counts():
    # 8 masks + 8 outputs of 13 floats; 6 valid: a 12-byte voxel, 3 fingerprints;
    # 5 matched: at least one voxel's moment row and coordinates, 13 sums
    assert merged_moments.need(S) == (8 * 1 + 8 * 52 + 6 * (12 + 3 * 4) + 5 * (40 + 12),
                                      5 * 13)


def test_insert_claim_counts():
    # 8 masks; 6 valid: xyz, fingerprint, old count, slot, update row; 2 lane counts
    assert insert_claim.need(S) == (8 + 6 * (12 + 4 + 4 + 4 + 40) + 2 * 4, 6 * 12)


def test_cached_rows_counts():
    rows = 12 + 4 + 1 + 24 + 24 + 4 + 12 + 4  # n, r, valid, A, Aw, wc, nwc, slot
    assert rows == 85
    # 5 matched: each its plane's normal, offset and flag
    assert cached_rows.need(S) == (8 * (1 + rows) + 6 * (12 + 4) + 5 * 17 + 2 * (8 + 48),
                                   6 * 45)


def test_refresh_planes_counts():
    # 8 slots read; 5 points assigned touch at least one voxel: 72 bytes, 100 ops
    assert rooflines.distinct_voxels_at_least(5) == 1
    assert rooflines.distinct_voxels_at_least(17) == 3
    assert refresh_planes.need(S) == (8 * 4 + 1 * 72, 100)


def test_share_times_only_the_named_kernels():
    trace = {"lanes": 2, "valid_points": 6, "matched_points": 5, "dropped_points": 1,
             "config": {"odom": {"num_ds_points": 4, "query_mode": "merged3"}},
             "device_ops": {"void merged_moments_kernel<3>(int)": [2, 1000],
                            "insert_claim_kernel": [1, 500]}}
    nbytes, _ = merged_moments.need(S)
    want = 100 * 2 * nbytes / rooflines.PEAK_BYTES_PER_S / 1e-6
    assert rooflines.share(trace, "merged_moments") == pytest.approx(want)
    assert rooflines.share(trace, "cached_rows") is None
