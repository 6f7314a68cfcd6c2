"""Small cells for the benchmark's CPU tests: the configuration and traffic
files cut to a few lanes of short scans, and the feed cached under the
test's own temporary directory."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from slam_bench import feed, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def small_cell(workload: str) -> tuple[dict, dict]:
    """``(config, traffic)`` of ``workload`` at 4 lanes of 5-scan clips over a
    12-scan recording of 256 x 8 rays, 1024 iEKF points and a 2^14-slot map:
    the traffic's first recording, on which the small cell's own limits were
    read (``test_slam_bench_harness.py``)."""
    w, c = run.cell(BENCH, workload)
    config = run.load_json("configs", c["name"])
    traffic = run.load_json("traffic", w["traffic"])
    config["map"]["capacity"] = 1 << 14
    config["odom"]["num_ds_points"] = 1024
    config["raw_points"] = 256 * 8
    traffic.update(lanes=4, clip_scans=5, start_scan_max=6, warmup_steps=5, trace_steps=4)
    traffic["recordings"] = traffic["recordings"][:1]
    traffic["feed"]["n_scans"] = 12
    traffic["feed"]["sensor"].update(n_azimuth=256, n_elev=8)
    return config, traffic


@pytest.fixture
def feed_cache(tmp_path, monkeypatch) -> Path:
    monkeypatch.setattr(feed, "CACHE_DIR", tmp_path / "feeds")
    return tmp_path / "feeds"


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
