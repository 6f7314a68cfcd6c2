"""The harness on the CPU at a small size: it finds its files by name, its
clip schedule staggers the resets, a sound run is correct, and a run whose
timed step is broken underneath is not."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from slam_bench import feed, run

from .conftest import BENCH, small_cell

WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_new_traffic_and_metric_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "slam_bench"
    shutil.copytree(run.BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "dummy.json").write_text(json.dumps({"lanes": 2}))
    (root / "metrics" / "dummy_metric.py").write_text(
        "def read(trace):\n    return trace['steps'] * 2.0\n")
    assert run.load_json("traffic", "dummy", root) == {"lanes": 2}
    workload = WORKLOADS[0]
    bench = dict(BENCH, per_layer=[{"name": "dummy_metric", "unit": "x", "better": "lower",
                                    "source": "program_counter", "layer": "harness",
                                    "moves": "lane_scans_per_s", "workloads": [workload]}])
    assert run.per_layer(bench, workload, {"steps": 3}, root) == {
        "dummy_metric": {"value": 6.0, "unit": "x"}}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_named_file_exists():
    names = {"configs": [c["name"] for c in BENCH["configs"]],
             "traffic": [w["traffic"] for w in BENCH["workloads"]],
             "limits": WORKLOADS}
    for kind, want in names.items():
        assert set(want) <= set(run.files(kind, ".json")), kind
    assert {m["name"] for m in BENCH["per_layer"]} <= set(run.files("metrics", ".py"))
    for c in BENCH["configs"]:
        assert (run.ROOT / c["file"]).exists()


def test_schedule_staggers_the_clip_ends():
    lanes, clip, steps = 99, 100, 400
    clip_no, began = run.schedule(lanes, clip, steps)
    t = np.arange(steps)[:, None]
    age = t - began
    assert age.min() == 0 and age.max() == clip - 1
    starts = (age == 0)[1:].sum(axis=1)  # lanes starting a clip at each step after the first
    assert starts.max() <= -(-lanes // clip)
    # every lane starts one clip in any clip-long run of steps
    assert all(starts[t: t + clip].sum() == lanes for t in range(steps - clip))
    # past the first clip no two lanes share an age at any step: the same mix
    # of map ages at every step, but for the one age that 99 lanes leave out
    hist = np.stack([np.bincount(a, minlength=clip) for a in age[clip:]])
    assert hist.max() == 1
    assert (np.diff(clip_no, axis=0) == (age[1:] == 0)).all()


def test_clips_stay_within_their_recordings(feed_cache):
    config, traffic = small_cell(WORKLOADS[0])
    traffic["recordings"] = run.load_json("traffic", run.cell(BENCH, WORKLOADS[0])[0]["traffic"])[
        "recordings"][:3]
    fleet = run.Fleet(config, traffic, 98765432101234, "cpu", 12)
    n = traffic["feed"]["n_scans"]
    assert fleet.feed["xyz"].shape[0] == 3 * n
    scan = fleet.scan_of.numpy()
    recording = scan // n
    # every clip runs within one recording, from a start scan in range
    for b in range(fleet.B):
        for c in np.unique(fleet.clip_no[:, b]):
            steps = fleet.clip_no[:, b] == c
            assert len(set(recording[steps, b])) == 1
            assert scan[steps, b][0] % n <= traffic["start_scan_max"]
    assert len(set(fleet.starts.reshape(-1) // n)) > 1
    # the first recording is the traffic's feed itself
    np.testing.assert_array_equal(fleet.feed["xyz"][:n].numpy(),
                                  feed.load(traffic["feed"])["xyz"])


# the small cell's own limits: one step from the program's own state moves
# by rounding alone
SMALL_LIMITS = {"step_pose_gap_m": 1e-4, "step_rot_gap_rad": 1e-4, "step_map_count_gap": 0.01,
                "reset_gap": 0.0}


def _run(workload, feed_cache, step=None, seed=1234567890123, limits=SMALL_LIMITS, keep=None):
    config, traffic = small_cell(workload)
    return run.run(BENCH, workload, seed, 30.0, False, device="cpu", config=config,
                   traffic=traffic, step=step, limits=limits, max_window_steps=6,
                   log=lambda *a: None, keep=keep)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload, feed_cache):
    keep = {}
    res = _run(workload, feed_cache, keep=keep)
    # a lane began a clip at the step after the close, and its state was
    # the reference's fresh one word for word; every lane's step was checked
    assert keep["started"] and keep["readings"]["reset_gap"] == 0.0
    assert len(keep["after"]) == 4
    assert res["correct"], res["check"]
    assert res["attempted"] == 6 * 4 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"lane_scans_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"}


def _unchanged(state, scan, imu, dt, cfg, map_cfg, device=None):
    return state, {"R": state.nav.R, "p": state.nav.p}


def _half_left_out(state, scan, imu, dt, cfg, map_cfg, device=None):
    from fastliosam_tpu_torch.odom import odom_step_batched

    new, aux = odom_step_batched(state, scan, imu, dt, cfg, map_cfg, device=device)
    keep = torch.arange(aux["p"].shape[0]) < aux["p"].shape[0] // 2

    def pick(a, b):
        return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    mixed = type(new)(type(new.nav)(*map(pick, new.nav, state.nav)),
                      type(new.vmap)(*map(pick, new.vmap, state.vmap)),
                      pick(new.scan_idx, state.scan_idx),
                      pick(new.initialized, state.initialized), pick(new.w_cv, state.w_cv))
    return mixed, {"R": mixed.nav.R, "p": mixed.nav.p}


def _answer_altered(state, scan, imu, dt, cfg, map_cfg, device=None):
    from fastliosam_tpu_torch.odom import odom_step_batched

    new, aux = odom_step_batched(state, scan, imu, dt, cfg, map_cfg, device=device)
    return new, dict(aux, p=aux["p"] + 0.5)


def _planes_left_stale(state, scan, imu, dt, cfg, map_cfg, device=None):
    from fastliosam_tpu_torch.odom import odom_step_batched

    new, aux = odom_step_batched(state, scan, imu, dt, cfg, map_cfg, device=device)
    old = state.vmap
    vmap = new.vmap._replace(normal=old.normal, d=old.d, plane_valid=old.plane_valid)
    return new._replace(vmap=vmap), aux


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered],
                         ids=["state_unchanged", "half_the_lanes_left_out", "answer_altered"])
def test_a_broken_step_is_not_correct(fault, feed_cache):
    res = _run(WORKLOADS[0], feed_cache, step=fault)
    assert not res["correct"], res["check"]
    assert res["failed"] > 0
    # the step from the program's own state catches each fault by itself
    assert res["check"]["step_pose_gap_m"]["value"] > SMALL_LIMITS["step_pose_gap_m"]


def test_planes_left_unrefreshed_are_not_correct(feed_cache):
    cached = next(w["name"] for w in BENCH["workloads"]
                  if run.load_json("configs", w["config"])["odom"]["query_mode"] == "cached")
    res = _run(cached, feed_cache, step=_planes_left_stale)
    assert not res["correct"], res["check"]
    assert res["failed"] > 0


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "fastliosam_tpu_torch_x", types.ModuleType("x"))
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".")[0] in run.FORBIDDEN]
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("fake"))
    assert "jaxlib.fake" in run.forbidden_modules()
    assert "fastliosam_tpu_torch_x" not in run.forbidden_modules()
