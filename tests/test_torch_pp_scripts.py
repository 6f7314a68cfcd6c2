"""The port's post-processing scripts (``fastliosam_tpu_torch/scripts/
{eval_traj,georeference,anonymize}.py``) against the JAX package's
(``scripts/*.py``, loaded by file) on the same files, on the CPU.

Outputs compared: ``eval_traj``'s JSON report equal; ``anonymize``'s
annotated or blurred images and manifest equal byte for byte;
``georeference``'s files, whose geodesy is float32 in both packages (ROADMAP
Queue 3 fault 2), within the limits of ``tests/test_torch_postprocess.py``:
positions within 3 m horizontally (1e-4 degrees is ~11 m; 3 m of latitude
is 2.7e-5 degrees), the similarity's θ within 1e-3 rad and scale within
1e-3, the georeferenced map and the matched route within what that
similarity moves a point 200 m out.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from fastliosam_tpu.io import write_kitti_poses, write_pcd, write_tum_trajectory
from fastliosam_tpu.io.pcd import read_pcd
from fastliosam_tpu.postprocess import Similarity2D
from fastliosam_tpu.postprocess.images import HAS_CV2
from fastliosam_tpu_torch.scripts import anonymize as t_anonymize
from fastliosam_tpu_torch.scripts import eval_traj as t_eval_traj
from fastliosam_tpu_torch.scripts import georeference as t_georeference

REPO = Path(__file__).resolve().parent.parent


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _jax_script(name).main()


def _poses(n, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6, n)
    out = np.tile(np.eye(4), (n, 1, 1))
    yaw = 0.3 * t + rng.normal(size=n) * noise * 0.01
    out[:, 0, 0], out[:, 0, 1], out[:, 1, 0], out[:, 1, 1] = (np.cos(yaw), -np.sin(yaw),
                                                              np.sin(yaw), np.cos(yaw))
    out[:, 0, 3] = t * 20 + rng.normal(size=n) * noise
    out[:, 1, 3] = 8 * np.sin(t) + rng.normal(size=n) * noise
    out[:, 2, 3] = 0.2 * t
    return out


@pytest.mark.parametrize("fmt,flags", [("tum", ["--align"]), ("tum", ["--align-scale"]),
                                       ("kitti", ["--rpe-delta", "5"]), ("tum", [])])
def test_eval_traj_reports_equal(tmp_path, monkeypatch, capsys, fmt, flags):
    gt, est = _poses(120, 0), _poses(120, 1, noise=0.3)
    stamps = 1000.0 + np.arange(120) * 0.1
    for name, p in (("gt", gt), ("est", est)):
        if fmt == "tum":
            write_tum_trajectory(str(tmp_path / f"{name}.txt"), stamps, p)
        else:
            write_kitti_poses(str(tmp_path / f"{name}.txt"), p)
    common = ["--est", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt"),
              "--format", fmt, *flags]
    assert _run_jax("eval_traj", [*common, "--json", str(tmp_path / "j.json")], monkeypatch) == 0
    out_j = capsys.readouterr().out
    assert t_eval_traj.main([*common, "--json", str(tmp_path / "t.json")]) == 0
    out_t = capsys.readouterr().out
    assert out_t == out_j
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_eval_traj_plot(tmp_path):
    pytest.importorskip("matplotlib")
    gt = _poses(50, 2)
    write_kitti_poses(str(tmp_path / "gt.txt"), gt)
    assert t_eval_traj.main(["--est", str(tmp_path / "gt.txt"), "--gt", str(tmp_path / "gt.txt"),
                             "--format", "kitti", "--plot", str(tmp_path / "ate.png")]) == 0
    assert (tmp_path / "ate.png").stat().st_size > 1000


def _georef_inputs(tmp_path):
    """A TUM trajectory, gnss.txt made from it through a known similarity and
    a float64 conversion around a Hong Kong anchor, a map PCD and a road
    network (the path's centreline and a road 40 m off)."""
    n = 80
    poses = _poses(n, 3)
    stamps = 1000.0 + np.arange(n) * 0.5
    write_tum_trajectory(str(tmp_path / "traj_tum.txt"), stamps, poses)
    enu = Similarity2D(1.0, 0.4, 30.0, -20.0).apply(poses[:, :2, 3])
    lat0, lon0 = 22.3193, 114.1694
    gps = np.column_stack([stamps + 0.02, lat0 + enu[:, 1] / 110_760.0,
                           lon0 + enu[:, 0] / (111_320.0 * np.cos(np.radians(lat0))),
                           np.full(n, 12.0)])
    np.savetxt(tmp_path / "gnss.txt", gps, fmt="%.10f")
    rng = np.random.default_rng(4)
    cloud = np.zeros(500, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"), ("intensity", "f4")])
    for k in ("x", "y", "z", "intensity"):
        cloud[k] = rng.normal(size=500) * 20
    write_pcd(str(tmp_path / "map.pcd"), cloud)
    road = enu[::4] - enu[0]  # the ENU frame is anchored at the first fix
    roads = [road.tolist(), (road + [0.0, 40.0]).tolist()]
    (tmp_path / "roads.json").write_text(json.dumps(roads))


def test_georeference_outputs_agree(tmp_path, monkeypatch, capsys):
    _georef_inputs(tmp_path)
    common = ["--traj", str(tmp_path / "traj_tum.txt"), "--gps", str(tmp_path / "gnss.txt"),
              "--pcd", str(tmp_path / "map.pcd"), "--mapmatch", str(tmp_path / "roads.json")]
    assert _run_jax("georeference", [*common, "--out", str(tmp_path / "j")], monkeypatch) == 0
    lines_j = capsys.readouterr().out.splitlines()
    assert t_georeference.main([*common, "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    lines_t = capsys.readouterr().out.splitlines()
    assert len(lines_t) == len(lines_j) == 3
    rep_t, rep_j = json.loads(lines_t[0]), json.loads(lines_j[0])
    assert rep_t["n_pairs"] == rep_j["n_pairs"] == 80
    assert abs(rep_t["mean_error_m"] - rep_j["mean_error_m"]) <= 1.0
    mm_t, mm_j = json.loads(lines_t[2]), json.loads(lines_j[2])
    assert mm_t["matched_fraction"] == mm_j["matched_fraction"] == 1.0
    assert abs(mm_t["route_length_m"] - mm_j["route_length_m"]) <= 0.5

    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    assert sorted(p.name for p in t_dir.iterdir()) == sorted(p.name for p in j_dir.iterdir())
    wgs_t = np.loadtxt(t_dir / "trajectory_wgs84.csv", delimiter=",", skiprows=1)
    wgs_j = np.loadtxt(j_dir / "trajectory_wgs84.csv", delimiter=",", skiprows=1)
    assert np.array_equal(wgs_t[:, 0], wgs_j[:, 0])
    assert np.abs(wgs_t[:, 1:] - wgs_j[:, 1:]).max() <= 2.7e-5
    par_t = json.loads((t_dir / "alignment_params.json").read_text())
    par_j = json.loads((j_dir / "alignment_params.json").read_text())
    assert par_t.keys() == par_j.keys()
    assert abs(par_t["theta"] - par_j["theta"]) <= 1e-3
    assert abs(par_t["scale"] - par_j["scale"]) <= 1e-3
    # a point 200 m out moves by at most 200 * (|dθ| + |ds|) + |dt| between the two fits
    moved = 200 * (abs(par_t["theta"] - par_j["theta"]) + abs(par_t["scale"] - par_j["scale"]))
    moved += np.hypot(par_t["tx"] - par_j["tx"], par_t["ty"] - par_j["ty"])
    xyz_t, xyz_j = (np.column_stack([read_pcd(str(d / "map_georef.pcd"))[k] for k in "xyz"])
                    for d in (t_dir, j_dir))
    assert np.abs(xyz_t - xyz_j).max() <= moved + 1e-3
    route_t = np.loadtxt(t_dir / "matched_route.csv", delimiter=",", skiprows=1)
    route_j = np.loadtxt(j_dir / "matched_route.csv", delimiter=",", skiprows=1)
    assert np.array_equal(route_t[:, 3], route_j[:, 3])
    assert np.abs(route_t[:, 1:3] - route_j[:, 1:3]).max() <= moved + 1e-3
    assert "leaflet" in (t_dir / "map.html").read_text()


@pytest.mark.skipif(not HAS_CV2, reason="cv2 unavailable")
@pytest.mark.parametrize("mode", ["annotate", "blur"])
def test_anonymize_outputs_equal(tmp_path, monkeypatch, capsys, mode):
    import cv2
    import torch

    class Head(torch.nn.Module):
        def forward(self, x):
            out = torch.zeros(1, 6, 64)
            out[0, :4, 0] = torch.tensor([160.0, 150.0, 80.0, 60.0])
            out[0, 4, 0] = 0.3 + x.mean()
            out[0, :4, 1] = torch.tensor([60.0, 70.0, 40.0, 40.0])
            out[0, 5, 1] = 0.9
            out[0, :4, 2] = torch.tensor([62.0, 72.0, 40.0, 40.0])
            out[0, 5, 2] = 0.8  # overlaps detection 1: suppressed
            return out

    torch.jit.script(Head()).save(str(tmp_path / "head.pt"))
    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(5)
    for k in range(3):
        cv2.imwrite(str(src / f"{k}.png"), rng.integers(0, 255, (240, 320, 3)).astype(np.uint8))
    common = ["--source", str(src), "--model", str(tmp_path / "head.pt"), "--imgsz", "320",
              "--conf", "0.25", "--classes", "0", "1", "--mode", mode]
    _run_jax("anonymize", [*common, "--project", str(tmp_path / "j")], monkeypatch)
    out_j = capsys.readouterr().out
    t_anonymize.main([*common, "--project", str(tmp_path / "t"), "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert out_t.replace(str(tmp_path / "t"), "") == out_j.replace(str(tmp_path / "j"), "")
    t_dir, j_dir = tmp_path / "t" / "predict_run", tmp_path / "j" / "predict_run"
    names = sorted(p.name for p in j_dir.iterdir())
    assert names == sorted(p.name for p in t_dir.iterdir()) and "detections.json" in names
    for name in names:
        assert (t_dir / name).read_bytes() == (j_dir / name).read_bytes()
    manifest = json.loads((t_dir / "detections.json").read_text())
    assert sum(map(len, manifest.values())) == 6
