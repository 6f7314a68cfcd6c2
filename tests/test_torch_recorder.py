"""The port's sensor recorder, telemetry sinks and ``bag_tools`` against
the JAX package's on the same bag: ``SensorRecorder`` writes the same
files (PCD and .bin clouds, IMU and GNSS text, telemetry JSON lines,
undistorted camera frames where OpenCV is installed), ``bag_tools
info|extract|split|split2`` print and write the same, and ``HttpSink`` /
``WebSocketSink`` deliver the same envelopes to servers on local sockets,
as ``tests/test_telemetry.py`` runs them. Compared exactly, except each
envelope's ``message_id`` (a fresh UUID in both).
"""
import importlib.util
import json
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest

from fastliosam_tpu.io import rosbag as jbag
from fastliosam_tpu.runtime import recorder as jrec
from fastliosam_tpu.runtime import telemetry as jtel
from fastliosam_tpu_torch.io import rosbag as tbag
from fastliosam_tpu_torch.postprocess.images import HAS_CV2
from fastliosam_tpu_torch.runtime import recorder as trec
from fastliosam_tpu_torch.runtime import telemetry as ttel
from fastliosam_tpu_torch.scripts import bag_tools
from tests.test_rosbag import make_cloud
from tests.test_rosbag2 import encode_imu_cdr, write_db3
from tests.test_telemetry import PAYLOAD, _ws_server

REPO = Path(__file__).resolve().parent.parent
T0 = 1704164645.0
MRCAL = """{
    'lensmodel': 'LENSMODEL_OPENCV8',
    'intrinsics': ['LENSMODEL_OPENCV8',
        [60.0, 61.0, 32.0, 24.0, 0.1, -0.05, 0.001, 0.001, 0.01, 0.0, 0.0, 0.0]],
    'imagersize': [64, 48],
}
"""


def _jpeg(rng):
    import cv2

    img = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    return cv2.imencode(".jpg", img)[1].tobytes()


def write_bag(path, rng):
    """IMU at 10 Hz, clouds and fixes at 1 Hz, camera frames (OpenCV only),
    a String and a topic no recorder reads."""
    cloud = make_cloud(rng, 50)
    with tbag.BagWriter(str(path)) as w:
        for k in range(30):
            t = T0 + k * 0.1
            w.write("/imu", "sensor_msgs/Imu", t,
                    tbag.encode_imu(t, [0.1, 0.01 * k, 0], [0, 0, 9.8]))
        for k in range(3):
            t = T0 + k
            w.write("/points", "sensor_msgs/PointCloud2", t, tbag.encode_pointcloud2(cloud, t))
            w.write("/gps/fix", "sensor_msgs/NavSatFix", t + 0.01,
                    tbag.encode_navsatfix(t + 0.01, 22.3 + 1e-5 * k, 114.2, 5.0,
                                          cov_diag=(0.5, 0.5, 2.0)))
            if HAS_CV2:
                data = _jpeg(rng)
                w.write("/camera/compressed", "sensor_msgs/CompressedImage", t + 0.02,
                        jbag._pack_rosheader(k, t + 0.02, "cam") + jbag._pack_string("jpeg")
                        + len(data).to_bytes(4, "little") + data)
        w.write("/save_dir", "std_msgs/String", T0 + 2.5, tbag.encode_string("/tmp/x"))
        w.write("/other", "pkg/Unknown", T0 + 2.6, b"\x00" * 8)
    return str(path)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("cloud_format", ["pcd", "bin"])
def test_recorder_files_equal(cloud_format, tmp_path, rng):
    bag = write_bag(tmp_path / "rec.bag", rng)
    (tmp_path / "cam.cameramodel").write_text(MRCAL)
    counts = {}
    for name, rec_mod, img_mod in (("jax", jrec, "fastliosam_tpu.postprocess.images"),
                                   ("port", trec, "fastliosam_tpu_torch.postprocess.images")):
        cam = importlib.import_module(img_mod).CameraModel.from_mrcal(
            str(tmp_path / "cam.cameramodel"))
        rec = rec_mod.SensorRecorder(rec_mod.RecorderConfig(
            out_dir=str(tmp_path / name), cloud_format=cloud_format), camera=cam)
        rec.consume_bag(bag)
        rec.close()
        counts[name] = rec.counts
    assert counts["port"] == counts["jax"]
    assert counts["port"]["clouds"] == 3 and counts["port"]["imu"] == 30
    assert counts["port"]["images"] == (3 if HAS_CV2 else 0)
    assert counts["port"]["telemetry"] >= 3
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert trec.hkt_stamp_name(1704164645.678) == jrec.hkt_stamp_name(1704164645.678)


def _jax_bag_tools():
    spec = importlib.util.spec_from_file_location("jax_bag_tools", REPO / "scripts" / "bag_tools.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(tmp_path, monkeypatch, capsys, make_argv):
    """Run ``bag_tools`` of each package with ``make_argv(tag)``; returns
    what each printed, parsed as JSON, with ``tag`` removed."""
    out = {}
    monkeypatch.setattr(sys, "argv", ["bag_tools.py", *make_argv("jax")])
    _jax_bag_tools().main()
    out["jax"] = capsys.readouterr().out
    assert bag_tools.main(make_argv("port")) == 0
    out["port"] = capsys.readouterr().out
    return {k: json.loads(v.replace(k, "TAG")) for k, v in out.items()}


def test_bag_tools_info_and_extract_equal(tmp_path, monkeypatch, capsys, rng):
    bag = write_bag(tmp_path / "run.bag", rng)
    (tmp_path / "cam.cameramodel").write_text(MRCAL)
    got = _both(tmp_path, monkeypatch, capsys, lambda tag: ["info", "--bag", bag])
    assert got["port"] == got["jax"]
    assert got["port"]["topics"]["/imu"] == {"count": 30, "type": "sensor_msgs/Imu"}
    got = _both(tmp_path, monkeypatch, capsys, lambda tag: [
        "extract", "--bag", bag, "--out", str(tmp_path / tag), "--cloud-format", "bin",
        "--camera-model", str(tmp_path / "cam.cameramodel")])
    assert got["port"] == got["jax"] and got["port"]["clouds"] == 3
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_bag_tools_split_and_split2_equal(tmp_path, monkeypatch, capsys, rng):
    bag = write_bag(tmp_path / "run.bag", rng)
    got = _both(tmp_path, monkeypatch, capsys, lambda tag: [
        "split", "--bag", bag, "--out", str(tmp_path / f"{tag}_{{i}}.bag"), "--seconds", "1.0",
        "--overlap", "0.5"])
    assert got["port"] == got["jax"] and len(got["port"]["segments"]) >= 3
    for seg in got["port"]["segments"]:
        assert (Path(seg.replace("TAG", "port")).read_bytes()
                == Path(seg.replace("TAG", "jax")).read_bytes())
    db = str(tmp_path / "ros2_0.db3")
    write_db3(db, [("/imu", "sensor_msgs/msg/Imu", 100.0 + 0.5 * k,
                    encode_imu_cdr(100.0 + 0.5 * k, [0, 0, 0.1 * k], [0, 0, 9.81]))
                   for k in range(20)])
    got = _both(tmp_path, monkeypatch, capsys, lambda tag: [
        "split2", "--bag", db, "--out", str(tmp_path / f"{tag}_{{i}}.db3"), "--seconds", "4"])
    assert got["port"] == got["jax"] and len(got["port"]["segments"]) == 3


def _without_id(env):
    return {k: v for k, v in env.items() if k != "message_id"}


def test_envelope_and_multi_sink_equal():
    env = ttel.make_envelope(PAYLOAD, sender="s")
    assert _without_id(env) == _without_id(jtel.make_envelope(PAYLOAD, sender="s"))
    assert env["message_id"] != ttel.make_envelope(PAYLOAD)["message_id"]
    seen = []
    ttel.multi_sink(seen.append, lambda p: seen.append(dict(p, n=1)))(PAYLOAD)
    assert seen == [PAYLOAD, dict(PAYLOAD, n=1)]


def test_http_sink_equal_on_a_local_socket():
    received = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            received.append((self.path, self.headers["Content-Type"],
                             json.loads(self.rfile.read(n))))
            self.send_response(201)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/api/ops/socket-message/"
        sinks = {"jax": jtel.HttpSink(url), "port": ttel.HttpSink(url),
                 "raw": ttel.HttpSink(url, envelope=False)}
        for sink in sinks.values():
            sink(PAYLOAD)
    finally:
        srv.shutdown()
        srv.server_close()
    assert [(s.sent, s.failed, s.last_status) for s in sinks.values()] == [(1, 0, 201)] * 3
    (jp, jc, jb), (tp, tc, tb), raw = received
    assert (tp, tc, _without_id(tb)) == (jp, jc, _without_id(jb))
    assert raw[2] == PAYLOAD
    down = ttel.HttpSink(f"http://127.0.0.1:{srv.server_port}/gone", timeout=0.3)
    down(PAYLOAD)
    assert (down.sent, down.failed) == (0, 1)


def test_websocket_sink_equal_on_a_local_socket():
    frames = {}
    for name, mod in (("jax", jtel), ("port", ttel)):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        got, errors = [], []
        t = threading.Thread(target=_ws_server, args=(srv, got, errors), daemon=True)
        t.start()
        sink = mod.WebSocketSink("127.0.0.1", srv.getsockname()[1], "/ws")
        sink(PAYLOAD)
        t.join(timeout=10)
        srv.close()
        assert not t.is_alive() and not errors, errors
        assert (sink.sent, sink.failed) == (1, 0)
        frames[name] = [(op, _without_id(json.loads(data))) for op, data in got]
    assert frames["port"] == frames["jax"] and frames["port"][0][0] == 0x1
    refused = ttel.WebSocketSink("127.0.0.1", 9, timeout=0.3)
    refused(PAYLOAD)
    assert (refused.sent, refused.failed) == (0, 1)
