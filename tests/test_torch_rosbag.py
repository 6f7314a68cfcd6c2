"""The port's ROS bag layer (``io/rosbag.py``, ``io/rosbag2.py``) against
the JAX package's on the same bytes: a bag written by either package is
byte for byte the other's and reads back equal in both; a hand-built bz2
chunk reads; every codec in ``DECODERS`` decodes equal; ``split_bag``;
and the ROS2 sqlite bag of ``tests/test_rosbag2.py`` with ``split_bag2``.
Everything is compared exactly: both sides are numpy and the stdlib.
"""
import bz2
import struct

import numpy as np
import pytest

from fastliosam_tpu.io import rosbag as jbag
from fastliosam_tpu.io import rosbag2 as jbag2
from fastliosam_tpu_torch.io import rosbag as tbag
from fastliosam_tpu_torch.io import rosbag2 as tbag2
from fastliosam_tpu_torch.sim.writers import LIVOX_POINT, encode_livox_custommsg
from tests.test_rosbag2 import encode_imu_cdr, encode_navsatfix_cdr, encode_pc2_cdr, write_db3

CLOUD_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
                        ("t", "<u4"), ("ring", "<u2"), ("tag", "i1"), ("line", "u1"),
                        ("refl", "<i2"), ("range", "<i4"), ("ts", "<f8")])


def _cloud(rng, n=64):
    cloud = np.zeros(n, CLOUD_DTYPE)
    for name in CLOUD_DTYPE.names:
        kind = CLOUD_DTYPE[name].kind
        cloud[name] = rng.normal(size=n) * 10 if kind == "f" else rng.integers(0, 100, n)
    return cloud


def _odometry(stamp):
    """nav_msgs/Odometry: header, child_frame_id, pose (7 + 36 covariance),
    twist (6 + 36 covariance)."""
    vals = [1.0, 2.0, 3.0, 0.0, 0.0, 0.6, 0.8] + [0.01] * 36 + [0.5, 0.1, 0.0, 0.0, 0.0, 0.2]
    vals += [0.02] * 36
    return (jbag._pack_rosheader(7, stamp, "odom") + jbag._pack_string("base_link")
            + struct.pack("<" + "d" * len(vals), *vals))


def _compressed_image(stamp):
    data = bytes(range(256)) * 3
    return (jbag._pack_rosheader(3, stamp, "camera") + jbag._pack_string("jpeg")
            + struct.pack("<I", len(data)) + data)


def _custommsg(rng, stamp):
    pts = np.zeros(40, LIVOX_POINT)
    pts["offset_time"] = np.sort(rng.integers(0, 100_000_000, 40))
    for name in ("x", "y", "z"):
        pts[name] = rng.normal(size=40) * 20
    pts["reflectivity"] = rng.integers(0, 255, 40)
    pts["line"] = rng.integers(0, 6, 40)
    return encode_livox_custommsg(pts, stamp, 12345678901, seq=2)


def _messages(mod, rng):
    """(topic, type, stamp, raw) of every type in DECODERS, out of stamp
    order, encoded by ``mod``'s encoders where it has them."""
    return [
        ("/points", "sensor_msgs/PointCloud2", 10.3, mod.encode_pointcloud2(_cloud(rng), 10.2)),
        ("/imu", "sensor_msgs/Imu", 10.05, mod.encode_imu(10.05, [0.1, -0.2, 0.3],
                                                          [0.0, 0.1, 9.81], seq=4)),
        ("/gps/fix", "sensor_msgs/NavSatFix", 10.5,
         mod.encode_navsatfix(10.5, 22.3193, 114.1694, 10.0, cov_diag=(0.25, 0.36, 1.0),
                              status=-1)),
        ("/odom", "nav_msgs/Odometry", 9.9, _odometry(9.9)),
        ("/camera/compressed", "sensor_msgs/CompressedImage", 10.1, _compressed_image(10.1)),
        ("/save_dir", "std_msgs/String", 11.0, mod.encode_string("/tmp/x")),
        ("/livox/lidar", "livox_ros_driver/CustomMsg", 10.25, _custommsg(rng, 10.15)),
        ("/imu", "sensor_msgs/Imu", 9.95, mod.encode_imu(9.95, [0.0, 0.0, 0.0],
                                                         [0.0, 0.0, 9.81], seq=3)),
    ]


def _write(mod, path, msgs):
    with mod.BagWriter(str(path)) as w:
        for topic, mtype, stamp, raw in msgs:
            w.write(topic, mtype, stamp, raw)
    return path.read_bytes()


def _read(mod, path):
    reader = mod.BagReader(str(path))
    msgs = [(m.topic, m.msg_type, m.stamp, m.raw) for m in reader]
    conns = {c: (v.cid, v.topic, v.msg_type, v.md5sum, v.definition)
             for c, v in reader.connections.items()}
    return msgs, conns


def _same(a, b):
    """Decoded values equal: dicts by key, arrays by dtype and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


def test_bag_bytes_equal_and_read_back_equal(tmp_path, rng):
    seed = rng.integers(1 << 30)
    j_msgs = _messages(jbag, np.random.default_rng(seed))
    t_msgs = _messages(tbag, np.random.default_rng(seed))
    assert [m[3] for m in t_msgs] == [m[3] for m in j_msgs]  # the encoders agree
    j_bytes = _write(jbag, tmp_path / "jax.bag", j_msgs)
    t_bytes = _write(tbag, tmp_path / "port.bag", t_msgs)
    assert t_bytes == j_bytes
    for path in ("jax.bag", "port.bag"):
        want = _read(jbag, tmp_path / path)
        assert _read(tbag, tmp_path / path) == want
        assert [m[2] for m in want[0]] == sorted(jbag.from_stamp(*jbag.to_stamp(m[2]))
                                                 for m in j_msgs)
        assert len(want[0]) == len(j_msgs) and len(want[1]) == 7


def test_empty_bag_bytes_equal(tmp_path):
    assert _write(tbag, tmp_path / "port.bag", []) == _write(jbag, tmp_path / "jax.bag", [])
    assert _read(tbag, tmp_path / "port.bag") == _read(jbag, tmp_path / "jax.bag") == ([], {})


def _record(header: dict, data: bytes) -> bytes:
    h = jbag._build_header(header)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def test_hand_built_bz2_chunk_reads(tmp_path, rng):
    """A bag as rosbag writes it with ``--bz2``: connection records inside
    the compressed chunk and again after it."""
    msgs = _messages(jbag, rng)[:3]
    conns = {topic: i for i, topic in enumerate(dict.fromkeys(m[0] for m in msgs))}

    def conn_rec(topic, mtype):
        return _record({"op": bytes([jbag.OP_CONNECTION]), "conn": struct.pack("<I", conns[topic]),
                        "topic": topic},
                       jbag._build_header({"topic": topic, "type": mtype, "md5sum": "abc",
                                           "message_definition": "float64 x"}))

    body = b"".join(conn_rec(t, m) for t, m, _, _ in msgs)
    for topic, _, stamp, raw in msgs:
        body += _record({"op": bytes([jbag.OP_MSG]), "conn": struct.pack("<I", conns[topic]),
                         "time": struct.pack("<II", *jbag.to_stamp(stamp))}, raw)
    blob = (jbag._MAGIC
            + _record({"op": bytes([jbag.OP_BAG_HEADER]), "index_pos": struct.pack("<Q", 0),
                       "conn_count": struct.pack("<I", len(conns)),
                       "chunk_count": struct.pack("<I", 1)}, b" " * 64)
            + _record({"op": bytes([jbag.OP_CHUNK]), "compression": "bz2",
                       "size": struct.pack("<I", len(body))}, bz2.compress(body))
            + b"".join(conn_rec(t, m) for t, m, _, _ in msgs))
    path = tmp_path / "bz2.bag"
    path.write_bytes(blob)
    got, conn_table = _read(tbag, path)
    assert (got, conn_table) == _read(jbag, path)
    assert got == [(t, m, jbag.from_stamp(*jbag.to_stamp(s)), r) for t, m, s, r in msgs]
    assert {v[3] for v in conn_table.values()} == {"abc"}


def test_unknown_compression_and_magic_raise(tmp_path):
    bad = tmp_path / "lz4.bag"
    bad.write_bytes(jbag._MAGIC + _record({"op": bytes([jbag.OP_CHUNK]), "compression": "lz4",
                                           "size": struct.pack("<I", 0)}, b""))
    with pytest.raises(NotImplementedError, match="lz4"):
        list(tbag.BagReader(str(bad)))
    bad.write_bytes(b"#ROSBAG V1.2\n")
    with pytest.raises(ValueError, match="not a ROS1 v2.0 bag"):
        list(tbag.BagReader(str(bad)))


@pytest.mark.parametrize("msg_type", sorted(jbag.DECODERS))
def test_decoders_equal(msg_type, rng):
    assert set(tbag.DECODERS) == set(jbag.DECODERS)
    raws = [m[3] for m in _messages(jbag, rng) if m[1] == msg_type]
    assert raws
    for raw in raws:
        _same(tbag.DECODERS[msg_type](raw), jbag.DECODERS[msg_type](raw))


@pytest.mark.parametrize("overlap", [0.0, 1.0])
def test_split_bag_equal(tmp_path, overlap):
    msgs = [("/imu", "sensor_msgs/Imu", 100.0 + k * 0.1,
             jbag.encode_imu(100.0 + k * 0.1, [0, 0, k * 1e-3], [0, 0, 9.81]))
            for k in range(100)]
    msgs += [("/gps/fix", "sensor_msgs/NavSatFix", 100.0 + k,
              jbag.encode_navsatfix(100.0 + k, 22.3, 114.2, 5.0)) for k in range(10)]
    _write(jbag, tmp_path / "long.bag", msgs)
    outs = {}
    for name, mod in (("jax", jbag), ("port", tbag)):
        paths = mod.split_bag(str(tmp_path / "long.bag"), str(tmp_path / f"{name}_{{i}}.bag"),
                              4.0, overlap_seconds=overlap)
        outs[name] = [open(p, "rb").read() for p in paths]
    assert len(outs["port"]) == len(outs["jax"]) >= 3
    assert outs["port"] == outs["jax"]


def _bag2_rows(rng):
    cloud = np.zeros(50, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4")])
    cloud["x"] = rng.normal(size=50)
    cloud["z"] = rng.normal(size=50)
    rows = [("/points", "sensor_msgs/msg/PointCloud2", 5.0, encode_pc2_cdr(cloud, 5.0))]
    rows += [("/imu", "sensor_msgs/msg/Imu", 5.0 + 0.5 * k,
              encode_imu_cdr(5.0 + 0.5 * k, [0.1, 0.2, 0.3 * k], [0, 0, 9.81])) for k in range(20)]
    rows += [("/gps", "sensor_msgs/msg/NavSatFix", 5.5 + k,
              encode_navsatfix_cdr(5.5 + k, 22.3, 114.2, 4.0)) for k in range(6)]
    return rows


def test_bag2_reads_and_decodes_equal(tmp_path, rng):
    db = tmp_path / "bag" / "bag_0.db3"
    db.parent.mkdir()
    write_db3(str(db), _bag2_rows(rng))
    for path in (str(db), str(db.parent)):  # a .db3 file and its bag directory
        want = [(m.topic, m.msg_type, m.stamp, m.raw) for m in jbag2.Bag2Reader(path)]
        got = [(m.topic, m.msg_type, m.stamp, m.raw) for m in tbag2.Bag2Reader(path)]
        assert got == want and len(want) == 27
    assert set(tbag2.CDR_DECODERS) == set(jbag2.CDR_DECODERS)
    for _, mtype, _, raw in want:
        _same(tbag2.CDR_DECODERS[mtype](raw), jbag2.CDR_DECODERS[mtype](raw))
    with pytest.raises(FileNotFoundError):
        tbag2.Bag2Reader(str(tmp_path))


def test_split_bag2_equal(tmp_path, rng):
    db = str(tmp_path / "long_0.db3")
    write_db3(db, _bag2_rows(rng))
    got = {}
    for name, mod in (("jax", jbag2), ("port", tbag2)):
        paths = mod.split_bag2(db, str(tmp_path / f"{name}_{{i}}.db3"), 4.0)
        got[name] = [[(m.topic, m.msg_type, m.stamp, m.raw) for m in mod.Bag2Reader(p)]
                     for p in paths]
    assert len(got["port"]) == len(got["jax"]) >= 3
    assert got["port"] == got["jax"]
    assert sum(len(seg) for seg in got["port"]) == 27
