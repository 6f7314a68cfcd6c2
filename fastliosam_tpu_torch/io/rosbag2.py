"""Minimal ROS2 bag (sqlite3 ``.db3``) reader + CDR message decoding.

Parity for the reference's `post_process/split_ros2_bag.py` (which uses the
`rosbags` library): reads the sqlite storage directly with the stdlib, and
decodes the sensor messages the pipeline needs from their CDR wire format
(XCDR1 little-endian, the rmw_fastrtps default).

The port's own numpy copy of ``fastliosam_tpu/io/rosbag2.py``.
"""
from __future__ import annotations

import os
import sqlite3
import struct
from dataclasses import dataclass

import numpy as np

from .rosbag import _PF_DTYPES


class CdrReader:
    """Sequential XCDR1 reader with primitive alignment."""

    def __init__(self, data: bytes):
        # 4-byte encapsulation header: {0x00, 0x01} = CDR_LE
        if len(data) < 4:
            raise ValueError("short CDR payload")
        self.little = data[1] in (0x01, 0x03)
        self.buf = data
        self.off = 4

    def _align(self, size):
        # alignment is relative to the start of the serialized body
        rem = (self.off - 4) % size
        if rem:
            self.off += size - rem

    def _prim(self, fmt, size):
        self._align(size)
        (v,) = struct.unpack_from(("<" if self.little else ">") + fmt, self.buf, self.off)
        self.off += size
        return v

    def uint8(self):
        return self._prim("B", 1)

    def int8(self):
        return self._prim("b", 1)

    def uint16(self):
        return self._prim("H", 2)

    def uint32(self):
        return self._prim("I", 4)

    def int32(self):
        return self._prim("i", 4)

    def uint64(self):
        return self._prim("Q", 8)

    def float32(self):
        return self._prim("f", 4)

    def float64(self):
        return self._prim("d", 8)

    def string(self):
        n = self.uint32()
        s = self.buf[self.off : self.off + n - 1].decode(errors="replace")
        self.off += n
        return s

    def bytes_(self, n):
        out = self.buf[self.off : self.off + n]
        self.off += n
        return out

    def f64_array(self, n):
        self._align(8)
        out = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return out.copy()

    def header(self):
        """std_msgs/Header (ROS2: stamp {sec int32, nanosec uint32}, frame_id)."""
        sec = self.int32()
        nanosec = self.uint32()
        frame_id = self.string()
        return {"stamp": sec + nanosec * 1e-9, "frame_id": frame_id}


def decode_pointcloud2_cdr(data: bytes):
    r = CdrReader(data)
    hdr = r.header()
    height = r.uint32()
    width = r.uint32()
    n_fields = r.uint32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        foff = r.uint32()
        dtype = r.uint8()
        count = r.uint32()
        fields.append((name, foff, dtype, count))
    is_bigendian = r.uint8()
    point_step = r.uint32()
    row_step = r.uint32()
    n_bytes = r.uint32()
    body = r.bytes_(n_bytes)
    dt = np.dtype(
        {
            "names": [f[0] for f in sorted(fields, key=lambda x: x[1])],
            "formats": [
                ("<" if not is_bigendian else ">") + _PF_DTYPES[f[2]]
                for f in sorted(fields, key=lambda x: x[1])
            ],
            "offsets": [f[1] for f in sorted(fields, key=lambda x: x[1])],
            "itemsize": point_step,
        }
    )
    arr = np.frombuffer(body, dtype=dt, count=height * width)
    return arr.copy(), hdr


def decode_imu_cdr(data: bytes):
    r = CdrReader(data)
    hdr = r.header()
    orientation = r.f64_array(4)
    r.f64_array(9)
    gyro = r.f64_array(3)
    r.f64_array(9)
    accel = r.f64_array(3)
    r.f64_array(9)
    return {
        "header": hdr,
        "orientation": orientation,
        "angular_velocity": gyro,
        "linear_acceleration": accel,
    }


def decode_navsatfix_cdr(data: bytes):
    r = CdrReader(data)
    hdr = r.header()
    status = r.int8()
    service = r.uint16()
    lat = r.float64()
    lon = r.float64()
    alt = r.float64()
    cov = r.f64_array(9)
    cov_type = r.uint8()
    return {
        "header": hdr, "status": status, "latitude": lat, "longitude": lon,
        "altitude": alt, "position_covariance": cov.reshape(3, 3),
        "covariance_type": cov_type,
    }


CDR_DECODERS = {
    "sensor_msgs/msg/PointCloud2": decode_pointcloud2_cdr,
    "sensor_msgs/msg/Imu": decode_imu_cdr,
    "sensor_msgs/msg/NavSatFix": decode_navsatfix_cdr,
}


@dataclass
class Bag2Message:
    topic: str
    msg_type: str
    stamp: float
    raw: bytes


class Bag2Reader:
    """Iterate messages from a ROS2 bag directory or a bare .db3 file."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            db3s = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if f.endswith(".db3")
            )
            if not db3s:
                raise FileNotFoundError(f"no .db3 under {path}")
            self.dbs = db3s
        else:
            self.dbs = [path]

    def __iter__(self):
        for db in self.dbs:
            con = sqlite3.connect(db)
            try:
                topics = {
                    tid: (name, mtype)
                    for tid, name, mtype in con.execute(
                        "SELECT id, name, type FROM topics"
                    )
                }
                for tid, ts, data in con.execute(
                    "SELECT topic_id, timestamp, data FROM messages "
                    "ORDER BY timestamp"
                ):
                    name, mtype = topics[tid]
                    yield Bag2Message(
                        topic=name, msg_type=mtype, stamp=ts * 1e-9, raw=data
                    )
            finally:
                con.close()


def split_bag2(in_path: str, out_pattern: str, segment_seconds: float) -> list[str]:
    """Split a ROS2 bag into time segments, writing .db3 outputs
    (`split_ros2_bag.py` capability)."""
    msgs = list(Bag2Reader(in_path))
    if not msgs:
        return []
    # collect topic metadata from the source
    src_db = Bag2Reader(in_path).dbs[0]
    con = sqlite3.connect(src_db)
    topic_rows = list(
        con.execute(
            "SELECT id, name, type, serialization_format FROM topics"
        )
    )
    con.close()
    t0 = min(m.stamp for m in msgs)
    t1 = max(m.stamp for m in msgs)
    outs = []
    i = 0
    start = t0
    while start < t1:
        end = start + segment_seconds
        seg = [m for m in msgs if start <= m.stamp < end]
        if seg:
            path = out_pattern.format(i=i)
            con = sqlite3.connect(path)
            con.execute(
                "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, "
                "type TEXT, serialization_format TEXT, "
                "offered_qos_profiles TEXT)"
            )
            con.execute(
                "CREATE TABLE messages(id INTEGER PRIMARY KEY, "
                "topic_id INTEGER, timestamp INTEGER, data BLOB)"
            )
            name_to_id = {}
            for tid, name, mtype, fmt in topic_rows:
                con.execute(
                    "INSERT INTO topics VALUES (?, ?, ?, ?, '')",
                    (tid, name, mtype, fmt),
                )
                name_to_id[name] = tid
            for k, m in enumerate(seg):
                con.execute(
                    "INSERT INTO messages VALUES (?, ?, ?, ?)",
                    (k + 1, name_to_id[m.topic], int(m.stamp * 1e9), m.raw),
                )
            con.commit()
            con.close()
            outs.append(path)
        i += 1
        start = end
    return outs
