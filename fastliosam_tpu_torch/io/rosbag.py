"""Minimal self-contained ROS1 bag (v2.0) reader/writer + message codecs.

The bag container format and the message types the pipeline needs, read
and written directly on the binary layout (no ROS installation):

  reader: bag header / chunk (none|bz2) / connection / message records
  writer: single-chunk uncompressed bags with connection+chunk-info+index
          records (re-readable here and reindexable by rosbag tools)
  codecs: sensor_msgs/{PointCloud2, Imu, NavSatFix, CompressedImage},
          nav_msgs/Odometry, std_msgs/String, livox_ros_driver/CustomMsg

The port's own numpy copy of ``fastliosam_tpu/io/rosbag.py``: a bag that
either package writes is byte for byte the other's. The writer joins its
records once instead of growing one bytes object, which keeps writing a
bag of full-width scans linear in its size.

Format reference: http://wiki.ros.org/Bags/Format/2.0
"""
from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        item = buf[off : off + flen]
        off += flen
        name, _, value = item.partition(b"=")
        fields[name.decode()] = value
    return fields


def _build_header(fields: dict) -> bytes:
    parts = []
    for name, value in fields.items():
        if isinstance(value, str):
            value = value.encode()
        item = name.encode() + b"=" + value
        parts.append(struct.pack("<I", len(item)) + item)
    return b"".join(parts)


def _u32(v):
    return struct.pack("<I", v)


def _u64(v):
    return struct.pack("<Q", v)


def _time(sec_nsec):
    return struct.pack("<II", *sec_nsec)


def to_stamp(t: float):
    sec = int(t)
    return (sec, int(round((t - sec) * 1e9)))


def from_stamp(sec, nsec) -> float:
    return sec + nsec * 1e-9


@dataclass
class Connection:
    cid: int
    topic: str
    msg_type: str
    md5sum: str = "*"
    definition: str = ""


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float
    raw: bytes


class BagReader:
    """Iterate `BagMessage`s from a ROS1 v2.0 bag (none/bz2 chunks)."""

    def __init__(self, path: str):
        self.path = path
        self.connections: dict[int, Connection] = {}

    def __iter__(self):
        with open(self.path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"not a ROS1 v2.0 bag: {self.path}")
            while True:
                rec = self._read_record(f)
                if rec is None:
                    break
                header, data = rec
                op = header.get("op", b"\x00")[0]
                if op == OP_CHUNK:
                    comp = header.get("compression", b"none").decode()
                    if comp == "bz2":
                        data = bz2.decompress(data)
                    elif comp != "none":
                        raise NotImplementedError(f"chunk compression {comp}")
                    yield from self._parse_chunk(data)
                elif op == OP_CONNECTION:
                    self._add_connection(header, data)

    def _read_record(self, f):
        head = f.read(4)
        if len(head) < 4:
            return None
        (hlen,) = struct.unpack("<I", head)
        header = _parse_header(f.read(hlen))
        (dlen,) = struct.unpack("<I", f.read(4))
        data = f.read(dlen)
        return header, data

    def _add_connection(self, header, data):
        cid = struct.unpack("<I", header["conn"])[0]
        topic = header["topic"].decode()
        conn_fields = _parse_header(data)
        self.connections[cid] = Connection(
            cid=cid,
            topic=topic,
            msg_type=conn_fields.get("type", b"").decode(),
            md5sum=conn_fields.get("md5sum", b"*").decode(),
            definition=conn_fields.get("message_definition", b"").decode(),
        )

    def _parse_chunk(self, data: bytes):
        off = 0
        while off < len(data):
            (hlen,) = struct.unpack_from("<I", data, off)
            off += 4
            header = _parse_header(data[off : off + hlen])
            off += hlen
            (dlen,) = struct.unpack_from("<I", data, off)
            off += 4
            body = data[off : off + dlen]
            off += dlen
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._add_connection(header, body)
            elif op == OP_MSG:
                cid = struct.unpack("<I", header["conn"])[0]
                sec, nsec = struct.unpack("<II", header["time"])
                conn = self.connections.get(cid)
                yield BagMessage(
                    topic=conn.topic if conn else f"conn{cid}",
                    msg_type=conn.msg_type if conn else "",
                    stamp=from_stamp(sec, nsec),
                    raw=body,
                )


def _record(header: dict, data: bytes) -> list[bytes]:
    h = _build_header(header)
    return [_u32(len(h)), h, _u32(len(data)), data]


def _conn_record(c: Connection) -> list[bytes]:
    conn_hdr = _build_header({"topic": c.topic, "type": c.msg_type, "md5sum": c.md5sum,
                              "message_definition": c.definition})
    return _record({"op": bytes([OP_CONNECTION]), "conn": _u32(c.cid), "topic": c.topic},
                   conn_hdr)


def _bag_header(index_pos: int, n_conns: int) -> bytes:
    return _build_header({"op": bytes([OP_BAG_HEADER]), "index_pos": _u64(index_pos),
                          "conn_count": _u32(n_conns), "chunk_count": _u32(1)})


class BagWriter:
    """Write a single-chunk uncompressed v2.0 bag."""

    def __init__(self, path: str):
        self.path = path
        self._topics: dict[str, int] = {}
        self._conns: list[Connection] = []
        self._msgs: list[tuple[int, tuple, bytes]] = []

    def add_connection(self, topic: str, msg_type: str, md5sum="*",
                       definition="") -> int:
        if topic in self._topics:
            return self._topics[topic]
        cid = len(self._conns)
        self._conns.append(Connection(cid, topic, msg_type, md5sum, definition))
        self._topics[topic] = cid
        return cid

    def write(self, topic: str, msg_type: str, stamp: float, raw: bytes):
        cid = self.add_connection(topic, msg_type)
        self._msgs.append((cid, to_stamp(stamp), raw))

    def close(self):
        self._msgs.sort(key=lambda m: m[1])
        chunk = [p for c in self._conns for p in _conn_record(c)]
        size = sum(len(p) for p in chunk)
        msg_offsets = []
        for cid, st, raw in self._msgs:
            msg_offsets.append((cid, st, size))
            rec = _record({"op": bytes([OP_MSG]), "conn": _u32(cid), "time": _time(st)}, raw)
            chunk += rec
            size += sum(len(p) for p in rec)
        stamps = [st for _, st, _ in self._msgs] or [(0, 0)]

        # the bag header record, padded to 4096 bytes as rosbag does; its
        # index_pos is written once the chunk's size is known
        chunk_pos = len(_MAGIC) + 4096 + 8
        chunk_hdr = _build_header({"op": bytes([OP_CHUNK]), "compression": "none",
                                   "size": _u32(size)})
        chunk_rec = [_u32(len(chunk_hdr)), chunk_hdr, _u32(size)]
        index_pos = chunk_pos + sum(len(p) for p in chunk_rec) + size
        bag_hdr = _bag_header(index_pos, len(self._conns))
        pad = 4096 - len(_bag_header(0, len(self._conns)))
        out = [_MAGIC, _u32(len(bag_hdr) + pad), bag_hdr + b" " * pad, _u32(0)]
        out += chunk_rec + chunk
        # index records per connection
        for c in self._conns:
            entries = [(st, off) for cid, st, off in msg_offsets if cid == c.cid]
            data = b"".join(_time(st) + _u32(off) for st, off in entries)
            out += _record({"op": bytes([OP_INDEX]), "ver": _u32(1), "conn": _u32(c.cid),
                            "count": _u32(len(entries))}, data)
        # connection records (post-chunk copies, as rosbag writes)
        for c in self._conns:
            out += _conn_record(c)
        # chunk info
        counts = b"".join(
            _u32(c.cid) + _u32(sum(1 for cid, _, _ in msg_offsets if cid == c.cid))
            for c in self._conns
        )
        out += _record({"op": bytes([OP_CHUNK_INFO]), "ver": _u32(1),
                        "chunk_pos": _u64(chunk_pos), "start_time": _time(stamps[0]),
                        "end_time": _time(stamps[-1]), "count": _u32(len(self._conns))},
                       counts)
        with open(self.path, "wb") as f:
            for part in out:
                f.write(part)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Message codecs (binary layout, little endian)
# ---------------------------------------------------------------------------


def _read_string(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4 : off + 4 + n].decode(), off + 4 + n


def _pack_string(s: str) -> bytes:
    b = s.encode()
    return _u32(len(b)) + b


def _read_rosheader(buf, off):
    """std_msgs/Header: seq u32, stamp (sec,nsec), frame_id string."""
    seq, sec, nsec = struct.unpack_from("<III", buf, off)
    frame_id, off = _read_string(buf, off + 12)
    return {"seq": seq, "stamp": from_stamp(sec, nsec), "frame_id": frame_id}, off


def _pack_rosheader(seq, stamp, frame_id) -> bytes:
    sec, nsec = to_stamp(stamp)
    return struct.pack("<III", seq, sec, nsec) + _pack_string(frame_id)


_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}
_PF_CODES = {v: k for k, v in _PF_DTYPES.items()}


def decode_pointcloud2(raw: bytes):
    """sensor_msgs/PointCloud2 -> (structured array, header dict)."""
    hdr, off = _read_rosheader(raw, 0)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", raw, off)
    off += 4
    fields = []
    for _ in range(n_fields):
        name, off = _read_string(raw, off)
        foff, dtype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append((name, foff, dtype, count))
    is_bigendian = raw[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", raw, off)
    off += 8
    (data_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    data = raw[off : off + data_len]
    fields = sorted(fields, key=lambda x: x[1])
    order = ">" if is_bigendian else "<"
    # one element per field whatever its count (as the JAX decoder reads
    # it); the point step as itemsize keeps any padding between points
    dt = np.dtype(
        {
            "names": [f[0] for f in fields],
            "formats": [order + _PF_DTYPES[f[2]] for f in fields],
            "offsets": [f[1] for f in fields],
            "itemsize": point_step,
        }
    )
    arr = np.frombuffer(data, dtype=dt, count=height * width)
    return arr.copy(), hdr


def encode_pointcloud2(cloud: np.ndarray, stamp: float, frame_id="lidar",
                       seq=0) -> bytes:
    """Structured array (flat fields) -> sensor_msgs/PointCloud2."""
    names = cloud.dtype.names
    out = [_pack_rosheader(seq, stamp, frame_id), struct.pack("<II", 1, len(cloud)),
           _u32(len(names))]  # height=1, width=n
    for name in names:
        dt, foff = cloud.dtype.fields[name]
        out.append(_pack_string(name))
        out.append(struct.pack("<IBI", foff, _PF_CODES[dt.base.str[1:]], 1))
    out.append(bytes([0]))  # little endian
    point_step = cloud.dtype.itemsize
    out.append(struct.pack("<II", point_step, point_step * len(cloud)))
    body = cloud.tobytes()
    out += [_u32(len(body)), body, bytes([1])]  # is_dense
    return b"".join(out)


def decode_imu(raw: bytes):
    hdr, off = _read_rosheader(raw, 0)
    vals = struct.unpack_from("<" + "d" * (4 + 9 + 3 + 9 + 3 + 9), raw, off)
    return {
        "header": hdr,
        "orientation": np.array(vals[0:4]),  # x y z w
        "angular_velocity": np.array(vals[13:16]),
        "linear_acceleration": np.array(vals[25:28]),
    }


def encode_imu(stamp: float, gyro, accel, frame_id="imu", seq=0) -> bytes:
    out = _pack_rosheader(seq, stamp, frame_id)
    vals = [0.0, 0.0, 0.0, 1.0] + [0.0] * 9
    vals += list(gyro) + [0.0] * 9
    vals += list(accel) + [0.0] * 9
    return out + struct.pack("<" + "d" * len(vals), *vals)


def decode_navsatfix(raw: bytes):
    hdr, off = _read_rosheader(raw, 0)
    status, service = struct.unpack_from("<bH", raw, off)
    off += 3
    lat, lon, alt = struct.unpack_from("<ddd", raw, off)
    off += 24
    cov = np.frombuffer(raw, dtype="<f8", count=9, offset=off)
    off += 72
    cov_type = raw[off]
    return {
        "header": hdr, "status": status, "latitude": lat, "longitude": lon,
        "altitude": alt, "position_covariance": cov.reshape(3, 3),
        "covariance_type": cov_type,
    }


def encode_navsatfix(stamp: float, lat, lon, alt, cov_diag=(1.0, 1.0, 4.0),
                     status=0, frame_id="gps", seq=0) -> bytes:
    cov = np.zeros((3, 3))
    np.fill_diagonal(cov, cov_diag)
    return b"".join([
        _pack_rosheader(seq, stamp, frame_id), struct.pack("<bH", status, 1),
        struct.pack("<ddd", lat, lon, alt), cov.astype("<f8").tobytes(),
        bytes([2]),  # COVARIANCE_TYPE_DIAGONAL_KNOWN
    ])


def decode_odometry(raw: bytes):
    hdr, off = _read_rosheader(raw, 0)
    child, off = _read_string(raw, off)
    pose = struct.unpack_from("<" + "d" * 7, raw, off)
    off += 56 + 36 * 8
    twist = struct.unpack_from("<" + "d" * 6, raw, off)
    return {
        "header": hdr, "child_frame_id": child,
        "position": np.array(pose[0:3]),
        "orientation": np.array(pose[3:7]),  # x y z w
        "linear": np.array(twist[0:3]), "angular": np.array(twist[3:6]),
    }


def decode_compressed_image(raw: bytes):
    hdr, off = _read_rosheader(raw, 0)
    fmt, off = _read_string(raw, off)
    (n,) = struct.unpack_from("<I", raw, off)
    return {"header": hdr, "format": fmt, "data": raw[off + 4 : off + 4 + n]}


def decode_string(raw: bytes):
    s, _ = _read_string(raw, 0)
    return s


def encode_string(s: str) -> bytes:
    return _pack_string(s)


_LIVOX_POINT = np.dtype([
    ("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"),
])


def decode_livox_custommsg(raw: bytes):
    """livox_ros_driver/CustomMsg: header, timebase u64, point_num u32,
    lidar_id u8, rsvd u8[3], points[] of CustomPoint
    (offset_time u32, x f32, y f32, z f32, reflectivity u8, tag u8, line u8).
    """
    hdr, off = _read_rosheader(raw, 0)
    timebase, point_num = struct.unpack_from("<QI", raw, off)
    off += 12
    lidar_id = raw[off]
    off += 4  # id + 3 reserved
    (n,) = struct.unpack_from("<I", raw, off)
    off += 4
    pts = np.frombuffer(raw, dtype=_LIVOX_POINT, count=n, offset=off)
    return {
        "header": hdr, "timebase": timebase, "point_num": point_num,
        "lidar_id": lidar_id, "points": pts.copy(),
    }


DECODERS = {
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "sensor_msgs/Imu": decode_imu,
    "sensor_msgs/NavSatFix": decode_navsatfix,
    "sensor_msgs/CompressedImage": decode_compressed_image,
    "nav_msgs/Odometry": decode_odometry,
    "std_msgs/String": decode_string,
    "livox_ros_driver/CustomMsg": decode_livox_custommsg,
}


def split_bag(in_path: str, out_pattern: str, segment_seconds: float,
              overlap_seconds: float = 0.0) -> list[str]:
    """Split a bag into time segments (the `split_bag.py` /
    `split_rosbag_overlapping.py` capability). ``out_pattern`` must contain
    ``{i}``. Returns written paths."""
    msgs = list(BagReader(in_path))
    if not msgs:
        return []
    t0 = min(m.stamp for m in msgs)
    t1 = max(m.stamp for m in msgs)
    out_paths = []
    i = 0
    start = t0
    while start < t1:
        end = start + segment_seconds
        seg = [m for m in msgs if start <= m.stamp < end]
        if seg:
            path = out_pattern.format(i=i)
            with BagWriter(path) as w:
                for m in seg:
                    w.write(m.topic, m.msg_type, m.stamp, m.raw)
            out_paths.append(path)
        i += 1
        start = end - overlap_seconds
    return out_paths
