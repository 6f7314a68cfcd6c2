"""PCD v0.7 codec: read/write ascii + binary, preserving all fields.

Capability equivalent of the manual PCD parsing in the reference's
post-processing tools (`post_process/merge_pcds.py:6-120`,
`georeference_pcd.py:28-51`) and of the PCL-based map export
(`fast_lio_sam.cpp:929-935`). Structured numpy arrays carry arbitrary
fields (x, y, z, intensity, rgb, ...) unchanged through transforms.

The port's own numpy copy of ``fastliosam_tpu/io/pcd.py``.
"""
from __future__ import annotations

import numpy as np

_PCD_TO_NP = {
    ("F", 4): "f4",
    ("F", 8): "f8",
    ("I", 1): "i1",
    ("I", 2): "i2",
    ("I", 4): "i4",
    ("U", 1): "u1",
    ("U", 2): "u2",
    ("U", 4): "u4",
}
_NP_TO_PCD = {v: k for k, v in _PCD_TO_NP.items()}


# ---------------------------------------------------------------------------
# LZF block codec (libLZF stream format) — what PCL's binary_compressed PCD
# bodies use (`pcl/io/lzf.cpp`). Pure Python: runs process whole literal
# runs / back-references per iteration, so throughput is fine for map-sized
# files and there is no native dependency.
# ---------------------------------------------------------------------------


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Decompress a libLZF stream. Raises ValueError on malformed input."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            if i + run > n:
                raise ValueError("lzf: truncated literal run")
            out += data[i : i + run]
            i += run
        else:  # back-reference
            length = ctrl >> 5
            if length == 7:
                if i >= n:
                    raise ValueError("lzf: truncated length byte")
                length += data[i]
                i += 1
            if i >= n:
                raise ValueError("lzf: truncated offset byte")
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("lzf: back-reference before start")
            # overlapping copies are defined byte-serially (RLE-style)
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected_size:
        raise ValueError(
            f"lzf: expected {expected_size} bytes, got {len(out)}"
        )
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """Compress with the libLZF scheme (3-byte hash chaining, back-refs up
    to 264 long / 8192 back). Output decodes with any LZF decoder incl.
    PCL's; on incompressible input it degrades to literal runs (~3%
    overhead)."""
    n = len(data)
    out = bytearray()
    htab: dict = {}
    lit_start = 0  # start of the pending literal run
    i = 0

    def flush_literals(upto):
        s = lit_start
        while s < upto:
            run = min(32, upto - s)
            out.append(run - 1)
            out.extend(data[s : s + run])
            s += run

    while i < n - 2:
        key = data[i : i + 3]
        ref = htab.get(key, -1)
        htab[key] = i
        off = i - ref - 1
        if ref >= 0 and off < 8192:
            # extend the match
            maxlen = min(n - i, 264)
            length = 3
            while length < maxlen and data[ref + length] == data[i + length]:
                length += 1
            flush_literals(i)
            lencode = length - 2
            if lencode < 7:
                out.append((lencode << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(lencode - 7)
            out.append(off & 0xFF)
            # seed the hash table through the match (sparse: every 2nd)
            end = i + length
            i += 1
            while i < min(end, n - 2):
                htab[data[i : i + 3]] = i
                i += 2
            i = end
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file into a structured numpy array (one entry per field)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_pts = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        np_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _PCD_TO_NP[(t, s)]
            if c == 1:
                np_fields.append((name, base))
            else:
                np_fields.append((name, base, (c,)))
        dtype = np.dtype(np_fields)

        if mode == "binary":
            buf = f.read(n_pts * dtype.itemsize)
            return np.frombuffer(buf, dtype=dtype, count=n_pts).copy()
        if mode == "ascii":
            raw = np.loadtxt(f, max_rows=n_pts, ndmin=2)
            out = np.zeros(n_pts, dtype=dtype)
            col = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                if c == 1:
                    out[name] = raw[:, col].astype(out[name].dtype)
                else:
                    out[name] = raw[:, col : col + c].astype(out[name].dtype)
                col += c
            return out
        if mode == "binary_compressed":
            # PCL layout (`pcl/io/pcd_io.cpp`): u32 compressed_size,
            # u32 uncompressed_size, LZF stream; the uncompressed body is
            # FIELD-MAJOR (all x values, then all y values, ...), unlike
            # DATA binary's point-major records.
            import struct

            csize, usize = struct.unpack("<II", f.read(8))
            body = lzf_decompress(f.read(csize), usize)
            out = np.zeros(n_pts, dtype=dtype)
            off = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                nbytes = s * c * n_pts
                col = np.frombuffer(
                    body, dtype=_PCD_TO_NP[(t, s)],
                    count=n_pts * c, offset=off,
                )
                out[name] = col.reshape(n_pts, c) if c > 1 else col
                off += nbytes
            return out
        raise ValueError(f"unknown PCD DATA mode: {mode}")


def write_pcd(path: str, cloud: np.ndarray, binary: bool = True,
              compressed: bool = False) -> None:
    """Write a structured array (or plain (N,3) float array) as PCD.
    ``compressed=True`` writes PCL's ``binary_compressed`` mode (LZF over
    the field-major body)."""
    if cloud.dtype.names is None:
        arr = np.zeros(
            len(cloud), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")]
        )
        arr["x"], arr["y"], arr["z"] = (
            cloud[:, 0],
            cloud[:, 1],
            cloud[:, 2],
        )
        cloud = arr
    names = cloud.dtype.names
    sizes, types, counts = [], [], []
    for name in names:
        dt, shape = cloud.dtype.fields[name][0], cloud.dtype.fields[name][0].shape
        base = dt.base
        t, s = _NP_TO_PCD[base.str[1:]]
        c = int(np.prod(dt.shape)) if dt.shape else 1
        types.append(t)
        sizes.append(str(s))
        counts.append(str(c))
    n = len(cloud)
    mode = (
        "binary_compressed" if compressed
        else ("binary" if binary else "ascii")
    )
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(counts)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {mode}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            import struct

            body = b"".join(
                np.ascontiguousarray(cloud[name]).tobytes() for name in names
            )
            comp = lzf_compress(body)
            f.write(struct.pack("<II", len(comp), len(body)))
            f.write(comp)
        elif binary:
            f.write(cloud.tobytes())
        else:
            cols = []
            for name in names:
                v = cloud[name]
                cols.append(v.reshape(n, -1))
            np.savetxt(f, np.hstack(cols), fmt="%.6f")


def xyz_of(cloud: np.ndarray) -> np.ndarray:
    """Extract an (N, 3) float view of a structured cloud."""
    return np.column_stack(
        [cloud["x"].astype(np.float64), cloud["y"].astype(np.float64),
         cloud["z"].astype(np.float64)]
    )


def with_xyz(cloud: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """Return a copy with x/y/z replaced (all other fields preserved) —
    the `georeference_pcd.py` / `transform_pcd.py` capability."""
    out = cloud.copy()
    out["x"] = xyz[:, 0].astype(out["x"].dtype)
    out["y"] = xyz[:, 1].astype(out["y"].dtype)
    out["z"] = xyz[:, 2].astype(out["z"].dtype)
    return out
