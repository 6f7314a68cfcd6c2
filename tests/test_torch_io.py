"""The port's dataset readers and writers (``fastliosam_tpu_torch/io``,
``postprocess/viewer3d.py``) against the JAX package's on the same files.

Both are numpy code: files written by the two packages must be equal byte
for byte and arrays read back equal exactly, the native reader and its
numpy fallback included (the native library is built by each package from
the same ``native/fls_native.cpp``).
"""
import struct

import numpy as np
import pytest

from fastliosam_tpu import io as jio
from fastliosam_tpu.io import kitti as jkitti
from fastliosam_tpu.io import native as jnative
from fastliosam_tpu.io import pcd as jpcd
from fastliosam_tpu.io import poses as jposes
from fastliosam_tpu.postprocess import viewer3d as jviewer
from fastliosam_tpu_torch import io as tio
from fastliosam_tpu_torch.io import kitti as tkitti
from fastliosam_tpu_torch.io import native as tnative
from fastliosam_tpu_torch.io import pcd as tpcd
from fastliosam_tpu_torch.io import poses as tposes
from fastliosam_tpu_torch.postprocess import viewer3d as tviewer


def _poses(rng, n):
    out = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        a = rng.uniform(-np.pi, np.pi)
        out[k, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        out[k, :3, 3] = rng.normal(size=3) * 10
    return out.astype(np.float32)


def test_io_exports_match():
    names = ("read_pcd", "write_pcd", "read_kitti_poses", "read_tum_trajectory",
             "write_kitti_poses", "write_tum_trajectory", "unix_to_readable",
             "KittiSequence", "GenericSequence")
    for name in names:
        assert hasattr(tio, name) and hasattr(jio, name)


@pytest.mark.parametrize("fmt", ["kitti", "tum", "tum_readable"])
def test_pose_files_equal(tmp_path, fmt):
    rng = np.random.default_rng(1)
    poses = _poses(rng, 7)
    stamps = 1.6e9 + np.arange(7) * 0.1
    for pkg, mod in (("jax", jposes), ("port", tposes)):
        p = tmp_path / f"{pkg}.txt"
        if fmt == "kitti":
            mod.write_kitti_poses(str(p), poses)
        else:
            mod.write_tum_trajectory(str(p), stamps, poses, readable_stamps=(fmt == "tum_readable"))
    assert (tmp_path / "jax.txt").read_bytes() == (tmp_path / "port.txt").read_bytes()
    p = str(tmp_path / "jax.txt")
    if fmt == "kitti":
        np.testing.assert_array_equal(tposes.read_kitti_poses(p), jposes.read_kitti_poses(p))
    elif fmt == "tum":
        for a, b in zip(tposes.read_tum_trajectory(p), jposes.read_tum_trajectory(p)):
            np.testing.assert_array_equal(a, b)
    assert tposes.unix_to_readable(stamps[3]) == jposes.unix_to_readable(stamps[3])


def _cloud(rng, n=300):
    c = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
                           ("ring", "<u2")])
    for f in ("x", "y", "z"):
        c[f] = rng.normal(size=n) * 20
    c["intensity"] = rng.uniform(0, 255, n)
    c["ring"] = rng.integers(0, 64, n)
    return c


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed", "plain_xyz"])
def test_pcd_files_equal(tmp_path, mode):
    rng = np.random.default_rng(2)
    cloud = _cloud(rng)
    if mode == "plain_xyz":
        cloud = np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=1)
    kw = dict(binary=mode != "ascii", compressed=mode == "binary_compressed")
    jpcd.write_pcd(str(tmp_path / "j.pcd"), cloud, **kw)
    tpcd.write_pcd(str(tmp_path / "t.pcd"), cloud, **kw)
    assert (tmp_path / "j.pcd").read_bytes() == (tmp_path / "t.pcd").read_bytes()
    a, b = tpcd.read_pcd(str(tmp_path / "j.pcd")), jpcd.read_pcd(str(tmp_path / "j.pcd"))
    assert a.dtype == b.dtype
    for name in a.dtype.names:
        np.testing.assert_array_equal(a[name], b[name])
    np.testing.assert_array_equal(tpcd.xyz_of(a), jpcd.xyz_of(b))


def test_pcd_compressed_golden_and_lzf(tmp_path):
    """The hand-built binary_compressed PCD of tests/test_golden_io.py and
    LZF streams: the port decodes what the JAX package decodes."""
    xs = np.asarray([1.0, 2.0, 3.0], "<f4")
    body = xs.tobytes() + (-xs).tobytes() + (10 * xs).tobytes()
    comp = bytes([31]) + body[:32] + bytes([3]) + body[32:]
    hdr = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
           "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
           "WIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 3\nDATA binary_compressed\n")
    p = tmp_path / "golden.pcd"
    p.write_bytes(hdr.encode() + struct.pack("<II", len(comp), len(body)) + comp)
    a, b = tpcd.read_pcd(str(p)), jpcd.read_pcd(str(p))
    for name in ("x", "y", "z"):
        np.testing.assert_array_equal(a[name], b[name])
    rng = np.random.default_rng(0)
    for data in (b"", b"abcabcabcabcabc" * 40, rng.integers(0, 4, 5000).astype(np.uint8).tobytes()):
        c = tpcd.lzf_compress(data)
        assert c == jpcd.lzf_compress(data)
        assert tpcd.lzf_decompress(c, len(data)) == data


def _kitti_fixture(root, rng, n=4):
    seq_dir = root / "sequences" / "07"
    velo = seq_dir / "velodyne"
    velo.mkdir(parents=True)
    for i in range(n):
        (rng.normal(size=(500 + 10 * i, 4)) * 15).astype(np.float32).tofile(velo / f"{i:06d}.bin")
    np.savetxt(seq_dir / "times.txt", np.arange(n) * 0.1 + 0.05)
    (seq_dir / "calib.txt").write_text(
        "P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 0 -1 0 0.1 0 0 -1 0.2 1 0 0 0.3\nbad: 1 2\n")
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "07.txt", _poses(rng, n)[:, :3, :].reshape(n, 12))
    oxts = root / "oxts"
    oxts.mkdir()
    for i in range(3):
        np.savetxt(oxts / f"{i:010d}.txt", rng.normal(size=(1, 30)))
    return [str(velo / f"{i:06d}.bin") for i in range(n)]


def test_kitti_sequence_equal(tmp_path):
    rng = np.random.default_rng(3)
    _kitti_fixture(tmp_path, rng)
    a, b = tkitti.KittiSequence(str(tmp_path), "07"), jkitti.KittiSequence(str(tmp_path), "07")
    assert len(a) == len(b) == 4 and a.files == b.files
    np.testing.assert_array_equal(a.times, b.times)
    assert a.calib.keys() == b.calib.keys() == {"P0", "Tr"}
    for k in a.calib:
        np.testing.assert_array_equal(a.calib[k], b.calib[k])
    for i in range(len(a)):
        for x, y in zip(a.scan(i), b.scan(i)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.gt_poses(), b.gt_poses())
    xyz = a.scan(2)[0]
    np.testing.assert_array_equal(tkitti._azimuth_time_offsets(xyz, 0.05),
                                  jkitti._azimuth_time_offsets(xyz, 0.05))
    ta, tb = tkitti.read_oxts(str(tmp_path / "oxts")), jkitti.read_oxts(str(tmp_path / "oxts"))
    assert ta.keys() == tb.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k])


def test_generic_sequence_equal(tmp_path):
    rng = np.random.default_rng(4)
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    c = _cloud(rng, 200)
    jpcd.write_pcd(str(clouds / "100.000000.pcd"), c)
    jpcd.write_pcd(str(clouds / "100.100000.pcd"),
                   np.stack([c["x"], c["y"], c["z"]], axis=1), compressed=True)
    (rng.normal(size=(150, 4)) * 9).astype(np.float32).tofile(clouds / "100.200000.bin")
    imu = np.column_stack([100.0 + np.arange(60) * 0.005, rng.normal(size=(60, 6))])
    np.savetxt(tmp_path / "imu.txt", imu)
    np.savetxt(tmp_path / "gnss.txt", np.column_stack(
        [100.0 + np.arange(3) * 0.1, 22.3 + rng.normal(size=3) * 1e-5,
         114.1 + rng.normal(size=3) * 1e-5, rng.normal(size=3), np.ones((3, 3))]))
    a = tio.GenericSequence(str(tmp_path))
    b = jio.GenericSequence(str(tmp_path))
    assert len(a) == len(b) == 3 and a.files == b.files
    np.testing.assert_array_equal(a.stamps, b.stamps)
    for i in range(3):
        for x, y in zip(a.scan(i), b.scan(i)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a.imu_between(100.02, 100.1), b.imu_between(100.02, 100.1)):
        np.testing.assert_array_equal(x, y)
    assert a.gnss_between(99.0, 100.15) == b.gnss_between(99.0, 100.15)
    assert len(a.gnss_between(99.0, 100.15)) == 2


@pytest.fixture
def bins(tmp_path):
    rng = np.random.default_rng(5)
    return _kitti_fixture(tmp_path, rng, n=5)


@pytest.fixture(params=["native", "numpy"])
def reader_mode(request, monkeypatch):
    """Both packages' readers through the native library, or both through
    their numpy fallbacks."""
    if request.param == "native":
        assert tnative.native_available() and jnative.native_available()
    else:
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    return request.param


def test_port_native_library_built_under_build(reader_mode):
    if reader_mode == "native":
        assert tnative._SO.endswith("build/native/libfls_native.so")
        assert tnative._load()._name == tnative._SO


@pytest.mark.parametrize("stride,blind,max_range,cap", [(1, 0.0, 0.0, 600), (3, 2.0, 25.0, 256),
                                                        (2, 1.0, 60.0, 64)])
def test_read_bins_q16_equal(bins, reader_mode, stride, blind, max_range, cap):
    kw = dict(stride=stride, blind=blind, max_range=max_range, scale=1.0 / 256.0)
    qa, na = tnative.read_bins_q16(bins, cap, **kw)
    qb, nb = jnative.read_bins_q16(bins, cap, **kw)
    np.testing.assert_array_equal(na, nb)
    for i, n in enumerate(na):  # pad lanes are zero in both, by contract
        np.testing.assert_array_equal(qa[i, :n], qb[i, :n])
        assert not qa[i, n:].any() and not qb[i, n:].any()


def test_read_bins_q16_native_equals_numpy(bins, monkeypatch):
    """The port's native decode equals its own numpy fallback."""
    kw = dict(stride=2, blind=1.5, max_range=30.0, scale=1.0 / 256.0)
    q_nat, n_nat = tnative.read_bins_q16(bins, 512, **kw)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    q_np, n_np = tnative.read_bins_q16(bins, 512, **kw)
    np.testing.assert_array_equal(n_nat, n_np)
    for i, n in enumerate(n_nat):
        np.testing.assert_array_equal(q_nat[i, :n], q_np[i, :n])


def test_read_bins_and_prefetch_equal(bins, reader_mode):
    for cap in (400, 1000):
        a, na = tnative.read_bins(bins, cap)
        b, nb = jnative.read_bins(bins, cap)
        np.testing.assert_array_equal(na, nb)
        for i, n in enumerate(na):
            np.testing.assert_array_equal(a[i, :n], b[i, :n])
            np.testing.assert_array_equal(a[i, n:, :3], 1e6)
        x, n = tnative.read_bin(bins[1], cap)
        y, m = jnative.read_bin(bins[1], cap)
        assert n == m
        np.testing.assert_array_equal(x[:n], y[:n])
    pa, pb = tnative.ScanPrefetcher(bins, 600), jnative.ScanPrefetcher(bins, 600)
    got = [(o[:n].copy(), n) for o, n in pa]
    want = [(o[:n].copy(), n) for o, n in pb]
    pa.close()
    pb.close()
    assert [n for _, n in got] == [n for _, n in want] and len(got) == len(bins)
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_read_pcd_xyz_equal(tmp_path, reader_mode):
    rng = np.random.default_rng(6)
    c = _cloud(rng, 120)
    for compressed in (False, True):
        p = str(tmp_path / f"c{int(compressed)}.pcd")
        jpcd.write_pcd(p, c, compressed=compressed)
        a, n = tnative.read_pcd_xyz(p, 128)
        b, m = jnative.read_pcd_xyz(p, 128)
        assert n == m == 120
        np.testing.assert_array_equal(a[:n], b[:n])


def test_map_viewer_equal(tmp_path):
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(5000, 3)) * 10).astype(np.float32)
    traj = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    kw = dict(trajectory=traj, loop_pairs=[(30, 2), (39, 5)], title="parity")
    jviewer.write_map_viewer(str(tmp_path / "j.html"), pts, **kw)
    tviewer.write_map_viewer(str(tmp_path / "t.html"), pts, **kw)
    assert (tmp_path / "j.html").read_bytes() == (tmp_path / "t.html").read_bytes()
