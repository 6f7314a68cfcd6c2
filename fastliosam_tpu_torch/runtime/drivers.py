"""Dataset drive loops (port of ``fastliosam_tpu/runtime/drivers.py``):
stream a KITTI odometry sequence through a :class:`SlamEngine` with the
chunked one-read-per-chunk path and overlapped decode.

Three mechanisms keep the host ahead of the device, as in the JAX package:

* the chunk's .bin files are decoded by the native threaded reader
  (``io/native.py: read_bins_q16`` -> ``native/fls_native.cpp``);
* only xyz crosses the host->device link: sweep-time synthesis, the int16
  upcast and the padding mask are computed on the device (:func:`_prep`);
* the engine runs the deferred pipeline
  (``SlamEngine.process_chunk_deferred``): chunk k dispatches, then chunk
  k-1 resolves while the staging thread decodes and uploads chunk k+1.

:func:`kitti_stager` is the staging step alone, so a caller can drive any
span of a sequence through the same code.
"""
from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..io import KittiSequence
from ..io.native import read_bins, read_bins_q16
from ..odom import ImuBatch, Scan
from ..utils.device import upload as _upload

# XLA compiles the JAX drive_kitti's (pi - az) / (2 pi) * 0.1 as one multiply by
# the folded float32 constant; the same constant gives the same bits
_SWEEP_SCALE = np.float32(1.0 / (2.0 * math.pi)) * np.float32(0.1)


def _prep(xyz, counts, quant_scale: float):
    """Device-side scan prep of a staged chunk: ``xyz (S, cap, 3)`` int16
    fixed point (or float32) and ``counts (S,)`` -> float32 xyz with 1e6 in
    the padding lanes, per-point sweep times from the azimuth (the
    clockwise sweep of ``io/kitti.py: _azimuth_time_offsets``) and the
    mask, bit for bit as the JAX package's ``drive_kitti`` makes them."""
    cap = xyz.shape[1]
    mask = torch.arange(cap, device=xyz.device)[None, :] < counts[:, None]
    if xyz.dtype == torch.int16:
        xyz = xyz.to(torch.float32) * np.float32(quant_scale)
    az = torch.atan2(xyz[..., 1], xyz[..., 0])
    toff = (np.float32(math.pi) - az) * _SWEEP_SCALE
    toff = torch.where(mask, toff, 0.0)
    xyz = torch.where(mask[..., None], xyz, 1.0e6)
    return xyz, toff, mask


def kitti_stager(engine, seq_obj: KittiSequence, scan_capacity: int, chunk: int,
                 upload_mode: str = "q16", quant_scale: float = 1.0 / 256.0):
    """The staging step of :func:`drive_kitti`: returns ``stage(c0, n) ->
    (Scan, ImuBatch, stamps)`` for scans ``[c0, c0 + n)``, padded to
    ``chunk`` with empty scans, on the engine's device.

    ``upload_mode="q16"`` applies the engine's preprocess filters
    (point_filter_num stride, blind, det_range) in the native reader and
    ships int16 fixed-point xyz; the engine's ``odom_cfg`` then gets
    ``point_filter_num=1`` (the reader already strided the raw ray order).
    The engine derives nothing from that field at construction, so
    replacing the config is all the JAX ``drive_kitti``'s ``_build_programs()``
    call does here. ``"f32"`` ships the raw float xyz."""
    dev = engine.device
    cap = scan_capacity
    if upload_mode not in ("q16", "f32"):
        raise ValueError(f"upload must be 'q16' or 'f32', got {upload_mode!r}")
    if upload_mode == "q16":
        pfn = int(engine.odom_cfg.point_filter_num)
        blind = float(engine.odom_cfg.blind)
        det = float(engine.odom_cfg.det_range)
        # widen the fixed-point span to cover det_range (clamped coords
        # would corrupt far geometry otherwise)
        quant_scale = max(quant_scale, det / 32000.0)
        if pfn > 1:
            engine.odom_cfg = engine.odom_cfg._replace(point_filter_num=1)
    imu_cap = 8
    empty_imu = ImuBatch(
        stamps=torch.full((chunk, imu_cap), 1e9, dtype=torch.float32, device=dev),
        gyro=torch.zeros((chunk, imu_cap, 3), dtype=torch.float32, device=dev),
        acc=torch.zeros((chunk, imu_cap, 3), dtype=torch.float32, device=dev),
        mask=torch.zeros((chunk, imu_cap), dtype=torch.bool, device=dev),
    )

    def stage(c0: int, n: int):
        """Decode + asynchronous host->device upload of scans [c0, c0+n)."""
        paths = [os.path.join(seq_obj.velo_dir, seq_obj.files[c0 + i]) for i in range(n)]
        if upload_mode == "q16":
            host_xyz, counts = read_bins_q16(paths, cap, stride=pfn, blind=blind,
                                             max_range=det, scale=quant_scale)
            if n < chunk:  # pad the tail chunk with empty scans
                host_xyz = np.concatenate(
                    [host_xyz, np.zeros((chunk - n, cap, 3), np.int16)], axis=0)
            dtype = torch.int16
        else:
            raw, counts = read_bins(paths, cap)  # native thread pool
            if n < chunk:
                raw = np.concatenate(
                    [raw, np.full((chunk - n, cap, 4), 1.0e6, np.float32)], axis=0)
            host_xyz = np.ascontiguousarray(raw[:, :, :3])
            dtype = torch.float32
        if n < chunk:
            counts = np.concatenate([counts, np.zeros(chunk - n, np.int32)])
        xyz, toff, mask = _prep(_upload(host_xyz, dev, dtype),
                                _upload(counts.astype(np.int32), dev, torch.int32),
                                quant_scale)
        stamps = np.asarray(seq_obj.times[c0: c0 + n], np.float64)
        if n < chunk:
            stamps = np.concatenate([stamps, np.full(chunk - n, stamps[-1])])
        return Scan(xyz=xyz, t_offset=toff, mask=mask), empty_imu, stamps

    return stage


def drive_kitti(engine, root: str, seq: str = "00", scan_capacity: int = 65536,
                chunk: int = 5, n_scans: int | None = None, progress=True,
                upload: str = "q16", quant_scale: float = 1.0 / 256.0):
    """Run a KITTI odometry sequence through the engine (native threaded
    reader + overlapped staging + deferred chunked engine path). Returns a
    dict with throughput and, when ground truth exists, ATE/RPE of the
    realtime trajectory and the keyframe-pose ATE.

    ``upload="q16"`` (the default) filters and quantizes in the reader
    (:func:`kitti_stager`); ``"f32"`` uploads the raw floats. KITTI
    odometry carries no IMU: the engine runs LiDAR-only (coordinated-turn
    propagation, ``odom/pipeline.py``)."""
    seq_obj = KittiSequence(root, seq)
    S = len(seq_obj) if n_scans is None else min(n_scans, len(seq_obj))
    stage = kitti_stager(engine, seq_obj, scan_capacity, chunk, upload, quant_scale)

    dts = np.diff(np.asarray(seq_obj.times[:S], np.float64))
    dt = float(np.median(dts)) if len(dts) else 0.1

    pool = ThreadPoolExecutor(max_workers=1)
    t0 = time.perf_counter()
    fut = pool.submit(stage, 0, min(chunk, S))
    c = 0
    try:
        while c < S:
            scans, imus, stamps = fut.result()
            if c + chunk < S:
                # chunk k+1 decodes and uploads on the staging thread while
                # the deferred engine path resolves chunk k-1 below (the
                # native reader and the copies release the GIL)
                fut = pool.submit(stage, c + chunk, min(chunk, S - c - chunk))
            engine.process_chunk_deferred(scans, imus, stamps, dt)
            c += chunk  # padded tail scans are dropped from the metrics below
            if progress and (c // chunk) % 20 == 0:
                print(f"  scan {c}/{S}", flush=True)
        engine.finish()
    finally:
        pool.shutdown(wait=False)
    elapsed = time.perf_counter() - t0

    out = {
        "n_scans": S,
        "scans_per_sec": round(S / elapsed, 2),
        "n_keyframes": engine.kf.n,
        "n_loops": len(engine.loop_pairs),
        "n_solves": engine.solve_count,
    }
    gt = seq_obj.gt_poses()
    if gt is not None:
        from ..eval import align_umeyama

        # the filter runs in its own odometry frame (the first body frame):
        # rigidly align to the sequence frame before ATE (no scale)
        est = np.stack(engine.realtime_traj)[:S, :3, 3]
        g = gt[:S, :3, 3]
        _, R, t = align_umeyama(est, g)
        est = est @ R.T + t
        out["ate_m"] = round(float(np.sqrt(np.mean(np.sum((est - g) ** 2, axis=1)))), 4)
        d = max(1, int(round(1.0 / dt)))
        rel = (est[d:] - est[:-d]) - (g[d:] - g[:-d])
        out["rpe_1s_m"] = round(float(np.sqrt(np.mean(np.sum(rel ** 2, axis=1)))), 4)
        # final keyframe-pose ATE, the map-quality metric: the realtime
        # trajectory above is causal (past scans keep their pre-correction
        # poses), so judge loop closure by this one
        n = engine.kf.n
        if n > 2:
            times = np.asarray(seq_obj.times[:S], np.float64)
            kf_st = engine.keyframe_stamps().astype(np.float64)
            idx = np.clip(np.searchsorted(times, kf_st), 0, len(times) - 1)
            kf_est = engine.keyframe_poses()[:, :3, 3]
            kf_gt = gt[idx][:, :3, 3]
            _, Rk, tk = align_umeyama(kf_est, kf_gt)
            kf_est = kf_est @ Rk.T + tk
            out["kf_ate_m"] = round(
                float(np.sqrt(np.mean(np.sum((kf_est - kf_gt) ** 2, axis=1)))), 4)
    return out
