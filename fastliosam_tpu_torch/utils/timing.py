"""Per-stage timing, colored logging, profiler traces and the device time
of short CUDA calls.

:class:`StageTimer` and :func:`colorize` are the port's copies of the JAX
package's (``fastliosam_tpu/utils/timing.py``): named stages accumulate
wall-time statistics and print a summary table, as the reference's
chrono spans and ROS_INFO color helper do (``fast_lio_sam.cpp:44-55,
539-545``). :func:`torch_trace` is the counterpart of ``jax_trace``: a
``torch.profiler`` trace around a block.

A call whose kernels take a few microseconds costs the host more than that
to enqueue, so timing back-to-back calls with CUDA events measures the
host. :func:`device_ms` first parks the stream on a spin kernel long enough
for the host to enqueue every call, then records the events: the device
runs the calls back to back and the events see only device time.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch

_CLOCK_HZ = 2.0e9  # a little above the H100's top SM clock: the spin errs long
_COLORS = {"red": 31, "green": 32, "yellow": 33, "blue": 34, "magenta": 35}


def colorize(text: str, color: str = "green") -> str:
    return f"\033[{_COLORS.get(color, 32)}m{text}\033[0m"


class StageTimer:
    """Accumulates wall-clock per named stage (host clock: a stage that
    launches CUDA work should end in ``torch.cuda.synchronize()``).

    >>> timer = StageTimer()
    >>> with timer("odometry"):
    ...     step()
    >>> print(timer.summary())
    """

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[stage].append(time.perf_counter() - t0)

    def stats(self):
        out = {}
        for stage, xs in self.samples.items():
            a = np.asarray(xs) * 1000.0
            out[stage] = {
                "count": len(a),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "total_s": float(a.sum() / 1000.0),
            }
        return out

    def summary(self) -> str:
        rows = [f"{'stage':<24}{'count':>7}{'mean ms':>10}{'p95 ms':>10}{'total s':>10}"]
        for stage, s in sorted(self.stats().items()):
            rows.append(
                f"{stage:<24}{s['count']:>7}{s['mean_ms']:>10.2f}"
                f"{s['p95_ms']:>10.2f}{s['total_s']:>10.2f}"
            )
        return "\n".join(rows)


@contextlib.contextmanager
def torch_trace(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace around a block and write it as
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto). Host operations are always traced; CUDA activity too on a
    CUDA ``device``. ``None`` means ``cuda`` and raises without CUDA, as
    every entry point does; ``device="cpu"`` traces the host only. Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from .device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (first card): every
    device number is written beside it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_events(prof) -> dict:
    """``{name: [count, ns]}`` of the device-side operations (kernels,
    copies, sets) that a finished ``torch.profiler`` run recorded, read from
    its raw events: ``key_averages()`` first builds an event tree in
    Python, seconds for the tens of thousands of launches of a traced
    window or a PCG solve."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for ev in prof.profiler.kineto_results.events():
        ns = ev.duration_ns()
        if ev.device_type() == cuda and ns > 0:
            rec = out.setdefault(ev.name(), [0, 0])
            rec[0] += 1
            rec[1] += ns
    return out


def device_activity(fn):
    """``(fn(), {"device_ops": n, "device_busy_ms": t})``: the device-side
    operations that one call of ``fn`` runs, and their summed device time,
    from ``torch.profiler`` tracing the card's activity only (recording
    host operations too costs tens of seconds over a long window). The
    queue is drained before and after."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = device_events(prof).values()
    return out, {"device_ops": sum(c for c, _ in events),
                 "device_busy_ms": sum(ns for _, ns in events) / 1e6}


def launch_floor_ms(blocks: int) -> float:
    """Device time of an empty kernel (``csrc/empty.cu``, ``blocks`` x 256
    threads), launched through ctypes as every kernel wrapper launches its
    kernel and timed as the kernels are (:func:`device_ms` over 10 calls):
    the least time a kernel can read there."""
    import ctypes

    from ..ops import build

    fn = build.load("empty").empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(blocks, 256, stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {err}")

    return device_ms(launch, [()] * 10)


def device_ms(fn, args_list, warmup: int = 2) -> float:
    """Mean device time of ``fn(*args)`` over the argument sets (one call
    each: fresh inputs per call where the sets differ)."""
    for _ in range(warmup):
        fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args_list[0])  # the host's enqueue time of one call
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_s = min(max(4.0 * enqueue_s * len(args_list), 1e-3), 2.0)
    torch.cuda._sleep(int(spin_s * _CLOCK_HZ))
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)
