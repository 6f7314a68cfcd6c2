"""Device time of short CUDA calls.

A call whose kernels take a few microseconds costs the host more than that
to enqueue, so timing back-to-back calls with CUDA events measures the
host. :func:`device_ms` first parks the stream on a spin kernel long enough
for the host to enqueue every call, then records the events: the device
runs the calls back to back and the events see only device time.
"""
from __future__ import annotations

import time

import torch

_CLOCK_HZ = 2.0e9  # a little above the H100's top SM clock: the spin errs long


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
