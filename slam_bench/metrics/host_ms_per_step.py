"""The host's time (ms) to enqueue one ``odom_step_batched`` call, no
synchronisation inside: the median over the traced steps."""

import statistics


def read(trace: dict):
    return statistics.median(trace["host_step_ms"]) if trace["host_step_ms"] else None
