"""The share (%) of the traced window in which no operation ran on the
device: the union of the profiled operations against the window's length
between its first and last step events."""


def read(trace: dict):
    if trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
