"""``merged_moments``'s share (%) of its roofline over the traced window
(``rooflines/merged_moments.py``)."""

from slam_bench.rooflines import share


def read(trace: dict):
    return share(trace, "merged_moments")
