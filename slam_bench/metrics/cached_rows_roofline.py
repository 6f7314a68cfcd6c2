"""``cached_rows``'s share (%) of its roofline over the traced window
(``rooflines/cached_rows.py``)."""

from slam_bench.rooflines import share


def read(trace: dict):
    return share(trace, "cached_rows")
