"""``refresh_planes``'s share (%) of its roofline over the traced window
(``rooflines/refresh_planes.py``)."""

from slam_bench.rooflines import share


def read(trace: dict):
    return share(trace, "refresh_planes")
