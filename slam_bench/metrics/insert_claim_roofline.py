"""``insert_claim``'s share (%) of its roofline over the traced window
(``rooflines/insert_claim.py``)."""

from slam_bench.rooflines import share


def read(trace: dict):
    return share(trace, "insert_claim")
