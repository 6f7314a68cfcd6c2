"""The cached-mode iEKF rows (``ops/cached_rows_cuda.py: cached_rows``): for
each point, its cached plane found (or carried) and its rows. A launch
covers ``B x n`` points. It must read each point's mask (1 byte) and write
its rows: normal (12), residual (4), valid flag (1), Jacobian row and
weighted row (24 + 24), confident weight (4), weighted normal (12) and slot
(4); for a valid point also read its body position (12) and one 4-byte
word of the association (a fingerprint probed or the slot carried); for a
point matched to a plane (``M``, the step's last association) that plane's
normal, offset and valid flag (12 + 4 + 1); and each lane's match count (8)
and pose (48). Operations: the point's world position, residual, rotated
normal and cross product (45)."""

KERNELS = ("cached_rows_kernel",)


def need(s: dict) -> tuple[float, float]:
    return (s["B"] * s["n"] * (1 + 85) + s["V"] * (12 + 4) + s["M"] * (12 + 4 + 1)
            + s["B"] * (8 + 48), s["V"] * 45)
