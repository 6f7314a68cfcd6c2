"""The map insert's match-or-claim (``ops/insert_cuda.py: insert_claim``):
each point's voxel found or claimed, its slot and its moment update. A
launch covers ``B x n`` points. It must read each point's mask (1 byte);
for a valid point its position (12), one fingerprint word (4) and the
voxel's old count for the saturation test (4), and write its slot (4) and
its 10-float moment update (40); and each lane's unassigned count (4). The
words of newly claimed voxels depend on the map and are not counted.
Operations: the voxel coordinates, the offset and its outer product (12)."""

KERNELS = ("insert_claim_kernel",)


def need(s: dict) -> tuple[float, float]:
    return (s["B"] * s["n"] * 1 + s["V"] * (12 + 4 + 4 + 4 + 40) + s["B"] * 4,
            s["V"] * 12)
