"""The merged association (``ops/assoc_cuda.py: merged_moments``): for each
query, the moment sums of the voxels of its pools, re-referenced to the
query voxel's centre. A launch covers ``B x n`` queries. It must read each
query's mask (1 byte) and write its 13 float32 sums (52); for a valid query
also its voxel (12) and one 4-byte fingerprint word per pool voxel; and
for each pool voxel found, its moment row (40) and coordinates (12). A
point matched to a plane had a merged sum of at least ``min_points``
points, so at least one pool voxel found: ``M`` (the step's last
association) is the least count of voxels found a launch. No probe after
the first is counted. Operations: the 13 sums each pool voxel found
adds."""

KERNELS = ("merged_moments_kernel",)


def need(s: dict) -> tuple[float, float]:
    q = s["B"] * s["n"]
    return q * (1 + 52) + s["V"] * (12 + 4 * s["P"]) + s["M"] * (40 + 12), s["M"] * 13
