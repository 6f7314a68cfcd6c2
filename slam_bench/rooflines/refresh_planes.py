"""The plane refresh of the cached mode's insert
(``ops/plane_fit_cuda.py: refresh_planes``): the plane of every voxel the
insert touched, refitted from its moments. A launch covers ``B x n`` slots.
It must read every slot (4 bytes); for each distinct voxel touched (at
least an eighth of the points assigned: ``distinct_voxels_at_least``) read
its moments (40) and coordinates (12) and write its normal, offset and
valid flag (20). The copies of the old plane tables are separate device
copies, not this kernel's. Operations: a 3x3 covariance and its closed-form
smallest eigenvector (about 100 a voxel)."""

from slam_bench.rooflines import distinct_voxels_at_least

KERNELS = ("refresh_planes_kernel",)


def need(s: dict) -> tuple[float, float]:
    d = distinct_voxels_at_least(s["V"] - s["dropped"])
    return s["B"] * s["n"] * 4 + d * (40 + 12 + 20), d * 100
