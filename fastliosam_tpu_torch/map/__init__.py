from .voxel_hash import (  # noqa: F401
    VoxelMapConfig,
    VoxelMap,
    make_map,
    insert,
    query_planes_merged,
    query_planes_merged3,
    evict_far,
    occupied_centroids,
)
