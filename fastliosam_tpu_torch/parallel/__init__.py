"""Mesh mode over ``torch.distributed``: one shard per rank (port of
``fastliosam_tpu/parallel``)."""
from .mesh import Mesh, make_mesh, replicate, shard_leading  # noqa: F401
from .sharded_pgo import solve_sharded  # noqa: F401
from .sharded_match import sharded_gram  # noqa: F401
from .distributed import global_mesh, init_distributed  # noqa: F401
from .sharded_map import (  # noqa: F401
    insert_sharded,
    make_map_sharded,
    query_planes_merged3_sharded,
)
from .sharded_loop import (  # noqa: F401
    detect_sharded,
    gather_submap_sharded,
    icp_align_sharded,
)
from .sharded_odom import (  # noqa: F401
    MapOps,
    evict_far_sharded,
    shard_map_arrays,
    sharded_map_ops,
)
