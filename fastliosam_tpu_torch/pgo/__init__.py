from .graph import (  # noqa: F401
    PoseGraph,
    PoseGraphConfig,
    make_graph,
    from_arrays,
    add_keyframe,
    add_between,
    add_gps,
    set_pose,
    grow,
)
from .solver import solve, graph_cost  # noqa: F401
