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
from .solver import (  # noqa: F401
    extrapolate_pose_cov,
    graph_cost,
    marginal_covariance,
    marginal_covariance_dense,
    rotate_cov_to_world,
    solve,
)
