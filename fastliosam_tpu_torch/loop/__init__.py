from .detect import fetch_closest_keyframe_idx  # noqa: F401
from .icp import icp_align, nearest_neighbors  # noqa: F401
from .closure import LoopConfig, build_submap, verify_loop  # noqa: F401
