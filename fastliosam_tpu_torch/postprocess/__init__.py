"""Post-processing of the engine's exports (port of
``fastliosam_tpu/postprocess``): map cleanup, georeferencing, 2D
alignment, map matching, detection, image tools, plots, and the standalone
HTML map viewer that ``runtime/persistence.py: save_results`` writes."""
from .align import (  # noqa: F401
    Similarity2D,
    fit_similarity_2d,
    icp_2d_with_scale,
    match_by_timestamp,
)
from .georef import (  # noqa: F401
    georeference_trajectory,
    georeference_pcd,
    save_alignment_params,
    load_alignment_params,
)
from .cleanup import (  # noqa: F401
    sor_denoise,
    ransac_ground_plane,
    euclidean_clusters,
    cluster_bounding_boxes,
    intensity_filter,
    denoise_slam_map,
)
from .viewer3d import write_map_viewer  # noqa: F401
