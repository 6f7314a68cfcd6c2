"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from . import (  # noqa: F401
    assoc_cuda,
    cluster_cuda,
    gather_cuda,
    insert_cuda,
    kneighbors_cuda,
    nn_cuda,
    p2pl_cuda,
    plane_fit_cuda,
    query_cuda,
    take_along_cuda,
)
from .assoc_cuda import merged_moments, merged_moments_cuda, merged_moments_ref  # noqa: F401
from .cluster_cuda import voxel_edges, voxel_edges_cuda, voxel_edges_ref  # noqa: F401
from .gather_cuda import gather_rows, gather_rows_cuda, gather_rows_ref  # noqa: F401
from .insert_cuda import insert_claim, insert_claim_cuda, insert_claim_ref  # noqa: F401
from .kneighbors_cuda import knn, knn_cuda, knn_ref  # noqa: F401
from .nn_cuda import (  # noqa: F401
    nearest_neighbors,
    nearest_neighbors_cuda,
    nearest_neighbors_ref,
)
from .p2pl_cuda import corr_keys, normal_eq, normal_eq_cuda, normal_eq_ref  # noqa: F401
from .plane_fit_cuda import (  # noqa: F401
    refresh_planes,
    refresh_planes_cuda,
    refresh_planes_ref,
)
from .query_cuda import query_cached, query_cached_cuda, query_cached_ref  # noqa: F401
from .take_along_cuda import (  # noqa: F401
    take_along_axis,
    take_along_axis_cuda,
    take_along_axis_ref,
)

# every kernel module: KERNEL (name, route, source, replaces), launches,
# reset_launches()
KERNEL_MODULES = (nn_cuda, gather_cuda, take_along_cuda, assoc_cuda, insert_cuda, query_cuda,
                  kneighbors_cuda, cluster_cuda, plane_fit_cuda, p2pl_cuda)
