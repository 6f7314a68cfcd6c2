"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from . import assoc_cuda, gather_cuda, nn_cuda, take_along_cuda  # noqa: F401
from .assoc_cuda import merged_moments, merged_moments_cuda, merged_moments_ref  # noqa: F401
from .gather_cuda import gather_rows, gather_rows_cuda, gather_rows_ref  # noqa: F401
from .nn_cuda import (  # noqa: F401
    nearest_neighbors,
    nearest_neighbors_cuda,
    nearest_neighbors_ref,
)
from .take_along_cuda import (  # noqa: F401
    take_along_axis,
    take_along_axis_cuda,
    take_along_axis_ref,
)

# every kernel module: KERNEL (name, route, source, replaces), launches,
# reset_launches()
KERNEL_MODULES = (nn_cuda, gather_cuda, take_along_cuda, assoc_cuda)
