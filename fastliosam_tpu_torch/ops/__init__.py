"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from . import nn_cuda  # noqa: F401
from .nn_cuda import (  # noqa: F401
    nearest_neighbors,
    nearest_neighbors_cuda,
    nearest_neighbors_ref,
)

# every kernel module: KERNEL (name, route, source, replaces), launches,
# reset_launches()
KERNEL_MODULES = (nn_cuda,)
