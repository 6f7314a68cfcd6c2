"""Device policy: entry points run on ``cuda`` unless the caller asks for
the CPU, and raise when CUDA is missing instead of falling back."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return dev


def upload(array, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a stream sync: a plain
    ``.to("cuda")`` from pageable memory waits for the device queue to
    drain, so CUDA uploads go through pinned memory, non-blocking."""
    t = torch.as_tensor(array, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_device(tree, device: torch.device):
    """Move every tensor of a (nested) NamedTuple/tuple/list/dict to
    ``device``; other leaves pass through. A no-op for tensors already
    there."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree
