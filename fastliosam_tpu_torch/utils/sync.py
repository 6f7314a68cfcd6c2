"""Counted device-to-host reads.

Where the JAX package branches on device values inside one compiled
program (``lax.cond``, ``lax.while_loop``), the eager port reads the value
back to the host. On a GPU every such read waits for the device queue to
drain. All of them go through :func:`host_read`, which counts them, so a
run can report host syncs per scan and per loop verification.
"""
from __future__ import annotations

import numpy as np
import torch

_count = 0


def host_read(*tensors):
    """Copy ``tensors`` to host numpy arrays in ONE transfer (one sync).

    Returns a single array for one argument, else a tuple of arrays.
    """
    global _count
    _count += 1
    if len(tensors) == 1:
        return tensors[0].detach().cpu().numpy()
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[pos: pos + n].reshape(tuple(t.shape)).astype(_np_dtype(t)))
        pos += n
    return tuple(out)


def _np_dtype(t: torch.Tensor):
    return torch.empty((), dtype=t.dtype).numpy().dtype


def host_reads() -> int:
    """Number of counted host reads since the last reset."""
    return _count


def reset_host_reads() -> None:
    global _count
    _count = 0
