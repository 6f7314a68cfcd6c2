"""Process-group start-up and the whole-world mesh (port of
``fastliosam_tpu/parallel/distributed.py``).

The MulRan-Riverside N≥2-host configuration (BASELINE.md config #5):
keyframes and factors shard along the ``kf`` axis across ranks. This
module starts ``torch.distributed`` from torchrun's variables, as the JAX
module starts ``jax.distributed`` from its own; the sharded modules see
only the mesh.

Launch, one process per rank (torchrun sets every variable read here)::

    torchrun --nnodes N --nproc-per-node G --rdzv-endpoint HOST:PORT app.py

where ``app.py`` calls ``init_distributed()`` and builds
``SlamEngine(mesh=global_mesh())``.

Unlike JAX's single-process no-op, a world of 1 still creates a group, so
the mesh code runs the same calls at any size. The group has a finite
timeout (``TIMEOUT_S``): every rank must make the same collective calls,
and a rank that branches differently then fails the run instead of
hanging it.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, make_mesh

TIMEOUT_S = 300.0  # the longest any collective may wait for the other ranks
_device: torch.device | None = None


def free_port() -> int:
    """A free TCP port on this host (for a coordinator on localhost)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
):
    """Join the process group; returns ``(world_size, rank)``.

    Arguments default to torchrun's variables: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (the coordinator ``host:port``), ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK``. The device defaults to
    ``cuda:{LOCAL_RANK % device_count}``; without CUDA that raises unless
    ``device="cpu"`` is passed. The backend defaults to ``nccl`` when each
    rank on this host has a card of its own and to ``gloo`` on the CPU or
    with more ranks than cards (``LOCAL_WORLD_SIZE``, else the world, counts
    the ranks on this host)."""
    global _device
    env = os.environ
    num_processes = num_processes or int(env.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(env.get("RANK", "0"))
    if coordinator is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif num_processes == 1:
            coordinator = f"127.0.0.1:{free_port()}"
        else:
            raise ValueError("no coordinator: pass host:port or set MASTER_ADDR/MASTER_PORT")
    local_rank = int(env.get("LOCAL_RANK", str(process_id)))
    if device is None:
        resolve_device(None)  # no CUDA: raises
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(num_processes)))
        backend = ("nccl" if dev.type == "cuda" and local_world <= torch.cuda.device_count()
                   else "gloo")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=TIMEOUT_S),
    )
    _device = dev
    return dist.get_world_size(), dist.get_rank()


def rank_device() -> torch.device:
    """This rank's device, as :func:`init_distributed` chose it."""
    if _device is None:
        raise RuntimeError("no rank device: call init_distributed() first")
    return _device


def global_mesh(axis: str = "kf") -> Mesh:
    """1-D mesh over every rank of every host, in rank order, so the
    keyframe axis splits contiguously across hosts (torchrun numbers ranks
    host-major)."""
    return make_mesh(None, axis)
