"""The rank mesh: one shard per rank over ``torch.distributed`` (port of
``fastliosam_tpu/parallel/mesh.py``).

The JAX package names a ``jax.sharding.Mesh`` of devices that one program
drives. The port runs one process per shard (SPMD, the PyTorch idiom for
more than one card or host): every rank makes the same engine calls on the
same inputs and holds its own part of the sharded state: a contiguous
slot range of the voxel map, a block of factor rows, a block of points.
:class:`Mesh` names the process group, this rank and its device; the
collectives are its methods.

Every collective is one ``dist.all_reduce``. ``all_gather`` is a SUM over
a zeroed ``(n, ...)`` buffer in which each rank fills its own row (adding
zeros is exact). NCCL refuses two ranks on one GPU, so several ranks on
one card run under gloo; built on ``all_reduce`` alone, the same code runs
under NCCL (a card per rank) and under gloo (the CPU, or more ranks than
cards) with one primitive whose every use is easy to count. Every rank
receives the same bits from each collective, so host decisions made from
collective results (keyframes, loop candidates, the re-query gate) agree
on every rank. On the one-card machine a gloo ``all_reduce`` between 4
ranks costs ~4 ms whatever its size (``scripts/exp_collectives.py``), so
the sharded modules pack what one step needs into as few calls as the
algorithm allows.

Each mesh counts its collectives and the host time spent in them
(``collectives``, ``collective_s``; under gloo that time includes the
wait for the device work queued before the call, since gloo stages a
CUDA tensor through host memory).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(eq=False)
class Mesh:
    """A 1-D mesh of ranks along ``axis``: this process is rank ``rank`` of
    ``size`` in ``group`` and keeps its shard on ``device``."""

    group: object
    axis: str
    rank: int
    size: int
    device: torch.device
    collectives: int = field(default=0, init=False)
    collective_s: float = field(default=0.0, init=False)

    def _all_reduce(self, x, op):
        """``x`` reduced over the mesh with ``op`` (a new tensor on the
        rank's device); bool travels as int32."""
        t = x.to(self.device, torch.int32 if x.dtype == torch.bool else x.dtype,
                 copy=True).contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return t.to(torch.bool) if x.dtype == torch.bool else t

    def psum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x):
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x):
        """``(size, ...)``: row r is rank r's ``x`` (a SUM over a zeroed
        buffer, exact)."""
        buf = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype, device=self.device)
        buf[self.rank] = x
        return self.psum(buf)

    def reset_counts(self) -> None:
        self.collectives, self.collective_s = 0, 0.0


_subgroups: dict[int, object] = {}


def make_mesh(n_devices: int | None = None, axis: str = "kf") -> Mesh | None:
    """The mesh over the default group, or over its first ``n_devices``
    ranks (JAX: ``jax.devices()[:n]``). Every rank of the default group
    must call it (a subgroup is made collectively); a rank outside the
    subgroup gets ``None``."""
    from .distributed import rank_device

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call init_distributed()")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is None or n_devices == world:
        return Mesh(dist.group.WORLD, axis, rank, world, rank_device())
    if not 0 < n_devices <= world:
        raise ValueError(f"n_devices must be in [1, {world}], got {n_devices}")
    group = _subgroups.get(n_devices)
    if group is None:
        group = _subgroups[n_devices] = dist.new_group(ranks=list(range(n_devices)))
    if rank >= n_devices:
        return None
    return Mesh(group, axis, rank, n_devices, rank_device())


def pad_to_multiple(x, m: int, fill=0):
    """``x`` with its leading axis padded by ``fill`` rows to a multiple of
    ``m`` (``x`` itself when it is one already)."""
    pad = (-x.shape[0]) % m
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                    device=x.device)])


def shard_leading(mesh: Mesh, x, fill=0):
    """This rank's contiguous block of the leading axis of ``x`` on its
    device, the axis padded with ``fill`` to a multiple of the mesh first
    (JAX asserts divisibility; a masked padding row changes no sum)."""
    x = pad_to_multiple(x, mesh.size, fill)
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per: (mesh.rank + 1) * per].to(mesh.device)


def replicate(mesh: Mesh, x):
    """``x`` on this rank's device (every rank holds all of it)."""
    return x.to(mesh.device)
