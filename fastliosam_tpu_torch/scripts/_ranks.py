"""The rank launcher of the scaling scripts (``bench_scaling``,
``bench_crossover``): one process a rank over ``torch.distributed``, where
the JAX scripts drive N devices from one process.

:func:`run` calls ``fn(args)`` on every rank of one world and returns every
rank's result, in rank order, to the process that reports:

* run as it is, it spawns ``world`` ranks (``spawn`` context) on a free
  port of localhost and waits for them. Each joins through
  :func:`parallel.init_distributed`, which picks gloo for several ranks on
  a card or on the CPU and NCCL for a card a rank. With ``cpu`` every rank
  runs on the CPU; otherwise rank r runs on ``cuda:{r % cards}``. The
  parent builds the kernels first; a rank on a card loads them and never
  builds one. A rank that exits non-zero, a collective that waits past
  ``parallel.distributed.TIMEOUT_S`` (the rank raises) or a rank still
  running after ``timeout_s`` fails the run: nothing falls back to fewer
  ranks or to the CPU;
* under ``torchrun`` (``WORLD_SIZE`` set) this process is one rank of
  torchrun's world; rank 0 gets every result, the others ``None``.

A sweep over rank counts runs each count as a subgroup of the one world
(``parallel.make_mesh(n)``, the first ``n`` ranks). Making a subgroup is
collective, so :func:`meshes` makes every count's mesh on every rank in
one order, the ranks outside a subgroup included.
"""
from __future__ import annotations

import json
import math
import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist

WALL_TIMEOUT_S = 1800.0  # the longest a spawned world may run
# the last spawned world's seconds: spawn to rank 0 running, its group's
# start-up, its work, and its end to every rank joined
LAST_RUN_S: dict = {}


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ


def torchrun_world() -> int:
    return int(os.environ["WORLD_SIZE"])


def layout(world: int, cpu: bool) -> dict:
    """Where ``world`` ranks run: the cards they use, ranks a card, and
    whether ranks share a device (the JAX scripts' ``virtual_devices``: the
    CPU, or more ranks than cards)."""
    if cpu:
        return {"cards": 0, "ranks_per_card": None, "virtual_devices": True}
    from ..utils.device import resolve_device

    resolve_device(None)  # no CUDA: raises
    cards = min(world, torch.cuda.device_count())
    return {"cards": cards, "ranks_per_card": math.ceil(world / cards),
            "virtual_devices": world > cards}


def meshes(counts) -> dict:
    """``{n: make_mesh(n)}`` for every rank count, made on every rank in
    the same order (``None`` where this rank lies outside the subgroup)."""
    from ..parallel import make_mesh

    return {n: make_mesh(n) for n in counts}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launches() -> dict:
    """Every kernel's launch count of this process."""
    from ..ops import KERNEL_MODULES

    return {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a :func:`launches`), with their
    counts."""
    return {k: v - before[k] for k, v in launches().items() if v > before[k]}


def _gather(rec):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def _rank(fn, args, rank: int, world: int, coord: str, device: str, out_path: str,
          threads: int) -> None:
    t_enter = time.time()
    torch.set_num_threads(threads)
    # every rank of a spawned world is on this host: gloo binds the loopback
    # interface instead of resolving the host's name
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device.startswith("cuda"):
        from ..ops import build

        missing = [n for n in build.sources() if not build.library_path(n).exists()]
        if missing:
            raise RuntimeError(f"rank {rank}: kernels not built by the parent: {missing}")
    from ..parallel import init_distributed

    init_distributed(coord, world, rank, device=device)
    try:
        t_ready = time.time()
        recs = _gather(fn(args))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"records": recs, "t": [t_enter, t_ready, time.time()]}, f)
    finally:
        dist.destroy_process_group()


def run(fn, args, world: int, cpu: bool, timeout_s: float = WALL_TIMEOUT_S):
    """``fn(args)`` on every rank (see the module docstring); ``fn`` is a
    module-level function and ``args`` pickles. Returns the list of every
    rank's result in rank order, or ``None`` on a torchrun rank but 0."""
    from ..parallel import init_distributed
    from ..parallel.distributed import free_port

    if under_torchrun():
        init_distributed(device="cpu" if cpu else None)
        try:
            recs = _gather(fn(args))
        finally:
            rank = dist.get_rank()
            dist.destroy_process_group()
        return recs if rank == 0 else None
    layout(world, cpu)  # no CUDA without cpu: raises
    if not cpu:
        from ..ops import build

        build.build(build.sources())
    cards = 0 if cpu else torch.cuda.device_count()
    devices = ["cpu" if cpu else f"cuda:{r % cards}" for r in range(world)]
    # the host's cores shared out, never more than this process uses
    threads = max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world))
    coord = f"127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "ranks.json")
        procs = [ctx.Process(target=_rank, name=f"rank{r}", args=(
            fn, args, r, world, coord, devices[r], out_path, threads)) for r in range(world)]
        t_spawn = time.time()
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout_s
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.perf_counter()))
        finally:
            alive = [p.name for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [f"{p.name} (exit {p.exitcode})" for p in procs if p.exitcode != 0]
        if alive or failed:
            raise RuntimeError(f"ranks failed: {failed}; still running after {timeout_s:.0f} s: "
                               f"{alive}")
        t_joined = time.time()
        with open(out_path) as f:
            out = json.load(f)
    t_enter, t_ready, t_done = out["t"]
    LAST_RUN_S.clear()
    LAST_RUN_S.update({"spawn": t_enter - t_spawn, "group": t_ready - t_enter,
                       "work": t_done - t_ready, "end": t_joined - t_done})
    return out["records"]
