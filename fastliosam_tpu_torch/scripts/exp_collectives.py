"""Which ``torch.distributed`` collectives several ranks on one card can use,
and what they cost: the facts behind ``parallel/mesh.py``'s choice of
building every collective on ``all_reduce``.

    python -m fastliosam_tpu_torch.scripts.exp_collectives [--out results.json]

The probes, each in its own spawned processes on ``cuda:0``:

* NCCL, 2 ranks on the one card: does the first ``all_reduce`` run?
* gloo, 2 ranks on the card: each collective of ``torch.distributed`` on
  CUDA tensors (``all_reduce``, ``broadcast``, ``all_gather``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_to_all_single``,
  ``reduce``, ``gather``, ``scatter``): runs, or the error it raises;
* the host time of one ``all_reduce`` at the mesh phase's sizes (the 16
  Horn moments, 8192 int32 probe offsets or fingerprints, 8192 x 10
  moment rows, a 128 x 6 PCG vector) for gloo at 4 ranks on the card (a
  CUDA tensor as it is, a host tensor, and a CUDA tensor copied to host
  memory and back around the call, as ``parallel/mesh.py`` does) and NCCL
  at world size 1.

Prints one JSON object; a probe that hangs past ``--timeout`` seconds is
killed and reported so.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys
import time
import traceback

SIZES = {"horn16_f32": ((16,), "float32"), "probe8192_i32": ((8192,), "int32"),
         "rows8192x10_f32": ((8192, 10), "float32"), "pcg128x6_f32": ((128, 6), "float32")}
OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "reduce", "gather", "scatter")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _err(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).strip().splitlines()[0][:200] if str(e).strip() else ''}"


def _try_op(dist, torch, op: str, rank: int, world: int, dev):
    x = torch.full((4,), float(rank + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif op == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty((4 * world,), device=dev), x)
    elif op == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty((4,), device=dev),
                                   torch.ones((4 * world,), device=dev))
    elif op == "all_to_all_single":
        dist.all_to_all_single(torch.empty((4 * world,), device=dev),
                               torch.ones((4 * world,), device=dev))
    elif op == "reduce":
        dist.reduce(x, 0)
    elif op == "gather":
        dist.gather(x, [torch.empty_like(x) for _ in range(world)] if rank == 0 else None, 0)
    elif op == "scatter":
        dist.scatter(x, [torch.ones_like(x) for _ in range(world)] if rank == 0 else None, 0)
    torch.cuda.synchronize(dev)


def _rank(kind: str, rank: int, world: int, port: int, out: str, reps: int) -> None:
    import torch
    import torch.distributed as dist

    res = {"rank": rank}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    backend = "nccl" if kind.startswith("nccl") else "gloo"
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    except Exception as e:  # noqa: BLE001 (the probe reports it)
        res["init"] = _err(e)
        json.dump(res, open(out, "w"))
        return
    res["init"] = "ok"
    if kind in ("nccl_two_on_one", "gloo_ops"):
        ops = ("all_reduce",) if kind == "nccl_two_on_one" else OPS
        for op in ops:
            res[op] = "started"  # left so if the op hangs
            json.dump(res, open(out, "w"))
            try:
                _try_op(dist, torch, op, rank, world, dev)
                res[op] = "ok"
            except Exception as e:  # noqa: BLE001 (the probe reports it)
                res[op] = _err(e)
    else:
        # gloo: a CUDA tensor as it is, a host tensor, and a CUDA tensor
        # copied to host memory and back around the call (parallel/mesh.py)
        ways = ("cuda", "host", "cuda_via_host") if backend == "gloo" else ("cuda",)
        for name, (shape, dtype) in SIZES.items():
            for way in ways:
                x = torch.ones(shape, dtype=getattr(torch, dtype),
                               device="cpu" if way == "host" else dev)

                def once():
                    if way == "cuda_via_host":
                        h = x.cpu()
                        dist.all_reduce(h)
                        return h.to(dev)
                    dist.all_reduce(x)
                    return x

                for _ in range(5):
                    once()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(reps):
                    once()
                torch.cuda.synchronize(dev)
                res[f"{name}_{way}_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 (a broken NCCL group may not tear down)
        pass
    json.dump(res, open(out, "w"))


def _probe(kind: str, world: int, timeout: float, reps: int, tmp: str) -> dict:
    ctx = multiprocessing.get_context("spawn")
    port = _port()
    outs = [os.path.join(tmp, f"{kind}_{r}.json") for r in range(world)]
    procs = [ctx.Process(target=_rank, args=(kind, r, world, port, outs[r], reps))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks = []
    for r, path in enumerate(outs):
        rec = json.load(open(path)) if os.path.exists(path) else {"rank": r}
        rec["exit"] = procs[r].exitcode
        if r in hung:
            rec["hung"] = True
        ranks.append(rec)
    return {"world": world, "seconds": time.perf_counter() - t0, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("exp_collectives: needs a CUDA device", file=sys.stderr)
        return 2
    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, world in (("nccl_two_on_one", 2), ("gloo_ops", 2), ("gloo_times", 4),
                            ("nccl_times", 1)):
            try:
                out[kind] = _probe(kind, world, args.timeout, args.reps, tmp)
            except Exception:  # noqa: BLE001 (the probe reports it)
                out[kind] = {"error": traceback.format_exc()[-1000:]}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
