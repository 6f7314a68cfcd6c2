"""One rank of the port's mesh-mode tests (``tests/test_torch_parallel*.py``).

Run as (one process per rank; every rank gets the same arguments but its
rank):

    python tests/_torch_mesh_worker.py <host:port> <world> <rank> <inputs.npz> <out_dir>
        [--device cpu|cuda:0] [--backend gloo|nccl] [--cases a,b,...]

It joins a ``torch.distributed`` group, runs each requested case of the
port's ``parallel`` package on the inputs (numpy arrays made from a seed
by the test) and writes what it computed to ``<out_dir>/rank<r>.npz``.
Each case's configuration travels as JSON in ``inputs.npz``. It imports
neither JAX nor the JAX package, so the ranks run the port alone.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastliosam_tpu_torch import parallel  # noqa: E402
from fastliosam_tpu_torch.convert import gather_map  # noqa: E402
from fastliosam_tpu_torch.parallel.distributed import free_port  # noqa: E402
from fastliosam_tpu_torch.parallel.mesh import shard_leading  # noqa: E402

CASES = ("mesh", "solve", "gram", "detect", "submap", "icp", "map", "odom", "engine")


def _cfg(inp, key):
    return json.loads(str(inp[key]))


def _t(a, dev):
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def case_mesh(inp, mesh, out):
    """The mesh's size and rank, its collectives on this rank's values, and
    a subgroup mesh over the first two ranks."""
    r = mesh.rank
    x = torch.tensor([r + 1.0, -r, 2.0 * r], device=mesh.device)
    out["mesh.size_rank"] = np.asarray([mesh.size, r])
    out["mesh.psum"] = mesh.psum(x).cpu().numpy()
    out["mesh.pmin"] = mesh.pmin(x).cpu().numpy()
    out["mesh.pmax"] = mesh.pmax(x.to(torch.int32)).cpu().numpy()
    out["mesh.gather"] = mesh.all_gather(x[None]).cpu().numpy()
    out["mesh.flag"] = mesh.psum(torch.tensor([r == 0], device=mesh.device)).cpu().numpy()
    sub = parallel.make_mesh(min(2, mesh.size))
    out["mesh.sub"] = np.asarray([-1, -1] if sub is None else [sub.size, sub.rank])
    if sub is not None:
        out["mesh.sub_psum"] = sub.psum(torch.ones((1,), device=mesh.device)).cpu().numpy()


def case_solve(inp, mesh, out):
    """``solve_sharded`` on every graph ``solve<i>.*`` of the inputs."""
    from fastliosam_tpu_torch.pgo import PoseGraph, PoseGraphConfig

    cfg = PoseGraphConfig(**_cfg(inp, "solve.cfg"))
    i = 0
    while f"solve{i}.poses" in inp:
        g = PoseGraph(**{f: _t(inp[f"solve{i}.{f}"], mesh.device) for f in PoseGraph._fields})
        g2, cost = parallel.solve_sharded(g, cfg, mesh)
        out[f"solve{i}.poses"] = g2.poses.cpu().numpy()
        out[f"solve{i}.cost"] = cost.cpu().numpy()
        i += 1


def case_gram(inp, mesh, out):
    A, w, r = (shard_leading(mesh, _t(inp[f"gram.{k}"], mesh.device)) for k in "Awr")
    G, b, n = parallel.sharded_gram(A, w, r, mesh)
    out["gram.G"], out["gram.b"], out["gram.n"] = G.cpu().numpy(), b.cpu().numpy(), n.cpu().numpy()


def case_detect(inp, mesh, out):
    c = _cfg(inp, "detect.cfg")
    pos, st, valid = (shard_leading(mesh, _t(inp[f"detect.{k}"], mesh.device))
                      for k in ("pos", "stamps", "valid"))
    res = []
    for q in c["queries"]:
        row = np.concatenate([inp["detect.pos"][q], inp["detect.stamps"][q:q + 1]])
        for query_row in (None, torch.from_numpy(row.astype(np.float32))):
            i, f = parallel.detect_sharded(pos, st, valid, q, c["radius"], c["time_gap"], mesh,
                                           query_row=query_row)
            res.append((int(i), bool(f)))
    out["detect.res"] = np.asarray(res, np.int64)


def case_submap(inp, mesh, out):
    c = _cfg(inp, "submap.cfg")
    clouds = shard_leading(mesh, _t(inp["submap.clouds"], mesh.device))
    masks = shard_leading(mesh, _t(inp["submap.masks"], mesh.device))
    for j, ctr in enumerate(c["centers"]):
        wc, wm = parallel.gather_submap_sharded(clouds, masks, ctr, c["n_sub"], mesh)
        out[f"submap.c{j}"], out[f"submap.m{j}"] = wc.cpu().numpy(), wm.cpu().numpy()


def case_icp(inp, mesh, out):
    c = _cfg(inp, "icp.cfg")
    src, dst = _t(inp["icp.src"], mesh.device), _t(inp["icp.dst"], mesh.device)
    mask = _t(inp["icp.mask"], mesh.device)
    T, fit, nc = parallel.icp_align_sharded(
        shard_leading(mesh, src), shard_leading(mesh, mask), dst, mask, mesh, **c)
    out["icp.T"], out["icp.fit"], out["icp.n_corr"] = (T.cpu().numpy(), fit.cpu().numpy(),
                                                       nc.cpu().numpy())


def case_map(inp, mesh, out):
    """Two insert batches and a merged3 query on the slot-sharded map."""
    from fastliosam_tpu_torch.map import VoxelMapConfig

    cfg = VoxelMapConfig(**_cfg(inp, "map.cfg"))
    dev = mesh.device
    pts, pts2, q = (_t(inp[f"map.{k}"], dev) for k in ("pts", "pts2", "q"))
    mask = _t(inp["map.mask"], dev)
    m = parallel.make_map_sharded(cfg, mesh)
    out["map.shard_rows"] = np.asarray(m.fp.shape[0])
    m, drop = parallel.insert_sharded(m, cfg, pts, mask, mesh)
    out["map.drop"] = drop.cpu().numpy()
    full = gather_map(m, mesh)
    out["map.fp"], out["map.moments"] = full["fp"], full["moments"]
    for k, v in zip(("n", "d", "valid", "rvar"),
                    parallel.query_planes_merged3_sharded(m, cfg, q, mask, mesh)):
        out[f"map.q_{k}"] = v.cpu().numpy()
    m2, drop2 = parallel.insert_sharded(m, cfg, pts2, mask, mesh)
    full = gather_map(m2, mesh)
    out["map.fp2"], out["map.moments2"], out["map.drop2"] = (full["fp"], full["moments"],
                                                             drop2.cpu().numpy())


def case_odom(inp, mesh, out):
    """``odom_step`` over the slot-sharded map backend."""
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import ImuBatch, OdomConfig, Scan, init_odom, odom_step

    map_cfg = VoxelMapConfig(**_cfg(inp, "odom.map_cfg"))
    odom_cfg = OdomConfig(**_cfg(inp, "odom.odom_cfg"))
    dev = mesh.device
    ops = parallel.sharded_map_ops(mesh)
    s = init_odom(map_cfg, odom_cfg, device=dev, vmap=parallel.make_map_sharded(map_cfg, mesh))
    n_steps = inp["odom.xyz"].shape[0]
    for k in range(n_steps):
        scan = Scan(*(_t(inp[f"odom.{f}"][k], dev) for f in ("xyz", "toff", "mask")))
        imu = ImuBatch(*(_t(inp[f"odom.imu_{f}"][k], dev) for f in ("t", "g", "a", "m")))
        s, aux = odom_step(s, scan, imu, float(inp["odom.dt"]), odom_cfg, map_cfg,
                           map_ops=ops, device=dev)
        out[f"odom.p{k}"], out[f"odom.R{k}"] = aux["p"].cpu().numpy(), aux["R"].cpu().numpy()
        out[f"odom.n{k}"] = aux["n_matched"].cpu().numpy()
    full = gather_map(s.vmap, mesh)
    out["odom.fp"], out["odom.moments"] = full["fp"], full["moments"]


def build_engine(inp, mesh=None, device=None):
    """The engine of ``engine.cfgs`` (JSON of each config's fields)."""
    from fastliosam_tpu_torch import loop, map as vmap, odom, pgo, runtime

    c = _cfg(inp, "engine.cfgs")
    return runtime.SlamEngine(
        odom_cfg=odom.OdomConfig(**c["odom_cfg"]), map_cfg=vmap.VoxelMapConfig(**c["map_cfg"]),
        loop_cfg=loop.LoopConfig(**c["loop_cfg"]), pgo_cfg=pgo.PoseGraphConfig(**c["pgo_cfg"]),
        cfg=runtime.EngineConfig(**c["cfg"]), mesh=mesh, device=device)


def run_engine(engine, inp, chunk):
    """``process_chunk`` over the feed of the inputs from its start state,
    then ``finish()``; returns the realtime trajectory."""
    from fastliosam_tpu_torch.odom import ImuBatch, Scan

    dev = engine.device
    engine.reset()
    engine.odom = engine.odom._replace(nav=engine.odom.nav._replace(
        R=_t(inp["engine.R0"], dev), p=_t(inp["engine.p0"], dev), v=_t(inp["engine.v0"], dev)))
    xyz, toff, mask = (_t(inp[f"engine.{k}"], dev) for k in ("xyz", "toff", "mask"))
    imu = [_t(inp[f"engine.imu_{k}"], dev) for k in ("t", "g", "a", "m")]
    stamps = inp["engine.stamps"]
    for c0 in range(0, len(stamps) - len(stamps) % chunk, chunk):
        sl = slice(c0, c0 + chunk)
        engine.process_chunk(Scan(xyz[sl], toff[sl], mask[sl]), ImuBatch(*(t[sl] for t in imu)),
                             stamps[sl], float(inp["engine.dt"]))
    engine.finish()
    return np.stack(engine.realtime_traj)


def case_engine(inp, mesh, out):
    """``SlamEngine(mesh=...)`` over the loop feed in chunks, twice from
    ``reset()`` (the replay)."""
    chunk = int(inp["engine.chunk"])
    engine = build_engine(inp, mesh=mesh)
    t0 = time.perf_counter()
    out["engine.traj"] = run_engine(engine, inp, chunk)
    out["engine.s"] = np.asarray(time.perf_counter() - t0)
    out["engine.kf_n"] = np.asarray(engine.kf.n)
    out["engine.loops"] = np.asarray(engine.loop_pairs, np.int64).reshape(-1, 2)
    out["engine.solves"] = np.asarray(engine.solve_count)
    out["engine.kf_poses"] = engine.keyframe_poses()
    out["engine.collectives"] = np.asarray(mesh.collectives)
    out["engine.replay"] = run_engine(engine, inp, chunk)
    out["engine.replay_loops"] = np.asarray(engine.loop_pairs, np.int64).reshape(-1, 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("coordinator")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("inputs")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    parallel.init_distributed(args.coordinator, args.world, args.rank, backend=args.backend,
                              device=args.device)
    mesh = parallel.make_mesh()
    out = {}
    with np.load(args.inputs) as f:
        inp = dict(f)
    for name in args.cases.split(","):
        globals()[f"case_{name}"](inp, mesh, out)
    np.savez(os.path.join(args.out_dir, f"rank{args.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {args.rank}")
    return 0


if __name__ == "__main__":
    sys.exit(main())


def spawn_ranks(world: int, inputs: str, out_dir: str, cases, device: str = "cpu",
                backend: str = "gloo", timeout: float = 300.0, threads: int = 1,
                wait: bool = True):
    """Run ``world`` ranks of this script over ``inputs`` and return each
    rank's outputs (rank order); raises with a rank's output if any fails.
    With ``wait=False`` the ranks start and a function that waits for them
    and returns their outputs comes back at once."""
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(world), str(r), inputs, out_dir,
         "--device", device, "--backend", backend, "--cases", ",".join(cases),
         "--threads", str(threads)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return collect(procs, world, out_dir, timeout) if wait else (
        lambda: collect(procs, world, out_dir, timeout))


def collect(procs, world: int, out_dir: str, timeout: float) -> list[dict]:
    """Wait for the rank processes of :func:`spawn_ranks` and load their
    outputs."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"RANK_OK {r}" not in log:
            raise RuntimeError(f"rank {r} of {world} failed (exit {p.returncode}):\n{log[-4000:]}")
    outs = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            outs.append(dict(f))
    return outs
