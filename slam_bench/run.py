"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m slam_bench.run --workload lio.hdl64.fleet99 --seed 7 --seconds 20 --trace 0

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is a fleet of
odometry lanes: ``fastliosam_tpu_torch.odom.pipeline.odom_step_batched``
advances every lane by one scan a step, and each lane replays clips of the
traffic's recordings, the harness writing a fresh lane state where a clip
ends.
Everything a cell names is a file found by name: its configuration in
``configs/``, its traffic in ``traffic/``, its limits in ``limits/``, each
per-layer metric's reader in ``metrics/`` and each kernel's roofline count
in ``rooflines/``.

Set-up (counted in ``setup_s``) loads or builds the feed, stages it on the
card, makes the lanes, and runs ``warmup_steps`` steps, which builds every
kernel and brings the fleet to its steady mix of map ages. The window then
enqueues step after step with no host synchronisation inside it; a CUDA
event after each step times it on the card. After the window one more
step is taken for the check with every lane's state kept, the program's
state is freed, and the reference takes that step of every lane from the
state the program held (``check.py``). With ``--trace 1`` the window is
``trace_steps`` steps under ``torch.profiler`` and the result holds the
per-layer metrics.

The last line of standard output is the result, as JSON. A run without
CUDA, or with fewer cards than the cell asks for, exits 2 and prints none;
a run that finds JAX or the JAX package loaded exits 3 and prints none.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
INTRA_OP_THREADS = 1  # the host's torch threads, fixed in every run
FORBIDDEN = ("jax", "jaxlib", "flax", "fastliosam_tpu")
WINDOW_STEPS_PER_S = 500  # the most steps a second the record buffers hold


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time against ``/proc/uptime``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def files(kind: str, suffix: str, root: Path = BENCH_DIR) -> dict[str, Path]:
    """``{name: path}`` of the files ``<root>/<kind>/<name><suffix>``."""
    return {p.name[: -len(suffix)]: p for p in sorted((root / kind).glob(f"*{suffix}"))
            if not p.name.startswith("_")}


def load_json(kind: str, name: str, root: Path = BENCH_DIR) -> dict:
    path = files(kind, ".json", root).get(name)
    if path is None:
        raise SystemExit(f"no {kind}/{name}.json under {root}")
    return json.loads(path.read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"slam_bench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """The workload's entry and its configuration's entry."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w, next(c for c in bench["configs"] if c["name"] == w["config"])
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def schedule(lanes: int, clip: int, steps: int):
    """Each lane's clip number and the step its clip began, at every step
    ``(steps, lanes)``: lane b's clips begin at step 0 and at the steps
    ``o_b + j * clip`` (``o_b = b * clip // lanes``, or ``clip`` where that
    is 0), so about ``lanes / clip`` lanes start a clip at every step."""
    o = np.array([(b * clip) // lanes or clip for b in range(lanes)], np.int64)
    t = np.arange(steps, dtype=np.int64)[:, None]
    later = t >= o[None]
    clip_no = np.where(later, 1 + (t - o[None]) // clip, 0)
    began = np.where(later, o[None] + ((t - o[None]) // clip) * clip, 0)
    return clip_no, began


class Fleet:
    """A cell's lanes, their clips, the program's state and its window."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, max_steps: int,
                 step=None):
        import torch

        from fastliosam_tpu_torch.map import VoxelMapConfig
        from fastliosam_tpu_torch.odom import OdomConfig, init_odom, odom_step_batched

        from . import feed as feed_mod

        self.dev = torch.device(device)
        self.step_fn = odom_step_batched if step is None else step
        self.cfg = OdomConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in config["odom"].items()})
        self.map_cfg = VoxelMapConfig(**config["map"])
        self.B, self.L = traffic["lanes"], traffic["clip_scans"]
        spec = traffic["feed"]
        if traffic["start_scan_max"] + self.L > spec["n_scans"]:
            raise ValueError("a clip would run past its recording's last scan")

        host = feed_mod.load_recordings(spec, traffic["recordings"])
        raw = config["raw_points"]
        if host["xyz"].shape[1] != raw:
            raise ValueError(f"the feed has {host['xyz'].shape[1]} points a scan, "
                             f"the configuration {raw}")
        self.dt = float(host["scan_dt"])
        self.feed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.dev)
                     for k, v in host.items() if k != "scan_dt"}
        self.feed["scan_dt"] = self.dt

        # clips: each lane's recordings, start scans and start jitters, drawn
        # from the seed
        self.T = max_steps
        self.clip_no, self.began = schedule(self.B, self.L, self.T)
        n_clips = int(self.clip_no.max()) + 1
        rng = np.random.default_rng(seed)
        self.starts = rng.integers(0, traffic["start_scan_max"] + 1, size=(self.B, n_clips))
        d = rng.normal(size=(self.B, n_clips, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        r = traffic["start_jitter_m"] * rng.uniform(size=(self.B, n_clips, 1))
        jitter = (d * r).astype(np.float32)
        recording = rng.integers(0, len(traffic["recordings"]), size=(self.B, n_clips))
        self.starts += recording * spec["n_scans"]
        lanes = np.arange(self.B)
        scan_of = self.starts[lanes[None], self.clip_no] + (np.arange(self.T)[:, None] - self.began)
        self.scan_of = torch.from_numpy(scan_of).to(self.dev)
        s = torch.from_numpy(self.starts).to(self.dev)
        self.clip_R = self.feed["R0"][s]
        self.clip_p = self.feed["p0"][s] + torch.from_numpy(jitter).to(self.dev)
        self.clip_v = self.feed["v0"][s]

        self.template = init_odom(self.map_cfg, self.cfg, device=self.dev, lanes=1)
        self.state = init_odom(self.map_cfg, self.cfg, device=self.dev, lanes=self.B)
        for b in range(self.B):
            self._reset(b, 0)
        self.rec_p = torch.zeros((self.T, self.B, 3), dtype=torch.float32, device=self.dev)
        self.rec_R = torch.zeros((self.T, self.B, 3, 3), dtype=torch.float32, device=self.dev)
        self.t = 0  # steps done
        self.phase_log = None  # (time_ns, phase) of the traced window's host phases

    def _leaves(self, st):
        return [*st.nav, *st.vmap, st.scan_idx, st.initialized, st.w_cv]

    def _reset(self, b: int, c: int):
        """Lane ``b`` fresh for its clip ``c``: the template's words, then the
        true attitude and velocity at the clip's start and its jittered
        position."""
        for dst, src in zip(self._leaves(self.state), self._leaves(self.template)):
            dst[b].copy_(src[0])
        nav = self.state.nav
        nav.R[b].copy_(self.clip_R[b, c])
        nav.p[b].copy_(self.clip_p[b, c])
        nav.v[b].copy_(self.clip_v[b, c])

    def starting(self, t: int) -> list[int]:
        """The lanes that begin a new clip at step ``t`` (> 0)."""
        return [int(b) for b in np.flatnonzero(self.began[t] == t)]

    def _phase(self, name: str):
        if self.phase_log is not None:
            self.phase_log.append((time.time_ns(), name))

    def step(self, before=None):
        """One batched step of every lane, its poses kept; ``before()`` runs
        once the step's lane resets and inputs are in place."""
        from fastliosam_tpu_torch.odom import ImuBatch, Scan

        t = self.t
        if t >= self.T:
            raise RuntimeError("the record buffers are full")
        self._phase("reset")
        if t > 0:
            for b in self.starting(t):
                self._reset(b, int(self.clip_no[t, b]))
        self._phase("feed")
        idx = self.scan_of[t]
        f = self.feed
        scan = Scan(f["xyz"].index_select(0, idx), f["toff"].index_select(0, idx),
                    f["mask"].index_select(0, idx))
        imu = ImuBatch(f["imu_t"].index_select(0, idx), f["imu_g"].index_select(0, idx),
                       f["imu_a"].index_select(0, idx), f["imu_m"].index_select(0, idx))
        if before is not None:
            before()
        self._phase("odom_step")
        h0 = time.perf_counter()
        self.state, aux = self.step_fn(self.state, scan, imu, self.dt, self.cfg, self.map_cfg,
                                       device=self.dev)
        host_s = time.perf_counter() - h0
        self._phase("record")
        self.rec_p[t].copy_(aux["p"])
        self.rec_R[t].copy_(aux["R"])
        self.t = t + 1
        return aux, host_s

    def lane_state(self, b: int) -> list:
        """Copies of lane ``b``'s words of the program's state: the nav
        state's nine, the map's six, then scan_idx, initialized, w_cv."""
        return [x[b].clone() for x in self._leaves(self.state)]

    def lane_map(self, b: int) -> dict:
        """Lane ``b``'s occupied voxels: their coordinates and point counts."""
        vmap = self.state.vmap
        occ = vmap.fp[b] != 0
        return {"coords": vmap.coords[b][occ].cpu().numpy(),
                "counts": vmap.moments[b][occ, 0].cpu().numpy()}


class Marks:
    """Points on the device's timeline: CUDA events on a card, the host's
    clock on the CPU (where every operation has ended when it returns)."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> np.ndarray:
        """Each mark's time after the first."""
        if self.cuda:
            self.torch.cuda.synchronize()
            first = self.marks[0]
            return np.array([first.elapsed_time(m) / 1e3 for m in self.marks])
        return np.array(self.marks) - self.marks[0]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def device_ops(prof, torch) -> tuple[list, dict]:
    """The traced window's device operations ``(name, start_ns, end_ns,
    launch_ns or None)``, sorted by start, and ``{name: [count, ns]}``."""
    cuda = torch.autograd.DeviceType.CUDA
    launch, ops = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            if ev.duration_ns() > 0:
                ops.append((ev.name(), ev.start_ns(), ev.end_ns(), ev.correlation_id()))
        elif ev.correlation_id():
            launch.setdefault(ev.correlation_id(), ev.start_ns())
    ops.sort(key=lambda o: o[1])
    by_name = {}
    for name, s, e, _ in ops:
        rec = by_name.setdefault(name, [0, 0])
        rec[0] += 1
        rec[1] += e - s
    return [(n, s, e, launch.get(c)) for n, s, e, c in ops], by_name


def busy_and_gaps(ops: list, phase_log: list) -> tuple[float, dict]:
    """The union of the operations' intervals (s), and the idle time
    between them by the host phase in which the operation after each gap
    was launched."""
    busy, gaps = 0, {}
    times = [t for t, _ in phase_log]
    end = None
    for _, s, e, launched in ops:
        if end is None or s >= end:
            if end is not None and s > end:
                i = bisect.bisect_right(times, launched) - 1 if launched else -1
                name = phase_log[i][1] if i >= 0 else "unattributed"
                gaps[name] = gaps.get(name, 0) + (s - end) / 1e9
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9, gaps


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        config: dict | None = None, traffic: dict | None = None, step=None, limits=None,
        max_window_steps: int | None = None, log=print, keep: dict | None = None) -> dict:
    """One run of a cell; returns the result (the last line's object). The
    arguments after ``device`` stand in for the cell's files in tests;
    ``keep`` receives the compared answers and the staged feed (for the
    calibration of the limits, ``calibrate.py``)."""
    import torch

    from . import check

    w, c = cell(bench, workload)
    config = load_json("configs", c["name"]) if config is None else config
    traffic = load_json("traffic", w["traffic"]) if traffic is None else traffic
    limits = load_json("limits", workload) if limits is None else limits
    dev = torch.device(device)
    window_steps = traffic["trace_steps"] if trace else int(seconds * WINDOW_STEPS_PER_S) + 1
    if max_window_steps is not None:
        window_steps = min(window_steps, max_window_steps)
    warm = traffic["warmup_steps"]
    fleet = Fleet(config, traffic, seed, dev, warm + window_steps + 1, step)
    for _ in range(warm):
        fleet.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = process_age_s()

    marks = Marks(torch, dev)
    host_ms, tr = [], {}
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        valid = torch.zeros((), dtype=torch.int64, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        matched = torch.zeros((), dtype=torch.int64, device=dev)
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        fleet.phase_log = []
        torch.cuda.set_sync_debug_mode(1)
    gc.collect()
    gc.disable()  # no collector pause inside the window
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        marks.mark()
        t_end = time.perf_counter() + seconds
        while fleet.t < warm + window_steps and time.perf_counter() < t_end:
            aux, host_s = fleet.step()
            marks.mark()
            if trace:
                host_ms.append(host_s * 1e3)
                valid += aux["cloud_mask"].sum()
                dropped += aux["n_dropped"].sum()
                matched += aux["n_matched"].sum()
        if trace:
            torch.cuda.set_sync_debug_mode(0)
    at = marks.seconds()
    gc.enable()
    steps = len(at) - 1
    if trace:
        prof.__exit__(None, None, None)
        ops, by_name = device_ops(prof, torch)
        busy_s, gaps = busy_and_gaps(ops, fleet.phase_log)
        syncs = sum("synchroniz" in str(x.message) for x in caught)
        tr = {"steps": steps, "lanes": fleet.B, "host_step_ms": host_ms, "syncs": syncs,
              "device_ops": by_name, "busy_s": busy_s, "window_s": float(at[-1]),
              "valid_points": int(valid) / steps, "dropped_points": int(dropped) / steps,
              "matched_points": int(matched) / steps,
              "config": config, "gaps": gaps}
    log(f"# steps {steps} in the window ({fleet.B} lanes a step), warm-up {warm}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the window's answers all finite; then one more step of the timed path,
    # every lane's state kept as the step takes it (for the reference's step
    # from there), and the program's state freed before the reference runs
    rec_p = fleet.rec_p[warm: fleet.t].cpu().numpy()
    rec_R = fleet.rec_R[warm: fleet.t].cpu().numpy()
    failed = int((~(np.isfinite(rec_p).all(-1) & np.isfinite(rec_R).all((-2, -1)))).sum())
    before = {}
    t_next = fleet.t
    fresh = fleet.starting(t_next)
    aux = fleet.step(lambda: before.update({b: fleet.lane_state(b) for b in range(fleet.B)}))[0]
    # the lanes that began a clip at that step, as the program's set-up and
    # the harness's reset made them
    started = {b: {"start": int(fleet.starts[b, c]), "p0": fleet.clip_p[b, c].cpu().numpy()}
               for b in fresh for c in [int(fleet.clip_no[t_next, b])]}
    after = {b: {"R": aux["R"][b].cpu().numpy(), "p": aux["p"][b].cpu().numpy(),
                 "scan": int(fleet.scan_of[t_next, b]), **fleet.lane_map(b)}
             for b in range(fleet.B)}
    feed = fleet.feed
    del fleet, aux
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings = {k: 0.0 for k in check.NUMBERS}
    t_ref = time.perf_counter()
    for b, prog in after.items():
        got = check.compare_step(prog, check.step_from(feed, prog["scan"], before[b], config))
        # a lane whose step is off counts as failed
        failed += int(not all(got[k] <= lim for k, lim in limits.items() if k in got))
        for k, v in got.items():
            readings[k] = v if not np.isfinite(v) else max(readings[k], v)
    for b, lane in started.items():
        gap = check.fresh_gap(feed, lane["start"], lane["p0"], before[b], config)
        readings["reset_gap"] = max(readings["reset_gap"], gap)
    log(f"# reference: a step of each of {len(after)} lanes, {len(started)} fresh, in "
        f"{time.perf_counter() - t_ref:.1f} s; "
        f"not judged here: { {k: v for k, v in readings.items() if k not in limits} }")
    if keep is not None:
        keep.update(feed=feed, config=config, before=before, after=after, started=list(started),
                    readings=readings)
    checks = {k: {"value": (readings[k] if np.isfinite(readings[k]) else None), "limit": lim}
              for k, lim in limits.items()}
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())

    if trace:
        metrics = per_layer(bench, workload, tr)
    else:
        n_lane_scans = steps * traffic["lanes"]
        gaps = np.diff(at)
        metrics = {
            "lane_scans_per_s": {"value": n_lane_scans / float(at[-1]), "unit": "scans/s"},
            "step_ms_p95": {"value": float(np.percentile(gaps, 95) * 1e3), "unit": "ms"},
            "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": steps * traffic["lanes"],
              "failed": failed, "metrics": metrics, "device": devinfo}
    if trace:
        devinfo["busy_s"] = tr["busy_s"]
        devinfo["window_s"] = tr["window_s"]
        top = sorted(tr["device_ops"].items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[n[:64], ns / 1e9] for n, (_, ns) in top],
            "idle_gaps": sorted(([k, v] for k, v in tr["gaps"].items()), key=lambda g: -g[1])[:10]}
    result["check"] = checks
    return result


def per_layer(bench: dict, workload: str, trace: dict, root: Path = BENCH_DIR) -> dict:
    """The per-layer metrics of ``BENCHMARK.json`` that this cell reports,
    each from its reader ``metrics/<name>.py``; a reader that finds nothing
    returns None and its metric is left out."""
    readers = files("metrics", ".py", root)
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = load_module(readers[m["name"]]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w, _ = cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(INTRA_OP_THREADS)
    print(f"# torch intra-op threads {torch.get_num_threads()}, "
          f"cpus {sorted(os.sched_getaffinity(0))}")
    print(f"# card {card_line()}; peaks 3.35 TB/s, 67 TFLOP/s float32 (700 W)")
    result = run(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
