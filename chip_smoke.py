#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastliosam_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds and runs there.

    python3 chip_smoke.py [--scans 150] [--corridor-scans 100] [--out results.json]
                          [--profile-scans N]

Phases, each of which fails the script (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi); the two sim feeds start
     generating in two worker processes (tens of seconds of host time,
     cached under build/; ``sim/world.py`` casts each time group of rays
     only against the rectangles it can reach, bit for bit the dense
     cast's), the recording of phase 9 and the feeds of phases 14 and 16
     (``eval/feeds.py``) after them (at nice 10), and the KITTI sequence
     of phase 8 in its own worker processes;
  2. build every CUDA kernel of the package from ``fastliosam_tpu_torch/csrc``
     (one nvcc per source, all started together) into ``build/kernels/``;
  3. kernel phase: the timing floor first (an empty kernel, ``csrc/empty.cu``,
     at 1 and 132 blocks, timed as the kernels are); each kernel against
     its plain PyTorch version on the card
     at the main path's shapes plus ragged ones (the gathers, the
     association and the insert bit for bit; the nearest neighbours also
     on ties planted across its destination slices, and twice for
     identical words), timed with CUDA events around back-to-back device
     work (fresh indices or queries; ``utils/timing.py``) beside the
     plain version, a one-call PyTorch yardstick that the port never calls
     (where one exists), and its bound; then the gather experiment entry
     point (``fastliosam_tpu_torch.scripts.exp_gather``), the path of
     ``take_along_axis``, with its random-read ceiling probe; the row
     gather (``gather_rows``), the plane refresh (``refresh_planes``), the
     point-to-plane normal equations (``p2pl_normal_eq``), the association
     kernel (``merged_moments``, merged3 and merged2 pools), the map
     insert's kernel (``insert_claim``) and the cached-plane query
     (``query_cached``) are checked once the figure-8 feed is made: the
     gather on the plane-refresh reads of submaps around the engine's
     keyframes after 30 scans and on the point-to-plane ICP's row reads of
     those submaps (the engine reads that now live in the next two); the plane
     refresh on those submaps' 16,384 slots into 2^14 rows and on 8192
     points a scan inserted into the engine's 2^19-slot map (the cached
     mode), rows it did not touch bit for bit, the touched ones within
     ``plane_fit_cuda.TOLERANCE`` (the share bit for bit printed), with
     ``torch.linalg.eigh`` of the same covariances as its yardstick ("eigh
     only"); the point-to-plane kernels on the ICP's inputs of those
     submaps, untrimmed and at the bench's trim, G and b within
     ``p2pl_cuda.TOLERANCE`` of their largest entries, and the whole
     ``icp_align_p2pl`` within 1e-5 m / rad of its run on the plain
     versions and replayed bit for bit; the
     association and the insert on the engine's own 2^19-slot map after 20
     scans (the association also in the merged stencil at 4 probes and the
     insert at 4 rounds, run_slam's map configuration; the insert also on
     a tight table that drops points and on an evicted map), the cached
     query on that map with its planes fitted (8192 queries, 2 probes) and
     on the submaps' surfel maps (16,384
     queries, 2^14 slots, 4 probes), plus ragged, all-masked, not-found
     and tight-table queries; and the cached-mode iEKF's rows
     (``cached_rows``) on that map: 8192 downsampled body points of each
     of its last 10 scans at the engine's poses, a probe, the device flag
     on and off, a carried association, the extrinsic's columns, ragged,
     all-masked, not-found and tight-table cases, every output bit for
     bit and two launches the same words;
  4. per-scan phase: ``SlamEngine.process`` over the figure-8 loop feed at
     the full width of the bench's loop-closing configuration (2048 x 16
     rays = 32,768 points per scan, 8192 iEKF points, a 2^19-slot map,
     16,384-point loop submaps), run twice from ``reset()``: the two runs
     must give bit-identical realtime trajectories and loop pairs, and the
     result must hold to ground truth (ATE < 0.10 m);
  5. chunked phase: ``process_chunk_deferred`` (chunk 5) over the same feed,
     twice from ``reset()`` with the same replay check, ATE < 0.10 m, at
     least one loop, at most one host read per chunk for odometry and
     keyframing;
  6. GPS phase: the bench's GPS corridor (``bench.py:
     build_corridor_sequence`` and ``bench_gps_corridor``; 100 of its 400
     scans by default, to keep the script inside its time), fixes through
     WGS84 geodesy, ``process_chunk`` with GPS on (the GPS-off run, which
     gated nothing, was cut to make room for phase 11): at least two GPS
     factors, a solve, and ATE < 2.0 m;
  7. modes phase: the figure-8 feed at the same width with the other query
     and loop-ICP modes: ``process`` per scan with the cached-plane query
     and point-to-plane loop ICP, and ``process_chunk_deferred`` with the
     merged2 query and the multi-start loop ICP of ``bench.py:
     bench_kitti_rich``; each twice from ``reset()`` (replay bit for bit),
     ATE < 0.10 m, more than 500 matches a scan from scan 3 on, a
     verification; the cached run's iEKF through ``cached_rows`` (one
     launch an iteration), ``query_cached`` launched only by the
     verifications' point-to-plane normals, its replay's last 15 scans
     traced (device operations a scan) and its host reads a scan printed;
  8. KITTI phase, the dataset entry point at the bench's width and depth
     (``bench.py: bench_kitti_longrun``): ``drive_kitti`` over the
     1160-scan synthetic KITTI circuit read by the native reader (q16
     upload, chunk 5, deferred), with a loop audit against ground truth,
     and the same run loop-free;
     ``save_results`` with its files checked;
     a checkpoint at scan 150 that a restored engine must continue over
     scans 150-250 bit for bit with the engine that saved it;
     ``MapLocalizer`` on the exported bundle (global init from a pose
     perturbed by 1 m and 5 degrees, 200 scans, every step matching
     points); and the NN, insert and plane refresh against their plain
     versions at the localizer's shapes (8192 x 2^19, 65,536 points, 65,536
     slots into 2^19 rows), printed under ``at_localizer_shape``;
  9. bag phase, the ROS-bag entry point through the port's CLI
     (``run_slam.run``, the body of ``run_slam.main``): the figure-8
     world and path of phases 4-7, started from rest, rendered at Ouster
     OS1-64 width (1024 x 64 rays, 65,536 points a scan, 150 scans, IMU at
     100 Hz) in the ``newer-college2020`` preset's LiDAR frame and written
     as the Ouster driver publishes it (``sim/writers.py``), run with
     ``--dataset bag --preset newer-college2020`` at the default 131,072
     points of capacity, twice (bit-identical trajectories and loop pairs;
     ATE < 0.10 m; a verification; the replay traced); then ``--dataset
     mulran --use-gps`` over the first 50 scans written as a MulRan
     directory (GPS factors; ATE gated) and ``--dataset newer-college``
     over their bag (the decoded scans and IMU equal ``BagSequence``'s);
 10. batched phase, the data-parallel rollout (``eval/batch_eval.py:
     batched_rollout``, the JAX package's ``vmap`` of ``odom_rollout``):
     8 lanes x 75 scans of the figure-8 feed at the per-scan phase's
     ``OdomConfig`` and map (32,768 points a scan, 8192 iEKF points,
     merged3, a 2^19-slot map per lane), lane b over scans [10 b, 10 b +
     75) from the ground truth's pose and velocity there, every step one
     pass over all lanes. Gates: each lane's ATE below max(0.10 m, the JAX
     package's reading for its window + 1 cm) (the reference reads
     0.11-0.18 m on three windows started mid-path from an empty map, whose
     first scans starve merged3's association, 0.02 m from scan 0;
     ``tests/test_torch_batch_eval.py``, slow); more than 500
     matches a scan in every lane from scan 3 on; the replay bit for bit
     (its last 15 steps traced: device operations a batched step and the
     device's idle share); lane isolation (a batch whose lane 7 carries
     lane 0's window leaves lanes 0-6 bit for bit and gives lane 7 lane
     0's bits); lane 0 within 5 mm of the unbatched ``odom_rollout`` of its
     window over the first 4 scans (the largest difference over the window
     printed); ``merged_moments`` and ``insert_claim`` launched as many
     times a step at 8 lanes as at 1; and a cached-mode batch (8 lanes x
     20 scans, ATE gated as above) that launches ``cached_rows``,
     ``refresh_planes`` and ``insert_claim`` and no ``query_cached`` (its
     probe is in ``cached_rows``; the merged3 batch launches no
     ``cached_rows``). Printed: lane-scans/s, peak device memory. Then
     the map kernels at the lane shapes, on the rollout's 8 maps: each bit
     for bit with its lane-batched plain version and, lane by lane, with
     the unbatched kernel on that lane's table alone, timed beside the
     timing floor and its byte bound (``merged_moments`` 8 x 8192 x 3 pools
     x 2 probes and a ragged 3 x 5000; ``insert_claim`` 8 x 8192 and 32 x
     8192 points, 2 rounds, one cooperative launch each; ``query_cached``
     8 x 8192; ``cached_rows`` 8 x 8192 body points, even lanes probing;
     ``gather_rows`` of (8, 2^19, 10) rows at 8 x 8192 slots,
     beside ``torch.gather`` of the same rows; ``refresh_planes`` of the
     cached batch, 8 x 8192 slots into 8 x 2^19 rows), printed under ``at_lanes``
     in the kernels line;
 11. mesh phase, mesh mode over ``torch.distributed`` (``parallel``): the
     parent has built every kernel; 4 ranks started with ``spawn`` load
     them (a rank that finds one missing fails) and join a gloo group on
     ``cuda:0`` (NCCL refuses two ranks on one card); each runs
     ``SlamEngine(mesh=make_mesh(4))`` with ``process_chunk`` (chunk 5)
     over the 150 figure-8 scans at the per-scan phase's width (32,768
     points a scan, 8192 iEKF points, merged3, a 2^19-slot map: 2^17 slots
     a rank, 2 probes; 16,384-point loop submaps, so the ICP's nearest
     neighbours run at 4096 x 16,384 a rank), loop ICP untrimmed and of a
     fixed length (``convergence_eps`` 0), twice from ``reset()``. The
     reference is the replicated engine with the same loop semantics on
     the same card, run while the ranks start. Gates: the reference's
     keyframe count, loop pairs and solve count; the realtime trajectory
     within 0.05 m of the reference at every scan; ATE < 0.10 m; every
     rank's trajectories equal rank 0's and each replay its first run, bit
     for bit; the NN launched on every rank; then one NCCL rank (world size
     1) over the first 20 scans, within 0.05 m of the reference. A failed
     rank, a collective past its timeout or a non-zero exit fails the
     phase. Printed: scans/s, host reads, collectives and their host ms a
     chunk, NN launches and peak device memory per rank, the phase's time
     (phase 16's engine parts run beside this phase in a process of their
     own: its host times read high).
     The NN kernel is also checked and timed at the rank's shape, 4096 x
     16,384 (``at_mesh_rank_shape`` in the kernels line);
 12. postprocess phase, the post-processing toolbox
     (``fastliosam_tpu_torch.postprocess``) on phase 8's export and the
     trajectories of phases 4 and 6: first the float64 k-NN kernels
     (``csrc/knn.cu``: the cell-grid search, and brute force below
     ``GRID_MIN_DST`` destinations) bit for bit with their plain version at
     k = 20 and k = 50 (``at_k50``) on 65,536 points of the exported map
     (self excluded, the SOR's use), at k = 1 on 8192 x 8192 of its points'
     xy (z = 0, the ICP-2D's use, under ``at_icp_shape``) and on
     ``scripts/exp_knn.py``'s hazard sets through both routes (cell faces,
     ties across cells, outliers, one dense cell, z = 0, queries that are
     not the points, k = M - 1, georeferenced coordinates, k above 32;
     ``hazards``), and the clustering's neighbour-voxel kernel
     (``csrc/cluster.cu``) on the 65,536 points, edges equal, each timed
     beside its plain version, ``cdist`` + ``topk`` for the k-NN, its pair
     tests a query and its bound (the pairs it tests, 8 FP64 instructions
     each at 16.75e12 a second, or its bytes; the all-pairs bound beside
     it); then both again at the main path's own inputs (``at_main_path``):
     the k-NN on the whole map at k = 20 (its ``cdist`` + ``topk`` timed
     on 4096 of the query rows only, ``library_ms_rows``) and on the
     ICP's first iteration at k = 1, the neighbour-voxel kernel on the
     SOR-kept points; then the path, counted:
     ``denoise_slam_map`` on all of the exported map (SOR 20 / 2.0,
     clusters of 0.5 m / 10 points) twice, masks bit for bit;
     ``ransac_ground_plane`` (normal within 2 degrees of +z);
     ``georeference_trajectory`` of the GPS run's keyframes against its
     fixes (mean error < 2.0 m); ``icp_2d_with_scale`` of the per-scan
     run's trajectory against its ground truth through a 30 degree, x1.05,
     100 m similarity, started 5 degrees and 2 m off (recovered within 0.5
     degrees, 0.5 m and 1e-2); ``match_trajectory`` of the georeferenced
     keyframes on the corridor's centreline, two roads 40 m off and a
     crossing road (every keyframe on the centreline, the route within 2%
     of the distance travelled); a stub TorchScript detector head loaded
     on the card, ``decode_yolo`` / ``nms`` there equal to the CPU's;
 13. measurement phase, run right after the first part of phase 3 while
     the feed and KITTI workers still run (its host times read high), in
     a spawned process of its own (a ``torch.profiler`` session leaves the
     launches of the process that ran it slower): the odometry step's
     per-stage profiling scripts at their full widths, each through its
     ``main(argv)``: ``scripts/profile_step2.py`` (9
     stages x 24 dependent iterations at 32,768 points, 8192 downsampled,
     a 2^19-slot map, merged3), ``profile_step.py`` (8 components x 20
     calls) and ``profile_insert.py`` (12 sub-stages x 30 calls), each
     stage's host ms, device ms, device operations and kernels an
     iteration; then ``bench_pgo_crossover.py`` over 128-4096 keyframes
     (the engines' 128 and 256 and the JAX script's 512-4096), dense and
     PCG, one timed solve each. Gates: every stage's outputs finite; the
     association stages launch ``merged_moments``, the insert stages
     ``insert_claim``, the gather stages ``gather_rows``, ``profile_step``'s
     insert ``refresh_planes`` (``launches_by_path`` ``measure_<script>``);
     no synchronizing call from ``core/eigh3.py`` and fewer than 6 syncs
     an iteration in ``profile_step2``'s step (its e_x fallback made
     6.04); at every size both solvers' costs finite and not above the
     starting cost (their relative gap printed), no error;
 14. pipeline phase, after phase 12 in this process while the machine is
     quiet (its scans/s are host-clock readings): the scripts that take
     their feeds and engines from ``eval/feeds.py`` (the port of
     ``bench.py``'s feed functions), on its feeds, made in a feed worker at
     nice 10 beside the earlier phases (the figure-8 feed with the bench's 10
     Hz GPS draws, 150 scans, and the 43-scan odometry feed; phases 4-12
     keep ``figure8_feed``, whose draws their accuracy references rest on):
     ``scripts/profile_pipeline.py`` (``full``, ``full_deferred``,
     ``no_verify``, ``no_kf``, a warm and one timed run each: scans/s and
     the attribution of the time to verification and solves, keyframe
     commits and chunked odometry), both probes of
     ``exp_gps_noinit_probe.py`` (the keyframe hops' drift of one deferred
     run from p0 + 2e-4 m; the identity-start rollout, twice),
     ``roofline_odom.py`` at 32,768 / 8192 points (30 steps; its flops and
     bytes against the H100's rates), ``exp_gather.py``'s XLA experiments
     and ``microbench_gather.py`` at C = 2^19, N = 8192. Gates: ``full``
     and ``full_deferred`` each close a loop and solve and launch the NN,
     the row gather, the association and the insert; ``no_verify`` closes
     no loop; ``no_kf`` keeps at most one keyframe and launches the
     association and the insert but not the NN; every variant's timed run
     equals its warm run bit for bit (trajectory, keyframes, loops,
     solves); the no-init errors finite, repeated bit for bit, their RMS at
     most the JAX package's CPU reading (``NOINIT_JAX_ATE_M``, the largest
     over its identity start and 29 starts moved by 1-100 µm) + 1 cm; the
     roofline's counts finite and positive; ``exp_c`` exact, the ``exp_d``
     window equal to its four gathers; every gather equal to the same
     function's result on the CPU bit for bit. Each line is printed beside
     the card's name and power limit;
 15. scaling phase, the port of the JAX scripts that sweep device
     counts, each through its ``main(argv)``: ``bench_scaling.py
     --keyframes 256 --devices 1 4`` (the factor-sharded solve, the
     point-sharded loop ICP at its full 16,384 points, so the NN at 4096 x
     16,384 a rank, the keyframe-sharded search over 4096 keyframes) and
     ``bench_crossover.py --sizes 256 --devices 4`` (four stages, each
     with its single twin on rank 0; the 1-rank count cut for the phase's
     time), their ranks spawned as one world of 4 gloo ranks on
     ``cuda:0``, every count a subgroup of it; and
     ``bench_pp_overlap.py --n-chunks 4`` (odometry and verification on
     ``cuda:0``; the split needs a second card). Only the sweeps' sizes and
     ``pp_overlap``'s chunks are cut (the script's time limit).
     Gates: every script exits 0 with its JSON; the solve's cost the same
     on every rank, finite and not above the cost its sharded sums start
     from, its solved positions within 1e-3 m of the 1-rank solve's
     (``build_graph``'s poses satisfy every factor, so the costs
     themselves are float32 rounding, another at each rank count); the
     ICP's fitness within 1e-4 of the
     1-rank fitness; the candidate index the 1-rank index; every crossover
     time finite and positive; ``pp_overlap``'s times positive, its
     verification flag the same in every chunk of every run and its split
     keys null with their reason; the NN launched on every rank of the ICP
     sweep, the association and the insert on the replicated voxel query
     and on ``pp_overlap``'s odometry, the NN on its verification (the
     ranks' launches, summed, under ``launches_by_path`` ``bench_scaling``,
     ``bench_crossover``, ``bench_pp_overlap``). On one card the sweeps
     measure the sharding machinery's cost (gloo collectives through host
     memory), not scaling.
 16. bench-configurations phase, last, ``bench.py``'s reference-exact and
     adversarial configurations through ``eval/feeds.py`` at full width,
     each engine run twice from ``reset()`` and replayed bit for bit
     (trajectory, keyframe poses, loops, solves, GPS factors). The
     reference-exact figure-8, the reference-exact corridor and the
     degraded GPS run in sequence in one spawned process, started before
     the mesh phase and running beside it (their gates are bits and
     accuracy; the mesh phase is a correctness run; the host-clock
     readings of both, scans/s and solve ms, read high); the Livox part
     (its kernel timings) and then the oracle run here, last, with nothing
     beside them. The parts: the Livox
     rollout (``make_rollout(data, raw_pts=8192, query_mode="merged",
     num_ds=4096)`` over the 43-scan rosette feed, ``livox_sequence``; ATE
     below max(0.10 m, ``LIVOX_JAX_ATE_M`` + 1 cm), more than 500 matches a
     scan from scan 3 on), then ``merged_moments`` (4096 points x the
     merged stencil's 7 pools x 2 probes) and ``insert_claim`` (4096
     points, 2 rounds) on its own map after 33 scans, bit for bit with
     their plain versions, timed beside the floor, the bound and the plain
     time (``at_livox_shape`` in the kernels line); the reference-exact
     figure-8 (``make_refexact(256, 512, 64)`` over the bench's 150-scan
     feed, chunk 5: a keyframe every moving scan, a solve in each chunk
     that adds one, no loop, ATE < 0.10 m) and one ``verify_loop`` with
     ``LoopConfig.reference_exact(submap_points=16384)`` between its last
     keyframe and the nearest one within 10 m and 4 s before (no surfel
     map: no ``refresh_planes`` or ``query_cached``; sqrt information
     1/sqrt(fitness) on all six axes; twice, bit for bit); the
     reference-exact corridor with GPS (``make_refexact(512, 1024, 64,
     use_gps=True)``, the corridor feed's first ``REFEXACT_CORRIDOR_SCANS``
     scans: at least 2 GPS factors and 2 solves, a solve in each chunk that
     adds a keyframe, the ATE printed beside the JAX package's CPU reading
     at that depth, not gated: the corridor is chaotic); the degraded GPS
     (``bench_gps_degraded`` on the bench's figure-8 engine: at least one
     factor, none from a fix in the degraded middle third, ATE < 0.10 m;
     ``within_2x`` and its margin against phase 14's ``full_deferred``
     ATE printed, not gated); and the long-run oracle
     (``exp_loop_trust.longrun_oracle``) on phase 8's loop-free engine
     (loops injected, the solved keyframe ATE below the odometry's,
     finite; the solve's seconds printed; its graph, the solved and the
     true keyframe positions written to ``ORACLE_GRAPH``). Launches under
     ``launches_by_path`` ``bench_*``.
Every kernel's launch count is set to 0 just before each path and read
just after; each kernel must have launched on its path (the nearest
neighbours and the plane refresh (the loop closure's surfel map) on the
loop-closing phases 4 and 5, the association and the insert on 4-6,
all four on the KITTI long run and the localizer, take_along_axis on the
experiment entry point; in phase 7 the cached query, the insert, the
plane refresh, the point-to-plane normal equations and the NN on the
cached run and the association, the insert and the NN on the merged2
run; the association, the insert, the plane refresh and the NN on the bag
run of phase 9; the association and the insert on the batched rollout of
phase 10, the cached query, the plane refresh and the insert on its
cached-mode batch; the row gather on no engine phase (4-11, 14's
variants: its engine reads live in the plane refresh and the
point-to-plane kernels); the k-NN and the neighbour-voxel
kernel on the postprocess path of phase 12; the association, the insert
and the row gather on the stages of phase 13 that run them; the NN, the
plane refresh, the association and the insert on phase 14's full variants;
the kernels of phase 15's paths as listed there; the association and
the insert on every engine path of phase 16, the NN on its
reference-exact verification and its degraded-GPS run). Phases 4-6
and 9 report the insert's, the association's, the plane refresh's and
the row gather's launches per scan, and device operations per scan over a window traced
with ``torch.profiler`` (the last 15 scans of the replay in 4 and 5, the
last 10 of the GPS run in 6, the last 30 of the replay in 9;
``engine.finish()`` included). Every phase prints its wall seconds on a
line ``phase_s {...}``, every wait for a feed (the figure-8 and corridor
feeds, the KITTI sequence, the bag recording) a line ``wait_s {...}``,
and the script its total on a line ``total_s``. With
``--profile-scans N`` an extra per-scan run, after every phase, traces its last N scans with
``torch.profiler``; it does not touch the launch counts. The line before
the last is a JSON object describing every kernel (with the timing
floor under ``timing_floor_ms``); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
KITTI_SCANS = 1160  # the bench's circuit long run (bench.py: LONGRUN_SCANS)
CORRIDOR_SCANS = 100  # of the bench's 400 GPS corridor scans: the time limit
# traced windows (device operations per scan; tracing slows the host ~5x
# while it runs): the last scans of the figure-8 replays (phases 4 and 5),
# the GPS run's last chunks (phase 6) and the bag replay's last scans (9)
TRACED_SCANS = 15
TRACED_GPS_CHUNKS = 2
TRACED_BAG_SCANS = 30


def card_line() -> str:
    """The card's name and power limit (``utils/timing.py: card_line``)."""
    from fastliosam_tpu_torch.utils.timing import card_line as line

    return line()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    from fastliosam_tpu_torch.utils.timing import device_ms

    return device_ms(fn, [()] * reps)


def launch_floor_ms(blocks: int) -> float:
    """Device time of an empty kernel (``utils/timing.py: launch_floor_ms``):
    the least time a kernel can read there."""
    from fastliosam_tpu_torch.utils.timing import launch_floor_ms as floor_ms

    return floor_ms(blocks)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def check_nn(dev, seed: int):
    """The NN kernel against its plain version: 16,384 x 16,384 with ~10%
    of destinations masked (the loop-verification shape), a ragged
    1000 x 3001 and an all-masked 64 x 256; at the main shape, exact
    duplicate destinations planted on both sides of every slice boundary
    must give exactly the lower index, and two launches the same words.
    Returns the record of the main shape."""
    import torch

    from fastliosam_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(seed)
    main = None
    for n, m, masked in ((16384, 16384, 0.1), (1000, 3001, 0.1), (64, 256, 1.0)):
        src = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 5).to(dev)
        dst = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32) * 5).to(dev)
        mask = torch.from_numpy(rng.uniform(size=m) >= masked).to(dev)
        k_idx, k_d2 = nn_cuda.nearest_neighbors_cuda(src, dst, mask)
        r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(src, dst, mask)
        torch.cuda.synchronize()
        # d2 within rtol 1e-5 / atol 1e-4; idx equal except at ties whose two
        # candidates' d2 agree within 1e-5 relative
        d2_ok = torch.isclose(k_d2, r_d2, rtol=1e-5, atol=1e-4)
        if not bool(d2_ok.all()):
            raise AssertionError(f"nn d2 mismatch at {n}x{m}: "
                                 f"{int((~d2_ok).sum())} points")
        diff = k_idx != r_idx
        if bool(diff.any()):
            s = src[diff]
            dk = ((s - dst[k_idx[diff].long()]) ** 2).sum(-1)
            dr = ((s - dst[r_idx[diff].long()]) ** 2).sum(-1)
            if not bool(torch.isclose(dk, dr, rtol=1e-5, atol=1e-6).all()):
                raise AssertionError(f"nn index mismatch (not a tie) at {n}x{m}")
        if masked == 1.0 and not (bool((k_idx == 0).all()) and bool((k_d2 == 1e12).all())):
            raise AssertionError("nn all-masked case must give idx 0, d2 1e12")
        err = float((k_d2 - r_d2).abs().max())
        print(f"  nn {n}x{m} masked~{masked:.0%}: ok, max |d2 err| {err:.3g}, "
              f"{int(diff.sum())} tie(s)")
        if main is None:
            main = (src, dst, mask, err)

    src, dst, mask, _ = main
    n, m = src.shape[0], dst.shape[0]
    slices, slice_len = nn_cuda.slice_plan(n, m)
    tsrc, tdst, tmask = src.clone(), dst.clone(), mask.clone()
    lower = []
    for k, b in enumerate(range(slice_len, slices * slice_len, slice_len)):
        p = torch.from_numpy(rng.normal(size=3).astype(np.float32) * 5).to(dev)
        tdst[b - 2] = p
        tdst[b + 1] = p
        tmask[b - 2] = tmask[b + 1] = True
        tsrc[3 * k] = p  # on the point: the expansion may round d2 below 0
        tsrc[3 * k + 1: 3 * k + 3] = p + 1e-3 * torch.from_numpy(
            rng.normal(size=(2, 3)).astype(np.float32)).to(dev)
        lower.append((3 * k, b - 2))
    i1, d1 = nn_cuda.nearest_neighbors_cuda(tsrc, tdst, tmask)
    i2, d2 = nn_cuda.nearest_neighbors_cuda(tsrc, tdst, tmask)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(d1.view(torch.int32), d2.view(torch.int32))):
        raise AssertionError("nn: two launches on the same inputs differ")
    got = i1.cpu().numpy()
    if not all(np.all(got[k: k + 3] == j) for k, j in lower):
        raise AssertionError("nn: a tie across a slice boundary did not give the lower index")
    print(f"  nn {n}x{m}: {slices} slices of {slice_len}; {len(lower)} planted ties across "
          f"slice boundaries give the lower index; two launches bit-identical")

    return _nn_record(src, dst, mask, main[3])


def _nn_record(src, dst, mask, err):
    """The NN kernel's record at these inputs: its time, the plain
    version's, ``cdist`` + min's and the bound."""
    import torch

    from fastliosam_tpu_torch.ops import nn_cuda

    n, m = src.shape[0], dst.shape[0]
    ms = cuda_ms(lambda: nn_cuda.nearest_neighbors_cuda(src, dst, mask), reps=20)
    plain_ms = cuda_ms(lambda: nn_cuda.nearest_neighbors_ref(src, dst, mask), reps=5)

    def library():  # one cdist + masked min: the yardstick, unused by the port
        d = torch.cdist(src, dst)
        return d.masked_fill_(~mask[None, :], float("inf")).min(dim=1)

    library_ms = cuda_ms(library, reps=5)
    # least time: 8 float32 operations per (source, valid destination) pair
    # against the float32 rate; each input read once, each output written once
    ops = 8.0 * n * int(mask.sum())
    nbytes = n * 12 + m * 12 + m + n * 8
    t_ops, t_bytes = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    print(f"  nn {n}x{m}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+min {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms")
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def check_nn_rank_shape(dev, seed: int, n: int = 4096, m: int = 16384):
    """The NN kernel at the mesh ICP's shape a rank (a quarter of the
    16,384 source points against the whole 16,384-point destination, ~10%
    masked) against its plain version, timed as :func:`check_nn` times it."""
    import torch

    from fastliosam_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(seed + 1)
    src = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 5).to(dev)
    dst = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32) * 5).to(dev)
    mask = torch.from_numpy(rng.uniform(size=m) >= 0.1).to(dev)
    k_idx, k_d2 = nn_cuda.nearest_neighbors_cuda(src, dst, mask)
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(src, dst, mask)
    torch.cuda.synchronize()
    if not bool(torch.isclose(k_d2, r_d2, rtol=1e-5, atol=1e-4).all()):
        raise AssertionError(f"nn d2 mismatch at {n}x{m}")
    diff = k_idx != r_idx
    if bool(diff.any()):
        s = src[diff]
        dk = ((s - dst[k_idx[diff].long()]) ** 2).sum(-1)
        dr = ((s - dst[r_idx[diff].long()]) ** 2).sum(-1)
        if not bool(torch.isclose(dk, dr, rtol=1e-5, atol=1e-6).all()):
            raise AssertionError(f"nn index mismatch (not a tie) at {n}x{m}")
    err = float((k_d2 - r_d2).abs().max())
    print(f"  nn {n}x{m} (the mesh ICP's shape a rank): ok, max |d2 err| {err:.3g}, "
          f"{int(diff.sum())} tie(s)")
    rec = _nn_record(src, dst, mask, err)
    rec["shape"] = [n, m]
    return rec


def check_gather(dev, seed: int, plane_sets, surfel_cfg):
    """The row gather against its plain version, bit for bit, at the shapes
    of the engine reads that ``refresh_planes`` and ``p2pl_normal_eq`` now
    make in their own kernels: the loop closure's plane refresh (on the
    throwaway map of ``loop/closure.py: _dst_surfel_map``), which reads the
    (2^14, 10) moments and the (2^14, 3) int32 voxel coordinates at the
    16,384 int64 slots of the submap's insert (``plane_sets``, one set per
    submap); the point-to-plane ICP's row reads, which
    read the submap (16,384, 3), its normals from ``query_planes`` on that
    surfel map (``surfel_cfg``) and their 1-D int32 valid flags at the
    int32 nearest-neighbour indices of a copy of the submap shifted by
    (0.2, 0.2, 0) m; and a ragged 1000 x 3 case with a found-mask and
    negative and out-of-range indices. Each is timed over its sets beside
    the plain version and (unmasked) ``torch.index_select`` (experiments A
    and B's shapes are timed by the experiment entry point). Returns the
    record of the moment read with the p2pl reads' under ``at_p2pl_rows``
    (the kernels line) and every case's record."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import gather_cuda, nn_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    p2pl = []  # (dst, normals, nvalid, nn_idx) per submap
    shift = torch.tensor([0.2, 0.2, 0.0], device=dev)
    for *_, sm, dst, dmask in plane_sets:
        nrm, _, nvalid = vh.query_planes(sm, surfel_cfg, dst, dmask)
        nn_idx = nn_cuda.nearest_neighbors((dst + shift).contiguous(), dst, dmask)[0]
        p2pl.append((dst, nrm, nvalid.to(torch.int32), nn_idx))
    rng = np.random.default_rng(seed)
    ragged = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(1000, 3),
                                           dtype=np.int64).astype(np.int32)).to(dev)
    cases = {  # name: [(table, idx, valid)] with fresh indices per set
        "plane_moments": [(mom, sl, None) for mom, _, sl, *_ in plane_sets],
        "plane_coords": [(crd, sl, None) for _, crd, sl, *_ in plane_sets],
        "p2pl_points": [(dst, i, None) for dst, _, _, i in p2pl],
        "p2pl_normals": [(nrm, i, None) for _, nrm, _, i in p2pl],
        "p2pl_nvalid": [(nv, i, None) for _, _, nv, i in p2pl],
        "ragged": [(ragged, torch.from_numpy(rng.integers(-2000, 2000, size=1000)
                                             .astype(np.int32)).to(dev),
                    torch.from_numpy(rng.uniform(size=1000) > 0.3).to(dev))
                   for _ in range(10)],
    }
    records = {}
    for name, sets in cases.items():
        for table, idx, val in sets:
            got = gather_cuda.gather_rows_cuda(table, idx, val)
            want = gather_cuda.gather_rows_ref(table, idx, val)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                          want.view(torch.int32)):
                raise AssertionError(f"gather_rows {name}: kernel and plain version differ")
        ms = device_ms(gather_cuda.gather_rows_cuda, sets)
        plain_ms = device_ms(gather_cuda.gather_rows_ref, sets)
        library_ms = None
        if name != "ragged":
            # index_select raises on the slot C of unassigned points, so it
            # reads the slots clamped to C - 1 beforehand: the same rows (the
            # nearest-neighbour indices are in range already)
            clamped = [(t, i.clamp(max=t.shape[0] - 1)) for t, i, _ in sets]
            library_ms = device_ms(lambda t, i: torch.index_select(t, 0, i), clamped)
        table, idx, val = sets[0]
        c, d = table.shape[0], (table.shape[1] if table.dim() == 2 else 1)
        nbytes = float(np.mean([gather_cuda.hbm_bytes(i.cpu().numpy(), d, c,
                                                      None if v is None else v.cpu().numpy())
                                for _, i, v in sets]))
        rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "library_ms": library_ms, "table": list(table.shape), "n": idx.shape[0],
               "index": str(idx.dtype), "sets": len(sets), "bytes": nbytes}
        records[name] = rec
        lib = "n/a (masked)" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  gather_rows {name} {tuple(table.shape)} x {idx.shape[0]} {idx.dtype}, "
              f"{len(sets)} sets: equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_select {lib}, bound {rec['bound_ms']:.5f} ms ({nbytes:.0f} HBM bytes)")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main = {k: records["plane_moments"][k] for k in keys}
    main["at_p2pl_rows"] = {name: {k: records[name][k] for k in keys}
                            for name in ("p2pl_points", "p2pl_normals", "p2pl_nvalid")}
    return main, records


EIGH_ROWS = 32768  # the refresh's yardstick: eigh of at most this many covariances


def check_refresh_planes(dev, label: str, sets, cfg, floor_ms: float, repeat: int = 1) -> dict:
    """The plane refresh kernel against its plain version on ``sets`` (each
    ``(moments, coords, slots, normal, d, plane_valid)`` at one of the main
    path's shapes, fresh slots per set): every set compared
    (``plane_fit_cuda.compare``), the kernel twice on the first set bit for bit,
    lane-major sets also lane by lane against the unbatched kernel, bit for
    bit; then timed over the sets (``repeat`` times over) beside the plain version, the launch
    floor, its byte bound (``plane_fit_cuda.hbm_bytes``) and, as the
    yardstick, ``torch.linalg.eigh`` of the same float32 covariances
    ("eigh only": no PyTorch call reads the rows, fits and writes the
    planes). Returns the record."""
    import torch

    from fastliosam_tpu_torch.ops import plane_fit_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    def same(xs, ys):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(xs, ys))

    tail = (cfg.voxel_size, cfg.min_points, cfg.plane_var_thresh)
    moments = sets[0][0]
    lm = moments.dim() == 3
    lanes, cap = (moments.shape[0] if lm else 1), moments.shape[-2]
    diffs = []
    for args in sets:
        got = plane_fit_cuda.refresh_planes_cuda(*args, *tail)
        want = plane_fit_cuda.refresh_planes_ref(*args, *tail)
        torch.cuda.synchronize()
        diffs.append(plane_fit_cuda.compare(got, want, *args[:3], cfg.voxel_size,
                                            cfg.plane_var_thresh))
        if lm:
            for b in range(lanes):
                one = plane_fit_cuda.refresh_planes_cuda(*(t[b] for t in args), *tail)
                if not same((x[b] for x in got), one):
                    raise AssertionError(f"refresh_planes {label}: lane {b} differs from the "
                                         "unbatched kernel on its table")
    first = plane_fit_cuda.refresh_planes_cuda(*sets[0], *tail)
    second = plane_fit_cuda.refresh_planes_cuda(*sets[0], *tail)
    torch.cuda.synchronize()
    if not same(first, second):
        raise AssertionError(f"refresh_planes {label}: two launches on the same inputs differ")
    bad = [d for d in diffs if not d["ok"]]
    if bad:
        raise AssertionError(f"refresh_planes {label}: kernel and plain version differ beyond "
                             f"plane_fit_cuda.TOLERANCE: {bad[0]}")
    ms = device_ms(lambda *a: plane_fit_cuda.refresh_planes_cuda(*a, *tail), sets * repeat)
    plain_ms = device_ms(lambda *a: plane_fit_cuda.refresh_planes_ref(*a, *tail), sets * repeat)
    # the yardstick: eigh of the covariances of the voxels the refresh fits
    # (each touched row once; cuSOLVER's batched eigh refuses a batch of
    # 65,536, so at most EIGH_ROWS of them)
    covs = []
    for mo, _, sl, *_ in sets:
        flat = mo.reshape(-1, 10)
        live = sl.reshape(lanes, -1)
        live = (live + torch.arange(lanes, device=sl.device)[:, None] * cap)[live < cap]
        rows = flat[live.unique()[:EIGH_ROWS]]
        c = rows[:, 0].clamp(min=1.0)
        mean = rows[:, 1:4] / c[:, None]
        covs.append((plane_fit_cuda.unpack_sym(rows[:, 4:10]) / c[:, None, None]
                     - mean[:, :, None] * mean[:, None, :],))
    library_ms = device_ms(torch.linalg.eigh, covs * repeat)
    nbytes = float(np.mean([plane_fit_cuda.hbm_bytes(a[2].cpu().numpy(), cap, lanes)
                            for a in sets]))
    rows = sum(d["rows"] for d in diffs)
    same = sum(d["rows_bit_for_bit"] for d in diffs)
    worst = {k: max(d[k] for d in diffs) for k in ("max_normal_err", "max_d_err",
                                                   "max_one_minus_dot")}
    rec = {"shape": label, "max_abs_err": max(worst["max_normal_err"], worst["max_d_err"]),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": library_ms,
           "library_note": "eigh only: torch.linalg.eigh of the touched voxels' float32 "
                           "covariances", "library_rows": int(np.mean([c.shape[0]
                                                                    for (c,) in covs])),
           "timing_floor_ms": floor_ms, "sets": len(sets), "rows": rows,
           "rows_bit_for_bit_share": same / max(rows, 1),
           "sign_flips": sum(d["sign_flips"] for d in diffs),
           "valid_differs": sum(d["valid_differs"] for d in diffs), **worst, "bytes": nbytes}
    print(f"  refresh_planes {label}, {len(sets)} sets: within tolerance, "
          f"{rec['rows_bit_for_bit_share']:.2%} of {rows} touched rows bit for bit "
          f"({rec['sign_flips']} sign flips, {rec['valid_differs']} plane_valid differ; max "
          f"|dn| {worst['max_normal_err']:.3g}, |dd| {worst['max_d_err']:.3g} m, "
          f"1 - |n.n_ref| {worst['max_one_minus_dot']:.3g}), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, eigh only {library_ms:.4f} ms ({rec['library_rows']} covariances), "
          f"bound {rec['bound_ms']:.5f} ms "
          f"({nbytes:.0f} HBM bytes), floor {floor_ms:.4f} ms")
    return rec


def check_plane_refresh(dev, feed, fig8, floor_ms: float, n_map_scans: int = 20,
                        reps: int = 10) -> dict:
    """The plane refresh kernel at the engine's two shapes: the loop
    closure's (``loop/closure.py: _dst_surfel_map``: each plane-refresh
    submap's 16,384 slots into its fresh 2^14-slot map) and the cached
    query mode's (8192 points of each of the engine map's last ``reps``
    scans inserted into the 2^19-slot figure-8 map with its planes fitted,
    as ``odom/pipeline.py`` refreshes it each scan). Returns the loop
    closure's record (the kernels line) with the cached mode's under
    ``at_cached_mode``."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda

    m, cfg, traj, plane_sets, surfel_cfg, _ = fig8
    empty = vh.make_map(surfel_cfg, dev)
    loop_sets = [(mom, crd, sl, empty.normal, empty.d, empty.plane_valid)
                 for mom, crd, sl, *_ in plane_sets]
    rec = check_refresh_planes(dev, f"(2^{surfel_cfg.capacity.bit_length() - 1}, 10) x "
                               f"{plane_sets[0][2].shape[0]} int64 slots (the loop closure's "
                               "surfel map)", loop_sets, surfel_cfg, floor_ms)
    cm = _cached_map(m, cfg)
    rounds = max(cfg.insert_probes, cfg.claim_probes)
    cached_sets = []
    for xyz in _scan_queries(dev, feed, traj, range(n_map_scans - reps, n_map_scans),
                             seed=n_map_scans + 2):
        ones = torch.ones(xyz.shape[0], dtype=torch.bool, device=dev)
        sl = insert_cuda.insert_claim_cuda(cm.fp, cm.coords, cm.moments, xyz, ones,
                                           cfg.voxel_size, rounds, cfg.max_points_per_voxel)[2]
        m2, _ = vh.insert(cm, cfg, xyz, ones, refresh_planes=False)
        cached_sets.append((m2.moments, m2.coords, sl, cm.normal, cm.d, cm.plane_valid))
    rec["at_cached_mode"] = check_refresh_planes(
        dev, f"(2^{cfg.capacity.bit_length() - 1}, 10) x 8192 int64 slots (the cached "
        "mode's insert)", cached_sets, cfg, floor_ms)
    return rec


P2PL_ICP_SETS = 3  # the whole ICP runs three times a set: on the first three sets


def check_p2pl(dev, fig8, floor_ms: float) -> dict:
    """The point-to-plane ICP kernels against their plain versions on the
    loop closure's p2pl inputs (``check_gather``'s sets: each submap
    (16,384 points) against itself shifted by (0.2, 0.2, 0) m, its normals
    and valid flags from its surfel map, the NN kernel's neighbours, the
    bench's loop ``max_corr_dist``): ``normal_eq`` untrimmed and at the
    bench's trim (its threshold from ``corr_keys``, bit for bit with its
    plain version), G and b within ``p2pl_cuda.TOLERANCE`` of their
    largest entries, two launches bit for bit; then ``icp_align_p2pl`` on
    the first ``P2PL_ICP_SETS`` sets with the kernels and with their plain
    versions swapped in,
    final T within 1e-5 m / 1e-5 rad, and replayed bit for bit. Timed over
    the sets beside the plain version, the launch floor and its byte
    bound. Returns the record (the kernels line)."""
    import torch

    from fastliosam_tpu_torch.loop import icp
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import nn_cuda, p2pl_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    _, _, _, plane_sets, surfel_cfg, lc = fig8
    max_corr = lc.radius * lc.max_corr_factor
    max_d2 = max_corr * max_corr
    shift = torch.tensor([0.2, 0.2, 0.0], device=dev)
    sets, thrs, err, rel = [], [], 0.0, 0.0
    for *_, sm, dst, dmask in plane_sets:
        nrm, _, nvalid = vh.query_planes(sm, surfel_cfg, dst, dmask)
        ps = (dst + shift).contiguous()
        idx, d2 = nn_cuda.nearest_neighbors(ps, dst, dmask)
        sets.append((ps, idx, d2, dmask, dst, nrm.contiguous(), nvalid.contiguous()))
    n = sets[0][0].shape[0]
    for s in sets:
        ps, idx, d2, mask, dst, nrm, nvalid = s
        ck, kk = p2pl_cuda.corr_keys_cuda(idx, d2, mask, nvalid, max_d2)
        cp, kp = p2pl_cuda.corr_keys_ref(idx, d2, mask, nvalid, max_d2)
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(kk.view(torch.int32), kp.view(torch.int32))):
            raise AssertionError("p2pl corr_keys: kernel and plain version differ")
        thr = icp._trim_threshold(cp, kp, n, lc.trim_fraction)
        thrs.append(thr)
        for t in (None, thr):
            G, b = p2pl_cuda.normal_eq_cuda(*s, max_d2, t)
            G2, b2 = p2pl_cuda.normal_eq_cuda(*s, max_d2, t)
            Gp, bp = p2pl_cuda.normal_eq_ref(*s, max_d2, t)
            torch.cuda.synchronize()
            if not (torch.equal(G, G2) and torch.equal(b, b2)):
                raise AssertionError("p2pl normal_eq: two launches on the same inputs differ")
            gm, bm = float(Gp.abs().max()), float(bp.abs().max())
            e_g, e_b = float((G - Gp).abs().max()), float((b - bp).abs().max())
            err = max(err, e_g, e_b)
            rel = max(rel, e_g / max(gm, 1e-30), e_b / max(bm, 1e-30))
    if rel > p2pl_cuda.TOLERANCE:
        raise AssertionError(f"p2pl normal_eq: kernel and plain version differ by {rel:.3g} of "
                             f"their largest entries (tolerance {p2pl_cuda.TOLERANCE})")

    # the whole ICP: the kernels, their replay, and the plain versions swapped in
    kw = dict(max_iterations=lc.max_iterations, max_corr_dist=max_corr,
              trim_fraction=lc.trim_fraction, convergence_eps=lc.convergence_eps)
    t_err, r_err = 0.0, 0.0
    for ps, _, _, mask, dst, nrm, nvalid in sets[:P2PL_ICP_SETS]:
        args = (ps, mask, dst, mask, nrm, nvalid)
        T1 = icp.icp_align_p2pl(*args, **kw)[0]
        T2 = icp.icp_align_p2pl(*args, **kw)[0]
        swapped = (p2pl_cuda.normal_eq, p2pl_cuda.corr_keys)
        p2pl_cuda.normal_eq, p2pl_cuda.corr_keys = p2pl_cuda.normal_eq_ref, p2pl_cuda.corr_keys_ref
        try:
            Tp = icp.icp_align_p2pl(*args, **kw)[0]
        finally:
            p2pl_cuda.normal_eq, p2pl_cuda.corr_keys = swapped
        if not torch.equal(T1, T2):
            raise AssertionError("icp_align_p2pl on the kernels: the replay differs")
        a, b = T1.double().cpu().numpy(), Tp.double().cpu().numpy()
        t_err = max(t_err, float(np.abs(a[:3, 3] - b[:3, 3]).max()))
        r_err = max(r_err, float(2 * np.arcsin(min(1.0, np.linalg.norm(a[:3, :3] - b[:3, :3])
                                                   / (2 * np.sqrt(2))))))
    if t_err > 1e-5 or r_err > 1e-5:
        raise AssertionError(f"icp_align_p2pl: kernels and plain versions end {t_err:.3g} m / "
                             f"{r_err:.3g} rad apart (gate 1e-5)")

    ms = device_ms(lambda *s: p2pl_cuda.normal_eq_cuda(*s, max_d2), sets)
    plain_ms = device_ms(lambda *s: p2pl_cuda.normal_eq_ref(*s, max_d2), sets)
    trim_sets = [s + (t,) for s, t in zip(sets, thrs)]
    ms_trim = device_ms(lambda *s: p2pl_cuda.normal_eq_cuda(*s[:-1], max_d2, s[-1]), trim_sets)
    keys_ms = device_ms(lambda ps, idx, d2, mask, dst, nrm, nv: p2pl_cuda.corr_keys_cuda(
        idx, d2, mask, nv, max_d2), sets)
    nbytes = []
    for ps, idx, d2, mask, dst, nrm, nvalid in sets:
        live = (mask & (d2 < max_d2)).cpu().numpy()
        w = p2pl_cuda.corr_keys_ref(idx, d2, mask, nvalid, max_d2)[0].cpu().numpy()
        nbytes.append(p2pl_cuda.hbm_bytes(idx.cpu().numpy(), live, w, dst.shape[0]))
    nbytes = float(np.mean(nbytes))
    rec = {"shape": f"{n} points against the {sets[0][4].shape[0]}-point submap "
                    f"(max_corr_dist {max_corr} m)",
           "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
           "library_note": "none: no PyTorch call reads the rows and forms the normal "
                           "equations", "ms_trimmed": ms_trim, "corr_keys_ms": keys_ms,
           "timing_floor_ms": floor_ms, "sets": len(sets), "bytes": nbytes,
           "icp_T_err_m": t_err, "icp_R_err_rad": r_err}
    print(f"  p2pl_normal_eq {rec['shape']}, {len(sets)} sets: G and b within {rel:.3g} of "
          f"their largest entries (max |err| {err:.3g}); ICP's T {t_err:.3g} m / {r_err:.3g} "
          f"rad from the plain versions', its replay bit for bit; kernel {ms:.4f} ms (trimmed "
          f"{ms_trim:.4f}, corr_keys {keys_ms:.4f}), plain {plain_ms:.4f} ms, library none, "
          f"bound {rec['bound_ms']:.5f} ms ({nbytes:.0f} HBM bytes), floor {floor_ms:.4f} ms")
    return rec


def plane_refresh_sets(dev, engine, n_sets: int = 10):
    """The inputs of the loop closure's plane refresh, as
    ``loop/closure.py: _dst_surfel_map`` makes them: the submap
    (``build_submap``) around each of up to ``n_sets`` of the engine's
    keyframes (from the middle of its store) inserted into a throwaway
    2^14-slot map. Returns ``(moments (2^14, 10), coords (2^14, 3), sl
    (16,384,) int64, map, dst (16,384, 3), mask)`` for each: the tables
    after the insert, the slots it gave, and the refreshed map with the
    submap, the point-to-plane ICP's normal query; that map's config; and
    the engine's loop config."""
    from fastliosam_tpu_torch.loop.closure import _dst_surfel_map, build_submap
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda

    lc, kf = engine.loop_cfg, engine.kf
    lo = max(0, (kf.n - n_sets) // 2)
    out, cfg = [], None
    for centre in range(lo, min(kf.n, lo + n_sets)):
        dst, mask = build_submap(kf.clouds, kf.masks, engine.graph.poses,
                                 engine.graph.kf_valid, centre, lc)
        dst, mask = dst.contiguous(), mask.contiguous()
        m, cfg = _dst_surfel_map(dst, mask, lc)
        empty = vh.make_map(cfg, dev)
        sl = insert_cuda.insert_claim(
            empty.fp, empty.coords, empty.moments, dst, mask, cfg.voxel_size,
            max(cfg.insert_probes, cfg.claim_probes), cfg.max_points_per_voxel)[2]
        out.append((m.moments, m.coords, sl, m, dst, mask))
    return out, cfg, lc


def figure8_map(dev, feed, n_map_scans: int = 20, n_more: int = 10):
    """The engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``SlamEngine.process``, 2 probes), its config, the engine's poses of
    the first ``n_map_scans + n_more`` scans (a second run from
    ``reset()``, which replays the first bit for bit) and the plane-refresh
    inputs of loop-closure submaps around its keyframes then with their
    surfel maps' config and the loop config (``plane_refresh_sets``)."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev)
    run_engine(engine, feed, dev, n_map_scans)
    m = type(engine.odom.vmap)(*(t.clone() for t in engine.odom.vmap))
    run_engine(engine, feed, dev, n_map_scans + n_more)
    return (m, engine.map_cfg, np.stack(engine.realtime_traj).astype(np.float32),
            *plane_refresh_sets(dev, engine))


def _scan_queries(dev, feed, traj, ks, seed: int, n: int = 8192):
    """``n`` points of each scan ``k`` in ``ks`` at the engine's pose of
    scan ``k`` (world frame, not deskewed), as its iEKF queries them."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for k in ks:
        pose = torch.from_numpy(traj[k]).to(dev)
        keep = np.nonzero(feed["mask"][k])[0]
        pick = torch.from_numpy(np.sort(rng.choice(keep, n, replace=False))).to(dev)
        xyz = torch.from_numpy(feed["xyz"][k]).to(dev)[pick] @ pose[:3, :3].T + pose[:3, 3]
        out.append(xyz.contiguous())
    return out


def check_assoc(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The association kernel against its plain version, bit for bit: the
    engine's own 2^19-slot map after ``n_map_scans`` figure-8 scans
    (``figure8_map``), queried with 8192 points of each of its last
    ``reps`` scans at the engine's poses (world frame, not deskewed), in the
    merged3 pools (3 per query), the merged2 pools (2 per query) and the
    merged stencil (7 per query, 4 probes). Each is timed over those fresh
    query sets beside the plain version. Returns the record of merged3 (the
    kernels line) with merged2's under
    ``at_merged2``, and the merged stencil's (7 pools at the map's default
    4 probes: run_slam's bag, MulRan and Newer College paths) under
    ``at_merged``."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import assoc_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, *_ = fig8
    fp_np = m.fp.cpu().numpy()
    queries = _scan_queries(dev, feed, traj, range(n_map_scans - reps, n_map_scans),
                            seed=n_map_scans)
    args = (m.fp, m.moments)
    recs = {}
    # the bench's pools and probes, and run_slam's (the merged stencil at
    # the map's default probe count: the bag, MulRan and Newer College paths)
    for mode, pools_fn, probes in (
            ("merged3", vh.merged3_pools, cfg.query_probes),
            ("merged2", vh.merged2_pools, cfg.query_probes),
            ("merged", vh.merged_pools, vh.VoxelMapConfig().query_probes)):
        tail = (cfg.voxel_size, probes)
        sets, nbytes = [], []
        for xyz in queries:
            coords0, pools = pools_fn(xyz, cfg.voxel_size)
            mask = torch.ones(8192, dtype=torch.bool, device=dev)
            sets.append((pools, coords0, mask))
            nbytes.append(assoc_cuda.hbm_bytes(fp_np, pools, coords0, probes))
        found_share = []
        for pools, coords0, mask in sets:
            got = assoc_cuda.merged_moments_cuda(*args, pools, coords0, mask, *tail)
            want = assoc_cuda.merged_moments_ref(*args, pools, coords0, mask, *tail)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"merged_moments {mode}: kernel and plain version differ")
            found_share.append(float((got[:, 0] > 0).float().mean()))
        ms = device_ms(lambda p, c, k: assoc_cuda.merged_moments_cuda(*args, p, c, k, *tail),
                       sets)
        plain_ms = device_ms(
            lambda p, c, k: assoc_cuda.merged_moments_ref(*args, p, c, k, *tail), sets)
        bound_ms = float(np.mean(nbytes)) / H100_BYTES_PER_S * 1e3
        n_pools = sets[0][0].shape[0]
        print(f"  merged_moments {mode} (2^{cfg.capacity.bit_length() - 1}-slot map after "
              f"{n_map_scans} figure-8 scans) 8192 x {n_pools} pools x "
              f"{probes} probes, {reps} query sets: equal, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({np.mean(nbytes):.0f} HBM bytes), "
              f"voxels found {np.mean(found_share):.1%} of queries; "
              f"map holds {int((fp_np != 0).sum())} voxels")
        recs[mode] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes", "library_ms": None, "pools": n_pools, "probes": probes,
                      "library_note": "no single PyTorch call probes a hash table and "
                                      "merges moments"}
    return dict(recs["merged3"], at_merged2=recs["merged2"], at_merged=recs["merged"])


def _cached_map(m, cfg):
    """The map with the cached plane of every occupied voxel fitted, as the
    cached query mode's insert keeps it (``ops/plane_fit_cuda.py:
    refresh_planes`` at every occupied slot)."""
    import torch

    from fastliosam_tpu_torch.ops import plane_fit_cuda

    occ = torch.nonzero(m.fp != 0)[:, 0]
    normal, d, plane_valid = plane_fit_cuda.refresh_planes(
        m.moments, m.coords, occ, m.normal, m.d, m.plane_valid, cfg.voxel_size,
        cfg.min_points, cfg.plane_var_thresh)
    return m._replace(normal=normal, d=d, plane_valid=plane_valid)


def check_query(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The cached-plane query kernel against its plain version, bit for bit
    (normal, d and valid), at the two shapes of the main path: the cached
    mode's odometry, 8192 points of each of the engine map's last ``reps``
    scans (as ``check_assoc``) against the 2^19-slot figure-8 map with
    every occupied voxel's plane fitted, 2 probes; and the point-to-plane
    ICP's normals, the 16,384 points of each plane-refresh submap against
    its own 2^14-slot surfel map, 4 probes. Also ragged (8191 + 77 points,
    every 13th masked), all queries masked, queries that find nothing
    (slot 0's row, never valid), and a tight 2^12 table that dropped
    points. Each main shape is timed beside the plain version and the
    plain probe with three ``index_select`` row reads. Returns the record
    of the odometry shape (the kernels line) with the p2pl shape's under
    ``at_p2pl_shape``."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import query_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, plane_sets, surfel_cfg, _ = fig8
    mc = _cached_map(m, cfg)
    queries = _scan_queries(dev, feed, traj, range(n_map_scans - reps, n_map_scans),
                            seed=n_map_scans + 1)
    ones = torch.ones(8192, dtype=torch.bool, device=dev)
    shapes = {
        "odometry": (mc, cfg, [(xyz, ones) for xyz in queries]),
        "p2pl": (None, surfel_cfg, [(sm, dst, dmask) for *_, sm, dst, dmask in plane_sets]),
    }

    def args_of(name, item):
        m_, c_, _ = shapes[name]
        if name == "odometry":
            xyz, mask = item
            return (m_.fp, m_.normal, m_.d, m_.plane_valid, xyz, mask, c_.voxel_size,
                    c_.query_probes)
        sm, dst, dmask = item
        return (sm.fp, sm.normal, sm.d, sm.plane_valid, dst, dmask, c_.voxel_size,
                c_.query_probes)

    def compare(name, args):
        got = query_cuda.query_cached_cuda(*args)
        want = query_cuda.query_cached_ref(*args)
        torch.cuda.synchronize()
        same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
                and torch.equal(got[2], want[2]))
        if not same:
            raise AssertionError(f"query_cached {name}: kernel and plain version differ")
        return got

    def plain_probe_index_select(fp, normal, d, pv, xyz, mask, vs, probes):
        from fastliosam_tpu_torch.core.voxel import voxel_coords

        slots, _ = query_cuda.find_slots_ref(fp, voxel_coords(xyz, vs), mask, probes)
        sl = slots.clamp(min=0)
        return (torch.index_select(normal, 0, sl), torch.index_select(d, 0, sl),
                torch.index_select(pv, 0, sl))

    recs = {}
    for name, (_, c_, items) in shapes.items():
        sets = [args_of(name, it) for it in items]
        valid_share = [float(compare(name, a)[2].float().mean()) for a in sets]
        ms = device_ms(query_cuda.query_cached_cuda, sets)
        plain_ms = device_ms(query_cuda.query_cached_ref, sets)
        composed_ms = device_ms(plain_probe_index_select, sets)
        nbytes = float(np.mean([query_cuda.hbm_bytes(*(a[i] for i in (0, 4, 5, 6, 7)))
                                for a in sets]))
        recs[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
                      "library_ms": None,
                      "library_note": "none: no PyTorch call probes a hash table",
                      "plain_probe_and_index_select_ms": composed_ms,
                      "n": int(sets[0][4].shape[0]), "capacity": c_.capacity,
                      "probes": c_.query_probes, "sets": len(sets), "bytes": nbytes,
                      "valid_share": float(np.mean(valid_share))}
        print(f"  query_cached {name}: {recs[name]['n']} queries x 2^"
              f"{c_.capacity.bit_length() - 1} slots, {c_.query_probes} probes, {len(sets)} "
              f"sets: equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, plain probe + 3 "
              f"index_select {composed_ms:.4f} ms, bound {recs[name]['bound_ms']:.5f} ms "
              f"({nbytes:.0f} HBM bytes), valid {np.mean(valid_share):.1%}")

    # the edge cases, bit for bit
    xyz0 = queries[0]
    far = (torch.full((77, 3), 900.0, device=dev)
           + torch.arange(77, device=dev, dtype=torch.float32)[:, None])
    ragged = torch.cat([xyz0[:8191], far]).contiguous()
    rmask = torch.ones(len(ragged), dtype=torch.bool, device=dev)
    rmask[::13] = False
    got = compare("ragged", args_of("odometry", (ragged, rmask)))
    if bool(got[2][-77:].any()) or not torch.equal(got[0][-77:], mc.normal[0].expand(77, 3)):
        raise AssertionError("query_cached: a query that finds nothing must read slot 0, "
                             "not valid")
    compare("all masked", args_of("odometry", (xyz0, torch.zeros_like(ones))))
    compare("not found", args_of("odometry", (far.contiguous(), ones[:77])))
    tight_cfg = vh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=5,
                                  query_probes=4)
    tight, dropped = vh.insert(vh.make_map(tight_cfg, dev), tight_cfg,
                               torch.cat(queries[:2]).contiguous(), torch.cat([ones, ones]))
    if int(dropped) == 0:
        raise AssertionError("query_cached tight case: the 2^12 table must overflow")
    compare("tight 2^12", (tight.fp, tight.normal, tight.d, tight.plane_valid, xyz0, ones,
                           0.5, 4))
    print(f"  query_cached: equal on the ragged, all-masked, not-found and tight 2^12 "
          f"({int(dropped)} of 16384 points dropped) cases")
    return dict(recs["odometry"], at_p2pl_shape=recs["p2pl"])


def _downsampled_body(feed, k, dev, budget: int = 8192):
    """Scan ``k``'s points downsampled as the odometry downsamples them
    (0.5 m voxels, the first ``budget`` of the packed output) in the body
    frame (not deskewed): the iEKF's ``(pts_body, mask)``."""
    import torch

    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample

    ds = voxel_downsample(Cloud(torch.from_numpy(feed["xyz"][k]).to(dev),
                                torch.from_numpy(feed["mask"][k]).to(dev)), 0.5)
    return ds.xyz[:budget].contiguous(), ds.mask[:budget].contiguous()


def check_cached_rows(dev, feed, fig8, floor_ms: float, n_map_scans: int = 20,
                      reps: int = 10) -> dict:
    """The cached-mode iEKF's rows (``cached_rows``) against their plain
    version, bit for bit on every output (normals, residuals, valid flags,
    rows, weighted rows, confident weights, ``n * wc``, the match count and
    the association's slots), at the main path's shape: each of the engine
    map's last ``reps`` scans downsampled to 8192 body points at the
    engine's pose of that scan, against the 2^19-slot figure-8 map with
    every occupied voxel's plane fitted, 2 probes. The three calls of an
    update: a probe (the first iteration), the device flag on and off
    after a probe 10 cm and 10 mrad away (the gated iteration), the carried
    association (the last); the extrinsic's columns (probing at the body
    points); ragged (8191 + 77 points that find nothing, every 13th
    masked), all masked, not found and a tight 2^12 table that dropped
    points; a second launch gives the same words. The probe and the carried
    call are timed beside the plain version, the timing floor and
    ``hbm_bytes``'s bound. Returns the probe's record (the kernels line)
    with the carried call's under ``at_carried``."""
    import torch

    from fastliosam_tpu_torch.core.voxel import hash_slot, voxel_coords
    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.odom import OdomConfig
    from fastliosam_tpu_torch.ops import cached_rows_cuda as crc
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, *_ = fig8
    mc = _cached_map(m, cfg)
    oc = OdomConfig()
    tail = (cfg.voxel_size, cfg.query_probes, oc.point_cov, oc.max_residual,
            oc.degen_conf_ratio)
    table = (mc.fp, mc.normal, mc.d, mc.plane_valid)
    c, s = np.cos(0.01), np.sin(0.01)  # a 10 mrad yaw
    turn = torch.from_numpy(np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                                     np.float32)).to(dev)
    shift = torch.tensor([0.1, 0.0, 0.0], device=dev)

    def state(k):
        pose = torch.from_numpy(traj[k]).to(dev)
        return pose[:3, :3].contiguous(), pose[:3, 3].contiguous()

    def words(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def compare(name, args, kw):
        got = crc.cached_rows_cuda(*args, *tail, **kw)
        again = crc.cached_rows_cuda(*args, *tail, **kw)
        want = crc.cached_rows_ref(*args, *tail, **kw)
        torch.cuda.synchronize()
        for field, g, w, a in zip(crc.CachedRows._fields, got, want, again):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(words(g), words(w)):
                raise AssertionError(f"cached_rows {name}: kernel and plain version differ "
                                     f"in {field}")
            if not torch.equal(words(g), words(a)):
                raise AssertionError(f"cached_rows {name}: two launches differ in {field}")
        return got

    sets, carried_sets, matched = [], [], []
    for k in range(n_map_scans - reps, n_map_scans):
        R, p = state(k)
        pts, mask = _downsampled_body(feed, k, dev)
        first = compare("probe", (R, p, pts, mask, table, None, True), {})
        matched.append(int(first.n_matched))
        R0, p0 = (R @ turn).contiguous(), p + shift
        away = compare("probe away", (R0, p0, pts, mask, table, None, True), {})
        for flag in (True, False):
            got = compare(f"flag {flag}", (R, p, pts, mask, table, away.slots,
                                           torch.tensor(flag, device=dev)), {})
            ref = first if flag else away
            if not torch.equal(got.slots, ref.slots):
                raise AssertionError("cached_rows: the device flag chose the wrong association")
        compare("carried", (R, p, pts, mask, table, away.slots, False), {})
        sets.append((R, p, pts, mask, table, None, True))
        carried_sets.append((R, p, pts, mask, table, first.slots, False))
    # the extrinsic's columns, probing at the body points
    R, p, pts, mask = sets[0][:4]
    R_ext = turn.mT.contiguous()
    t_ext = torch.tensor([0.05, -0.02, 0.1], device=dev)
    p_l = ((pts - t_ext) @ R_ext).contiguous()
    q_b = (p_l @ R_ext.mT + t_ext).contiguous()
    compare("extrinsic", (R, p, q_b, mask, table, None, True),
            {"q_query": pts, "p_l": p_l, "R_ext": R_ext})
    # ragged, all masked, not found, tight
    far = (torch.full((77, 3), 900.0, device=dev)
           + torch.arange(77, device=dev, dtype=torch.float32)[:, None])
    rpts = torch.cat([pts[:8191], far]).contiguous()
    rmask = torch.cat([mask[:8191], torch.ones(77, dtype=torch.bool, device=dev)])
    rmask[::13] = False
    got = compare("ragged", (R, p, rpts, rmask, table, None, True), {})
    if bool(got.valid[-77:].any()) or bool((got.slots[-77:] >= 0).any()):
        raise AssertionError("cached_rows: a point that finds nothing must not be valid")
    compare("all masked", (R, p, pts, torch.zeros_like(mask), table, None, True), {})
    compare("not found", (R, p, far.contiguous(), torch.ones(77, dtype=torch.bool, device=dev),
                          table, None, True), {})
    tight_cfg = vh.VoxelMapConfig(capacity=1 << 12, voxel_size=0.5, min_points=5,
                                  query_probes=4)
    world = (pts @ R.mT + p).contiguous()
    tight, dropped = vh.insert(vh.make_map(tight_cfg, dev), tight_cfg,
                               torch.cat([world, world + 0.25]).contiguous(),
                               torch.cat([mask, mask]), refresh_planes=True)
    if int(dropped) == 0:
        raise AssertionError("cached_rows tight case: the 2^12 table must overflow")
    compare("tight 2^12", (R, p, pts, mask, (tight.fp, tight.normal, tight.d, tight.plane_valid),
                           None, True), {})

    def call(*args):
        return crc.cached_rows_cuda(*args, *tail)

    def plain(*args):
        return crc.cached_rows_ref(*args, *tail)

    recs = {}
    for name, ss in (("probe", sets), ("carried", carried_sets)):
        ms = device_ms(call, ss)
        plain_ms = device_ms(plain, ss)
        nbytes = []
        for a in ss:
            rows = crc.cached_rows_ref(*a, *tail)
            pw = a[2] @ a[0].mT + a[1]  # the probe's points: first slots of its voxels
            h0 = hash_slot(voxel_coords(pw, cfg.voxel_size), cfg.capacity).cpu().numpy()
            nbytes.append(crc.hbm_bytes(rows, a[4], a[3], a[6], h0, cfg.query_probes))
        nb = float(np.mean(nbytes))
        recs[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": nb / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
                      "library_ms": None,
                      "library_note": "none: no PyTorch call probes a hash table and forms "
                                      "the rows",
                      "timing_floor_ms": floor_ms, "n": int(ss[0][2].shape[0]),
                      "capacity": cfg.capacity, "probes": cfg.query_probes, "sets": len(ss),
                      "bytes": nb, "n_matched_mean": float(np.mean(matched))}
        print(f"  cached_rows {name}: 8192 body points x 2^{cfg.capacity.bit_length() - 1} "
              f"slots, {cfg.query_probes} probes, {len(ss)} sets: equal on every output, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{recs[name]['bound_ms']:.5f} ms ({nb:.0f} HBM bytes), floor {floor_ms:.4f} ms, "
              f"matched {np.mean(matched):.0f} a scan")
    print(f"  cached_rows: equal on the flag on / off, carried, extrinsic, ragged, all-masked, "
          f"not-found and tight 2^12 ({int(dropped)} of {2 * len(mask)} points dropped) cases, "
          f"two launches the same words")
    return dict(recs["probe"], at_carried=recs["carried"])


def _downsampled_world(feed, k, pose, dev, budget: int = 8192):
    """Scan ``k``'s points downsampled as the odometry downsamples them
    (0.5 m voxels, the first ``budget`` of the packed output) and placed at
    ``pose`` (not deskewed): ``(xyz (budget, 3), mask (budget,))``."""
    import torch

    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample

    ds = voxel_downsample(Cloud(torch.from_numpy(feed["xyz"][k]).to(dev),
                                torch.from_numpy(feed["mask"][k]).to(dev)), 0.5)
    pose = torch.from_numpy(pose).to(dev)
    return (ds.xyz[:budget] @ pose[:3, :3].T + pose[:3, 3]).contiguous(), ds.mask[:budget]


def _insert_equal(name, fp, coords, moments, xyz, mask, vs, rounds, maxp):
    """The insert's kernel against its plain version on one input, bit for
    bit on ``fp``, ``coords``, ``sl``, ``n_dropped`` and the ``upd`` rows of
    the assigned points (the unassigned rows go to the moment scatter's dead
    segment and are never read); raises where they differ. Returns the
    kernel's outputs."""
    import torch

    from fastliosam_tpu_torch.ops import insert_cuda

    got = insert_cuda.insert_claim_cuda(fp, coords, moments, xyz, mask, vs, rounds, maxp)
    want = insert_cuda.insert_claim_ref(fp, coords, moments, xyz, mask, vs, rounds, maxp)
    torch.cuda.synchronize()
    assigned = want[2] < fp.shape[0]
    same = {
        "fp": torch.equal(got[0], want[0]), "coords": torch.equal(got[1], want[1]),
        "sl": torch.equal(got[2], want[2]), "n_dropped": torch.equal(got[4], want[4]),
        "upd (assigned rows)": torch.equal(got[3][assigned].view(torch.int32),
                                           want[3][assigned].view(torch.int32)),
    }
    bad = [k for k, ok in same.items() if not ok]
    if bad:
        raise AssertionError(f"insert_claim {name}: kernel and plain version differ on "
                             + ", ".join(bad))
    return got


def check_insert(dev, feed, fig8, n_map_scans: int = 20, reps: int = 10):
    """The map insert's kernel against its plain version, bit for bit on
    ``fp``, ``coords``, ``sl``, ``n_dropped`` and the ``upd`` rows of the
    assigned points (the unassigned rows go to the moment scatter's dead
    segment and are never read): the engine's 2^19-slot map after
    ``n_map_scans`` figure-8 scans (``figure8_map``), inserting the
    downsampled points of each of the next ``reps`` scans at the engine's
    poses, 2 rounds; a tight 2^12-slot table with drops (16,384 points, 4
    rounds); and the map after ``evict_far`` with a re-insert. The kernel
    is timed alone on fresh copies of the tables over the ``reps`` scans
    (and at 1 and 4 rounds), beside the whole call with its table copies,
    the plain version, the bound and the grid barriers alone at the
    kernel's grid. Returns the record (the kernels line)."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import insert_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    m, cfg, traj, *_ = fig8
    maxp, vs = cfg.max_points_per_voxel, cfg.voxel_size
    rounds = max(cfg.insert_probes, cfg.claim_probes)
    sets = [_downsampled_world(feed, k, traj[k], dev)
            for k in range(n_map_scans, n_map_scans + reps)]

    new_voxels = []
    for xyz, mask in sets:
        got = _insert_equal("figure-8", m.fp, m.coords, m.moments, xyz, mask, vs, rounds, maxp)
        new_voxels.append(int((got[0] != 0).sum()) - int((m.fp != 0).sum()))
        # run_slam's maps probe and claim over 4 slots (VoxelMapConfig's default)
        _insert_equal("figure-8, 4 rounds", m.fp, m.coords, m.moments, xyz, mask, vs, 4, maxp)
    # tight: two scans' points into 2^12 slots, 4 rounds
    tight_xyz = torch.cat([sets[0][0], sets[1][0]])
    tight_mask = torch.cat([sets[0][1], sets[1][1]])
    tight = vh.make_map(vh.VoxelMapConfig(capacity=1 << 12), dev)
    got = _insert_equal("tight 2^12", tight.fp, tight.coords, tight.moments, tight_xyz,
                        tight_mask, vs, 4, maxp)
    tight_dropped = int(got[4])
    if tight_dropped == 0:
        raise AssertionError("insert_claim tight case: the 2^12 table must overflow")
    # evicted: holes punched around the pose of the first inserted scan
    ev = vh.evict_far(m, cfg, torch.from_numpy(traj[n_map_scans][:3, 3]).to(dev), 8.0)
    _insert_equal("evicted", ev.fp, ev.coords, ev.moments, *sets[0], vs, rounds, maxp)
    print(f"  insert_claim: equal on the figure-8 map ({reps} scans at {rounds} and 4 rounds, "
          f"{np.mean(new_voxels):.0f} new voxels per insert), the tight 2^12 table "
          f"({tight_dropped} of {int(tight_mask.sum())} points dropped) and the evicted map "
          f"({int((m.fp != 0).sum()) - int((ev.fp != 0).sum())} voxels evicted)")

    # timing: the launch alone (the claim table's zeroing and the kernel),
    # each call on its own fresh copy of the tables; device_ms makes 3
    # untimed calls (warm-up, enqueue time) before the timed ones
    def launch(r):
        fresh = iter([(m.fp.clone(), m.coords.clone()) for _ in range(reps + 3)])
        return lambda x, k: insert_cuda.insert_claim_into(*next(fresh), m.moments, x, k, vs, r,
                                                          maxp)

    times = {r: device_ms(launch(r), sets) for r in (1, 2, 4)}
    ms = times[rounds]
    call_ms = device_ms(lambda x, k: insert_cuda.insert_claim_cuda(
        m.fp, m.coords, m.moments, x, k, vs, rounds, maxp), sets)
    plain = {r: device_ms(lambda x, k, r=r: insert_cuda.insert_claim_ref(
        m.fp, m.coords, m.moments, x, k, vs, r, maxp), sets) for r in (rounds, 4)}
    plain_ms = plain[rounds]
    blocks, per_thread = insert_cuda.insert_claim_grid(sets[0][0].shape[0], dev)
    sync_ms = {s: device_ms(lambda b, s=s: insert_cuda.grid_sync_probe(b, s, dev),
                            [(blocks,)] * reps) for s in (0, 2 * rounds)}
    per_sync = (sync_ms[2 * rounds] - sync_ms[0]) / (2 * rounds)
    fp_np = m.fp.cpu().numpy()
    nbytes = {}  # HBM bytes at the bench's rounds and at run_slam's 4
    for r in (rounds, 4):
        sls = [insert_cuda.insert_claim_cuda(m.fp, m.coords, m.moments, xyz, mask, vs, r,
                                             maxp)[2] for xyz, mask in sets]
        nbytes[r] = float(np.mean([insert_cuda.hbm_bytes(fp_np, xyz, mask, sl, vs, r)
                                   for (xyz, mask), sl in zip(sets, sls)]))
    bounds = {r: b / H100_BYTES_PER_S * 1e3 for r, b in nbytes.items()}
    bound_ms = bounds[rounds]
    print(f"  insert_claim 8192 points, 2^19-slot map, {rounds} rounds: kernel {ms:.4f} ms "
          f"(1 round {times[1]:.4f}, 4 rounds {times[4]:.4f}), whole call with its table "
          f"copies {call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({nbytes[rounds]:.0f} HBM bytes); grid {blocks} x 256 threads, {per_thread} "
          f"point(s) a thread (4 rounds: plain {plain[4]:.4f} ms, bound {bounds[4]:.5f} ms): "
          f"a grid barrier {per_sync * 1e3:.2f} us "
          f"({2 * rounds} barriers = {2 * rounds * per_sync / ms:.0%} of the kernel), "
          f"an empty cooperative launch {sync_ms[0]:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "library_note": "none: no PyTorch call probes and claims a hash table",
            "ms_by_rounds": times, "plain_ms_by_rounds": plain, "bound_ms_by_rounds": bounds,
            "call_ms": call_ms, "grid_blocks": blocks,
            "grid_sync_ms": per_sync, "empty_launch_ms": sync_ms[0]}


def experiment_phase(dev):
    """The gather experiment entry point, once: the path of take_along_axis
    (its launch count is read around this run). Returns the record of the
    map-size take_along_axis (the kernels line), the launches and every
    experiment's record."""
    from fastliosam_tpu_torch.ops import KERNEL_MODULES
    from fastliosam_tpu_torch.scripts import exp_gather

    for mod in KERNEL_MODULES:
        mod.reset_launches()
    recs = exp_gather.run(dev, print_fn=lambda line: print("  " + line))
    launches = {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}
    big = next(r for r in recs if r["name"] == "tal_big")
    probe = next(r for r in recs if r["name"] == "tal_big_ceiling_probe")
    main = {"max_abs_err": 0.0, **{k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")},
            "ceiling_probe_ms": probe["ms"]}
    return main, launches, recs


# ---------------------------------------------------------------------------
# feeds (made in worker processes while the kernels build)
# ---------------------------------------------------------------------------
def _cached_feed(name: str, build) -> str:
    """Make the feed once and cache it under build/; returns its path."""
    cache = ROOT / "build" / f"chip_smoke_{name}.npz"
    if not cache.exists():
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npz")
        np.savez(tmp, **build())
        tmp.replace(cache)
    return str(cache)


def figure8_traj():
    """The figure-8 feed's path (``bench.py: build_fig8_sequence``)."""
    from fastliosam_tpu_torch.sim import Trajectory

    return Trajectory.figure8(scale=12.0, period=12.0, z_amp=0.2)


def figure8_feed(n_scans: int, seed: int = 11) -> str:
    """The bench's loop-closing feed (``bench.py: build_fig8_sequence``): a
    lemniscate through a 60 m room, 2048 azimuths x 16 rings at 10 Hz, IMU
    at 200 Hz; GPS drawn at the simulator's default 1 Hz, not the bench's
    10 Hz (``eval/feeds.py: build_fig8_sequence``, phase 14's feed): the
    draws decide the IMU noise that follows them, and the accuracy
    references of phases 4-12 rest on these."""
    def build():
        from fastliosam_tpu_torch.eval.feeds import pack_sequence
        from fastliosam_tpu_torch.sim import PlaneWorld, SimConfig, simulate_sequence

        world = PlaneWorld.room(size=60.0, height=10.0, n_boxes=25, seed=seed)
        traj = figure8_traj()
        cfg = SimConfig(scan_rate=10.0, n_azimuth=2048, n_elev=16, max_range=120.0,
                        gyro_noise=0.001, acc_noise=0.01, seed=seed, time_groups=32)
        return pack_sequence(simulate_sequence(world, traj, cfg, n_scans=n_scans), traj)

    return _cached_feed(f"fig8_{n_scans}_{seed}", build)


def corridor_feed(n_scans: int) -> str:
    """The bench's GPS corridor (``eval/feeds.py: build_corridor_sequence``,
    the port of ``bench.py``'s): a 400 m corridor whose planes are all ⊥ x
    beyond its clutter, a straight run at 6 m/s with a strong accelerometer
    bias, 2048 x 16 rays to 60 m, GPS at 10 Hz with 0.3 m noise."""
    def build():
        from fastliosam_tpu_torch.eval.feeds import build_corridor_sequence

        return build_corridor_sequence(n_scans)

    return _cached_feed(f"corridor_{n_scans}_3", build)


def load_feed(path: str) -> dict:
    with np.load(path) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# engine phases
# ---------------------------------------------------------------------------
def _start(engine, feed, dev):
    """reset() at the feed's initial state; the feed staged on the card (as
    the bench stages its chunks)."""
    import torch

    engine.reset()
    engine.odom = engine.odom._replace(nav=engine.odom.nav._replace(
        R=torch.from_numpy(feed["R0"]).to(dev), p=torch.from_numpy(feed["p0"]).to(dev),
        v=torch.from_numpy(feed["v0"]).to(dev)))
    return {k: torch.from_numpy(np.asarray(feed[k])).to(dev)
            for k in ("xyz", "toff", "mask", "imu_t", "imu_g", "imu_a", "imu_m")}


class _Probe:
    """Host time, host reads, and NN and cached-query launches inside the
    engine's loop verification, loop resolution and solve (wrapped on the
    instance)."""

    NAMES = ("_launch_verify", "_resolve_pending_loop", "_solve")

    def __init__(self, engine):
        self.engine = engine
        self.s = {n: 0.0 for n in self.NAMES}
        self.reads = {n: 0 for n in self.NAMES}
        self.calls = {n: 0 for n in self.NAMES}
        self.verify_reads, self.verify_nn, self.verify_query = [], [], []

    def __enter__(self):
        from fastliosam_tpu_torch.ops import nn_cuda, query_cuda
        from fastliosam_tpu_torch.utils import host_reads

        self.saved = {n: getattr(self.engine, n) for n in self.NAMES}

        def wrap(name, fn):
            def call(*args):
                t0, r0, l0, q0 = (time.perf_counter(), host_reads(), nn_cuda.launches,
                                  query_cuda.launches)
                try:
                    return fn(*args)
                finally:
                    self.s[name] += time.perf_counter() - t0
                    self.reads[name] += host_reads() - r0
                    self.calls[name] += 1
                    if name == "_launch_verify":
                        self.verify_reads.append(host_reads() - r0)
                        self.verify_nn.append(nn_cuda.launches - l0)
                        self.verify_query.append(query_cuda.launches - q0)
            return call

        for n, fn in self.saved.items():
            setattr(self.engine, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            delattr(self.engine, n)  # back to the class's methods
        return False


def _start_profile():
    """Start ``torch.profiler`` on the device's activity after draining the
    queue; returns it and the host clock. Only device rows are read, and
    recording the host's operations too would cost tens of seconds per
    window (the host's are recorded only in a rehearsal on the CPU)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof, time.perf_counter()


def run_engine(engine, feed, dev, n_scans: int, profile_from=None):
    """Drive ``engine.process`` over the feed. Returns host times, the
    per-verification host reads and NN launches; with ``profile_from`` the
    scans from that index on run under ``torch.profiler``."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan

    g = _start(engine, feed, dev)
    prof = None
    with _Probe(engine) as probe:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n_scans):
            if k == profile_from:
                prof, t_prof = _start_profile()
            scan = Scan(g["xyz"][k], g["toff"][k], g["mask"][k])
            imu = ImuBatch(g["imu_t"][k], g["imu_g"][k], g["imu_a"][k], g["imu_m"][k])
            engine.process(scan, imu, float(feed["stamps"][k]), float(feed["scan_dt"]))
        engine.finish()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    timing = {"total_s": total, "verify_s": probe.s["_launch_verify"],
              "solve_s": probe.s["_solve"], "verify_syncs": probe.verify_reads,
              "verify_nn": probe.verify_nn, "verify_query": probe.verify_query}
    if prof is not None:
        prof.__exit__(None, None, None)
        timing["prof"], timing["prof_wall_s"] = prof, time.perf_counter() - t_prof
        timing["prof_scans"] = n_scans - profile_from
    return timing


def run_chunks(engine, feed, dev, chunk: int, deferred: bool, fixes=None, profile_from=None):
    """Drive ``process_chunk`` (or its deferred form) over the feed in
    chunks, as ``bench.py: _run_pipeline`` does, with the GPS fixes of each
    chunk's time span. Returns host time and the host reads inside loop
    verification, loop resolution and solves; with ``profile_from`` the
    chunks from that index on run under ``torch.profiler``."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan
    from fastliosam_tpu_torch.utils import host_reads

    g = _start(engine, feed, dev)
    n = (len(feed["stamps"]) // chunk) * chunk
    dt = float(feed["scan_dt"])
    step = engine.process_chunk_deferred if deferred else engine.process_chunk
    prof = None
    with _Probe(engine) as probe:
        torch.cuda.synchronize()
        r0, t0 = host_reads(), time.perf_counter()
        for c in range(0, n, chunk):
            if profile_from is not None and c == profile_from * chunk:
                prof, t_prof = _start_profile()
            sl = slice(c, c + chunk)
            stamps = feed["stamps"][sl]
            lo, hi = float(stamps[0]) - dt, float(stamps[-1])
            gps = None if fixes is None else [f for f in fixes if lo <= f.stamp < hi]
            step(Scan(g["xyz"][sl], g["toff"][sl], g["mask"][sl]),
                 ImuBatch(g["imu_t"][sl], g["imu_g"][sl], g["imu_a"][sl], g["imu_m"][sl]),
                 stamps, dt, gps=gps)
        engine.finish()
        torch.cuda.synchronize()
        total, reads = time.perf_counter() - t0, host_reads() - r0
    out = {"total_s": total, "scans": n, "chunks": n // chunk, "host_reads": reads,
           "loop_and_solve_reads": sum(probe.reads.values()),
           "solve_s": probe.s["_solve"], "verify_s": probe.s["_launch_verify"],
           "verify_syncs": probe.verify_reads, "verify_nn": probe.verify_nn,
           "verify_query": probe.verify_query}
    if prof is not None:
        prof.__exit__(None, None, None)
        out["prof"], out["prof_wall_s"] = prof, time.perf_counter() - t_prof
        out["prof_scans"] = n - profile_from * chunk
    return out


def _ate(engine, feed) -> float:
    rt = np.stack(engine.realtime_traj)[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum((rt - feed["gt_p"][: len(rt)]) ** 2, axis=1))))


def _launch_counts(fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just before;
    returns its result and the counts read just after."""
    from fastliosam_tpu_torch.ops import KERNEL_MODULES

    for mod in KERNEL_MODULES:
        mod.reset_launches()
    out = fn()
    return out, {mod.KERNEL["name"]: mod.launches for mod in KERNEL_MODULES}


def _per_scan(launches, scans) -> dict:
    """The map's kernels per scan: insert_claim (one per insert),
    merged_moments (one per association), refresh_planes (the plane
    refresh of the loop closure's throwaway map) and gather_rows (0: its
    engine reads moved into refresh_planes and p2pl_normal_eq)."""
    return {name: launches[name] / scans
            for name in ("insert_claim", "merged_moments", "refresh_planes", "gather_rows")}


def _no_gather(launches) -> dict:
    """The gate that an engine path ran no row gather: its reads there
    live in the plane refresh and the point-to-plane kernels."""
    return {"gather_rows not launched": launches["gather_rows"] == 0}


def _default_path(launches) -> dict:
    """The gates of a path in the default (merged) query modes: no row
    gather, and no cached-mode rows."""
    return {**_no_gather(launches), "cached_rows not launched": launches["cached_rows"] == 0}


def _window_ops(run, top: int = 6) -> float:
    """Device operations per scan over the profiled window of ``run``."""
    return profile_summary(run["prof"], run["prof_wall_s"], run["prof_scans"],
                           top=top)["device_ops_per_scan"]


def _replay(engine, first) -> bool:
    """The replay check of a second run from reset(): bit-identical realtime
    trajectory and the same loop pairs."""
    traj, loops = first
    return np.array_equal(np.stack(engine.realtime_traj), traj) and engine.loop_pairs == loops


def _fail(phase, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} failed: " + ", ".join(failed))


def per_scan_phase(dev, feed):
    import torch

    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine
    from fastliosam_tpu_torch.utils import host_read, host_reads, reset_host_reads

    n_scans = len(feed["stamps"])
    engine = make_bench_engine(dev)
    run_engine(engine, feed, dev, min(12, n_scans))  # warm-up: allocator, cuBLAS
    reset_host_reads()
    timing, launches = _launch_counts(lambda: run_engine(engine, feed, dev, n_scans))
    syncs = host_reads()
    ate = _ate(engine, feed)
    matched = host_read(torch.stack(engine.match_counts))
    first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
    n_verify = len(engine.loop_attempts)
    verify_n = len(timing["verify_syncs"])
    result = {
        "scans": n_scans,
        "scans_per_s": n_scans / timing["total_s"],
        "keyframes": engine.kf.n,
        "loops": len(engine.loop_pairs),
        "verifications": n_verify,
        "solves": engine.solve_count,
        "launches": launches,
        "host_syncs_per_scan": syncs / n_scans,
        "host_syncs_per_verification": (float(np.mean(timing["verify_syncs"]))
                                        if verify_n else None),
        "nn_launches_per_verification": (float(np.mean(timing["verify_nn"]))
                                         if verify_n else None),
        "verify_ms_each": 1e3 * timing["verify_s"] / verify_n if verify_n else None,
        "solve_ms_each": (1e3 * timing["solve_s"] / engine.solve_count
                          if engine.solve_count else None),
        "host_s": {k: timing[k] for k in ("total_s", "verify_s", "solve_s")},
        "ate_m": ate,
        "min_matched_after_scan2": int(matched[2:].min()),
        "loop_pairs": first[1],
    }
    result["launches_per_scan"] = _per_scan(launches, n_scans)
    poses = np.stack(engine.realtime_traj)
    window = min(TRACED_SCANS, n_scans)
    # the replay; its last scans are traced (tracing changes no result)
    replay = run_engine(engine, feed, dev, n_scans, profile_from=n_scans - window)
    result["replay_bit_identical"] = _replay(engine, first)
    result["device_ops_per_scan"] = _window_ops(replay)
    print("  " + json.dumps(result))
    _fail("per-scan phase", {
        "every pose finite": bool(np.all(np.isfinite(poses)))
        and bool(np.all(np.isfinite(engine.keyframe_poses()))),
        "n_matched > 500 after scan 2": result["min_matched_after_scan2"] > 500,
        "at least one verification": n_verify >= 1,
        "nearest_neighbors, refresh_planes, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "refresh_planes", "merged_moments",
                                      "insert_claim")) > 0,
        **_default_path(launches),
        "ATE < 0.10 m": ate < 0.10,
        "replay bit-identical": result["replay_bit_identical"],
    })
    return result, poses


def profile_phase(dev, feed, profile_scans: int):
    """An extra per-scan run whose last ``profile_scans`` scans run under
    ``torch.profiler``; it comes after every other phase (tracing slows the
    host for a while after it ends) and touches no launch count read."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    n_scans = len(feed["stamps"])
    engine = make_bench_engine(dev)
    run_engine(engine, feed, dev, min(12, n_scans))  # warm-up
    start = max(0, n_scans - profile_scans)
    run = run_engine(engine, feed, dev, n_scans, profile_from=start)
    return profile_summary(run["prof"], run["prof_wall_s"], n_scans - start)


def chunked_phase(dev, feed, chunk: int = 5):
    """process_chunk_deferred over the loop feed, twice from reset()."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev, chunk=chunk)
    run, launches = _launch_counts(
        lambda: run_chunks(engine, feed, dev, chunk, deferred=True))
    first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
    odom_reads = run["host_reads"] - run["loop_and_solve_reads"]
    result = {
        "scans": run["scans"], "chunk": chunk, "defer_depth": engine.cfg.defer_depth,
        "scans_per_s": run["scans"] / run["total_s"],
        "keyframes": engine.kf.n, "loops": len(engine.loop_pairs),
        "verifications": len(engine.loop_attempts), "solves": engine.solve_count,
        "launches": launches,
        "host_syncs_per_chunk": run["host_reads"] / run["chunks"],
        "odom_keyframe_reads_per_chunk": odom_reads / run["chunks"],
        "host_s": {k: run[k] for k in ("total_s", "verify_s", "solve_s")},
        "ate_m": _ate(engine, feed), "loop_pairs": first[1],
    }
    result["launches_per_scan"] = _per_scan(launches, run["scans"])
    poses = np.stack(engine.realtime_traj)
    # the replay; its last chunks are traced (tracing changes no result)
    replay = run_chunks(engine, feed, dev, chunk, deferred=True,
                        profile_from=max(0, run["chunks"] - TRACED_SCANS // chunk))
    result["replay_bit_identical"] = _replay(engine, first)
    result["device_ops_per_scan"] = _window_ops(replay)
    print("  " + json.dumps(result))
    _fail("chunked phase", {
        "every pose finite": bool(np.all(np.isfinite(poses))),
        "ATE < 0.10 m": result["ate_m"] < 0.10,
        "at least one loop": result["loops"] >= 1,
        "<= 1 host read per chunk for odometry + keyframing":
            result["odom_keyframe_reads_per_chunk"] <= 1.0,
        "nearest_neighbors, refresh_planes, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "refresh_planes", "merged_moments",
                                      "insert_claim")) > 0,
        **_default_path(launches),
        "replay bit-identical": result["replay_bit_identical"],
    })
    return result


# the other query and loop-ICP modes: each run's engine configuration over
# the bench's pipeline, its path, and the kernels that path must launch
MODES = {
    "cached_p2pl": (dict(query_mode="cached"), dict(icp_method="p2pl"), "per_scan",
                    ("cached_rows", "query_cached", "insert_claim", "refresh_planes",
                     "p2pl_normal_eq", "nearest_neighbors")),
    "merged2_multistart": (dict(query_mode="merged2"),
                           dict(icp_multistart=5, multistart_step=4.0, multistart_iters=12),
                           "chunked", ("merged_moments", "insert_claim", "nearest_neighbors")),
}


def modes_phase(dev, feed, chunk: int = 5) -> dict:
    """The other query and loop-ICP modes over the figure-8 feed at the
    bench's width: (a) ``process`` per scan with the cached-plane query and
    point-to-plane loop ICP; (b) ``process_chunk_deferred`` (chunk 5) with
    the merged2 query and the multi-start loop ICP of ``bench.py:
    bench_kitti_rich`` (5 starts 4 m apart, 12 coarse iterations). Each
    run goes twice from ``reset()``, the cached run's replay with its last
    ``TRACED_SCANS`` scans traced (device operations a scan); gates: every
    pose finite, more than 500 matches in every scan after scan 2 (from
    scan 3 on: a cached plane needs 5 points in one voxel, so scan 2
    against the map of scans 0-1 matches only tens of points), a
    verification, a bit-identical replay, the path's kernels launched and
    ATE < 0.10 m; the cached run's iEKF through ``cached_rows`` (one launch
    an iteration) and ``query_cached`` launched only by the verifications'
    point-to-plane normals, the merged2 run without ``cached_rows``."""
    import torch

    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine
    from fastliosam_tpu_torch.utils import host_read, host_reads

    out = {}
    for name, (odom_kw, loop_kw, path, kernels) in MODES.items():
        engine = make_bench_engine(dev, chunk=chunk)
        engine.odom_cfg = engine.odom_cfg._replace(**odom_kw)
        engine.loop_cfg = engine.loop_cfg._replace(**loop_kw)
        engine.reset()
        cached = odom_kw.get("query_mode") == "cached"
        if path == "per_scan":
            def drive(profile_from=None):
                return run_engine(engine, feed, dev, len(feed["stamps"]),
                                  profile_from=profile_from)
        else:
            def drive(profile_from=None):
                return run_chunks(engine, feed, dev, chunk, deferred=True)
        r0 = host_reads()
        run, launches = _launch_counts(drive)
        reads = host_reads() - r0
        first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
        matched = host_read(torch.stack(engine.match_counts))
        n_scans = len(engine.realtime_traj)
        n_verify = len(run["verify_syncs"])
        result = {
            "path": path, "odom": odom_kw, "loop": loop_kw, "scans": n_scans,
            "scans_per_s": n_scans / run["total_s"], "keyframes": engine.kf.n,
            "loops": len(engine.loop_pairs), "verifications": len(engine.loop_attempts),
            "solves": engine.solve_count, "ate_m": _ate(engine, feed),
            "launches": launches,
            "launches_per_scan": {k: v / n_scans for k, v in launches.items()},
            "host_reads_per_scan": reads / n_scans,
            "host_syncs_per_verification": (float(np.mean(run["verify_syncs"]))
                                            if n_verify else None),
            "nn_launches_per_verification": (float(np.mean(run["verify_nn"]))
                                             if n_verify else None),
            "query_cached_in_verifications": int(sum(run["verify_query"])),
            "verify_ms_each": 1e3 * run["verify_s"] / n_verify if n_verify else None,
            "matched_first_scans": matched[:5].tolist(),
            "min_matched_after_scan2": int(matched[3:].min()),
            "loop_pairs": first[1],
        }
        finite = bool(np.all(np.isfinite(first[0]))) and bool(
            np.all(np.isfinite(engine.keyframe_poses())))
        # the replay; the cached run's last scans traced (tracing changes no result)
        replay = drive(profile_from=n_scans - TRACED_SCANS if cached else None)
        result["replay_bit_identical"] = _replay(engine, first)
        if cached:
            result["device_ops_per_scan"] = _window_ops(replay)
        print(f"  {name}: " + json.dumps(result))
        if cached:
            iters = engine.odom_cfg.max_iteration
            print(f"  {name}: {result['device_ops_per_scan']:.1f} device ops a scan (the "
                  f"replay's last {TRACED_SCANS} scans), {result['host_reads_per_scan']:.3f} "
                  f"host reads a scan, cached_rows {launches['cached_rows'] / n_scans:.3f} and "
                  f"query_cached {launches['query_cached'] / n_scans:.3f} launches a scan "
                  f"({result['query_cached_in_verifications']} of {launches['query_cached']} "
                  f"query_cached launches in the verifications)")
            path_gates = {
                f"cached_rows once an iEKF iteration ({iters} a scan after scan 0)":
                    launches["cached_rows"] % iters == 0
                    and iters * (n_scans - 1) <= launches["cached_rows"] <= iters * n_scans,
                "query_cached launched only by the verifications":
                    launches["query_cached"] == result["query_cached_in_verifications"],
            }
        else:
            path_gates = {"cached_rows not launched": launches["cached_rows"] == 0}
        _fail(f"modes phase, {name}", {
            "every pose finite": finite,
            "n_matched > 500 after scan 2 (scans 3 on)": result["min_matched_after_scan2"] > 500,
            "at least one verification": result["verifications"] >= 1,
            "replay bit-identical": result["replay_bit_identical"],
            ", ".join(kernels) + " launched": min(launches[k] for k in kernels) > 0,
            **_no_gather(launches),
            **path_gates,
            "ATE < 0.10 m": result["ate_m"] < 0.10,
        })
        out[name] = result
    return out


def gps_phase(dev, feed, chunk: int = 5):
    """The bench's corridor (``bench.py: bench_gps_corridor``): process_chunk
    with the bench's GPS configuration (the GPS-off run, which gated
    nothing, was cut to make room for the mesh phase)."""
    from fastliosam_tpu_torch.eval.feeds import _fixes_from_data
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev, max_kf=256, max_between=512, max_gps=256, chunk=chunk)
    n_chunks = len(feed["stamps"]) // chunk
    fixes = _fixes_from_data(feed)
    engine.pgo_cfg = engine.pgo_cfg._replace(gps_huber_delta=2.0)
    engine.cfg = engine.cfg._replace(use_gps=True, gps_dist_thres=2.0, gps_noise_floor=0.25,
                                     odom_trans_sqrt_info=50.0, odom_rot_sqrt_info=1000.0)
    # the last chunks are traced
    on, launches = _launch_counts(
        lambda: run_chunks(engine, feed, dev, chunk, deferred=False, fixes=fixes,
                           profile_from=max(0, n_chunks - TRACED_GPS_CHUNKS)))
    poses = np.stack(engine.realtime_traj)
    result = {
        "scans": on["scans"], "chunk": chunk, "fixes": len(fixes),
        "ate_gps_on_m": _ate(engine, feed),
        "gps_factors": int(engine.graph.n_gps), "solves": engine.solve_count,
        "keyframes": engine.kf.n, "launches": launches,
        "scans_per_s_gps_on": on["scans"] / on["total_s"],
        "solve_ms_each": 1e3 * on["solve_s"] / max(engine.solve_count, 1),
        "host_syncs_per_chunk": on["host_reads"] / on["chunks"],
        "launches_per_scan": _per_scan(launches, on["scans"]),
        "device_ops_per_scan": _window_ops(on),
    }
    print("  " + json.dumps(result))
    print(f"  corridor ATE: GPS on {result['ate_gps_on_m']:.4f} m "
          f"(accuracy reference, JAX engine on a TPU over 400 scans: 1.8664 m)")
    _fail("GPS phase", {
        "at least 2 GPS factors": result["gps_factors"] >= 2,
        "at least 1 solve": result["solves"] >= 1,
        "every pose finite": bool(np.all(np.isfinite(poses))),
        "ATE with GPS < 2.0 m": result["ate_gps_on_m"] < 2.0,
        "merged_moments and insert_claim launched":
            launches["merged_moments"] > 0 and launches["insert_claim"] > 0,
        **_default_path(launches),
    })
    return result, (engine.keyframe_stamps().astype(np.float64),
                    engine.keyframe_poses()[:, :3, 3].astype(np.float64))


# ---------------------------------------------------------------------------
# KITTI phase: the dataset entry point (drive_kitti over the native reader),
# export, checkpoint/resume and relocalization
# ---------------------------------------------------------------------------
def kitti_feed() -> tuple[str, float]:
    """The bench's KITTI_SYNTH v2 (``bench.py: _ensure_longrun_dataset``):
    ``make_kitti_synth.generate(root, "00", 1160)``, 2048 x 16 rays to
    50 m, written as KITTI .bin files under build/ (kept when complete;
    ``scripts/exp_loop_trust.py: ensure_longrun_dataset``). Builds the
    native reader first. Returns the root and the seconds it took."""
    import os

    from fastliosam_tpu_torch.io.native import native_available
    from fastliosam_tpu_torch.scripts.exp_loop_trust import ensure_longrun_dataset

    t0 = time.perf_counter()
    # exp_loop_trust.GEN_WORKERS processes at nice 10, which they inherit
    # from this thread: they leave the card's feeder process and the
    # machine's own services their cores (6-7 generators busy from the
    # start took an 8-core host down twice)
    os.nice(10)
    native_available()
    root = ensure_longrun_dataset("canyon")
    return root, time.perf_counter() - t0


def _finite(engine) -> bool:
    return bool(np.all(np.isfinite(np.stack(engine.realtime_traj)))
                and np.all(np.isfinite(engine.keyframe_poses())))


def kitti_longrun_phase(dev, root: str, chunk: int = 5):
    """``drive_kitti`` over the whole sequence at the bench's width and
    depth (``bench.py: bench_kitti_longrun``), q16 upload: the bench's
    configuration, then the same run loop-free (the odometry alone, the
    radius of loop candidates set to 0). Gates: every pose finite, the
    loop-free realtime ATE <= 10 m (JAX on a TPU: 3.56 m) and, as a
    regression guard, the bench configuration's <= 20 m (the 10 m target
    is unmet: ROADMAP Queue 3 fault 1; its loop trust is chaotic on this
    feed: the JAX engine gives 3.35 m on a TPU and 7.41 m on the CPU, and
    31 m with the spec's 35 m radius; PERF.md), every kernel of the path
    launched."""
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.io.native import native_available
    from fastliosam_tpu_torch.runtime.drivers import drive_kitti
    from fastliosam_tpu_torch.scripts.exp_loop_trust import loop_audit, make_longrun_engine
    from fastliosam_tpu_torch.utils import host_reads, reset_host_reads

    if not native_available():
        raise AssertionError("KITTI phase: the native reader did not build (g++)")
    engine = make_longrun_engine(device=dev)
    reset_host_reads()
    out, launches = _launch_counts(lambda: drive_kitti(
        engine, root, "00", scan_capacity=32768, chunk=chunk, progress=False))
    n = out["n_scans"]
    result = dict(out, chunk=chunk, upload="q16", scan_capacity=32768,
                  verifications=len(engine.loop_attempts),
                  loop_audit=loop_audit(engine, KittiSequence(root, "00")),
                  host_syncs_per_chunk=host_reads() / -(-n // chunk), launches=launches,
                  launches_per_scan={k: v / n for k, v in launches.items()})
    loop_free = make_longrun_engine(device=dev)
    loop_free.loop_cfg = loop_free.loop_cfg._replace(radius=0.0)
    result["loop_free"] = drive_kitti(loop_free, root, "00", scan_capacity=32768, chunk=chunk,
                                      progress=False)
    print("  " + json.dumps(result))
    lf = result["loop_free"]
    slid = [a for a in result["loop_audit"] if a["t_err_m"] > 5.0]
    print(f"  long-run: {out['scans_per_sec']} scans/s, ATE {out.get('ate_m')} m, keyframe ATE "
          f"{out.get('kf_ate_m')} m, RPE(1 s) {out.get('rpe_1s_m')} m, {out['n_loops']} loops "
          f"({len(slid)} off by more than 5 m against ground truth), {out['n_keyframes']} "
          f"keyframes, {out['n_solves']} solves; loop-free {lf['scans_per_sec']} scans/s, ATE "
          f"{lf.get('ate_m')} m, keyframe ATE {lf.get('kf_ate_m')} m "
          f"(accuracy reference, JAX engine on a TPU: ATE 3.3519 m, keyframe ATE 3.2462 m, "
          f"2 loops, 574 keyframes; loop-free 3.56 m)")
    _fail("KITTI long-run", {
        "every pose finite": _finite(engine) and _finite(loop_free),
        "ground truth read": "ate_m" in out and "ate_m" in lf,
        "loop-free ATE <= 10 m": lf.get("ate_m", np.inf) <= 10.0,
        "ATE <= 20 m (regression guard; the 10 m target is unmet (ROADMAP Queue 3 fault 1))":
            out.get("ate_m", np.inf) <= 20.0,
        "at least one verification": result["verifications"] >= 1,
        "nearest_neighbors, refresh_planes, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "refresh_planes", "merged_moments",
                                      "insert_claim")) > 0,
        **_default_path(launches),
    })
    return result, engine, loop_free


def export_phase(engine, out_dir: Path) -> dict:
    """``save_results`` of the long run; the files checked against the
    engine: PCD ``POINTS`` = the assembled map's size = the points read
    back, KITTI rows = keyframes, the bundle's keys and shapes."""
    from fastliosam_tpu_torch.io.pcd import read_pcd
    from fastliosam_tpu_torch.io.poses import read_kitti_poses
    from fastliosam_tpu_torch.runtime import save_results

    t0 = time.perf_counter()
    paths = save_results(engine, str(out_dir), "00")
    export_s = time.perf_counter() - t0
    n_kf = engine.kf.n
    header = {}
    with open(paths["map_pcd"], "rb") as f:
        for line in f:  # the header ends at its DATA line
            key, _, val = line.decode().strip().partition(" ")
            header[key] = val
            if key == "DATA":
                break
    points = int(header["POINTS"])
    map_size = len(engine.assemble_map(voxel=0.3))
    bundle = np.load(paths["keyframes"])
    shapes = {k: list(bundle[k].shape) for k in bundle.files}
    meta = json.loads(Path(paths["meta"]).read_text())
    result = {"export_s": export_s, "pcd_points": points, "map_size": map_size,
              "kitti_rows": len(read_kitti_poses(paths["kitti"])), "keyframes": n_kf,
              "bundle_shapes": shapes, "files": sorted(Path(p).name for p in paths.values())}
    print("  " + json.dumps(result))
    _fail("export", {
        "PCD POINTS = the map's size": points == map_size == len(read_pcd(paths["map_pcd"])),
        "KITTI rows = keyframes": result["kitti_rows"] == n_kf,
        "bundle keys": set(bundle.files) == {"poses", "stamps", "clouds", "masks"},
        "bundle shapes": shapes["poses"] == [n_kf, 4, 4] and shapes["stamps"] == [n_kf]
        and shapes["clouds"][:1] == [n_kf] and shapes["masks"] == shapes["clouds"][:2],
        "meta": meta["n_keyframes"] == n_kf and meta["n_scans"] == engine.scan_count,
    })
    return result, paths


def _drive_span(engine, stage, c0: int, c1: int, chunk: int, dt: float):
    """Scans [c0, c1) through ``drive_kitti``'s staging and deferred chunk
    loop, then ``finish()``."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(stage, c0, min(chunk, c1 - c0))
        for c in range(c0, c1, chunk):
            scans, imus, stamps = fut.result()
            if c + chunk < c1:
                fut = pool.submit(stage, c + chunk, min(chunk, c1 - c - chunk))
            engine.process_chunk_deferred(scans, imus, stamps, dt)
        engine.finish()


def resume_phase(dev, root: str, ckpt: Path, split: int = 150, end: int = 250, chunk: int = 5):
    """A long-run engine drives scans [0, split) and saves a checkpoint; it
    and a fresh engine restored from that checkpoint then drive [split,
    end) through the same staging code: bit-identical realtime
    trajectories, keyframe poses and loop pairs."""
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.runtime import load_checkpoint, save_checkpoint
    from fastliosam_tpu_torch.runtime.drivers import kitti_stager
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_longrun_engine

    seq = KittiSequence(root, "00")
    dt = float(np.median(np.diff(np.asarray(seq.times, np.float64))))
    t0 = time.perf_counter()

    def run():
        first = make_longrun_engine(device=dev)
        _drive_span(first, kitti_stager(first, seq, 32768, chunk), 0, split, chunk, dt)
        save_checkpoint(first, str(ckpt))
        _drive_span(first, kitti_stager(first, seq, 32768, chunk), split, end, chunk, dt)
        restored = load_checkpoint(make_longrun_engine(device=dev), str(ckpt))
        _drive_span(restored, kitti_stager(restored, seq, 32768, chunk), split, end, chunk, dt)
        return first, restored

    (first, restored), launches = _launch_counts(run)
    same = {
        "realtime trajectories bit-identical": np.array_equal(np.stack(first.realtime_traj),
                                                              np.stack(restored.realtime_traj)),
        "keyframe poses bit-identical": np.array_equal(first.keyframe_poses(),
                                                       restored.keyframe_poses()),
        "loop pairs equal": first.loop_pairs == restored.loop_pairs,
        "every pose finite": _finite(restored),
    }
    result = {"split": split, "end": end, "seconds": time.perf_counter() - t0,
              "checkpoint_mb": ckpt.stat().st_size / 2**20, "keyframes": restored.kf.n,
              "loop_pairs": list(restored.loop_pairs), "solves": restored.solve_count,
              "launches": launches, **same}
    print("  " + json.dumps(result))
    _fail("resume", same)
    return result


def _kitti_scan(seq, i: int, dev, cap: int = 32768):
    """Scan ``i`` as ``scripts/localize.py`` stages it: xyz and azimuth
    times padded to ``cap``, masked."""
    from fastliosam_tpu_torch.scripts.run_slam import padded_scan

    xyz, _, toff = seq.scan(i)
    return padded_scan(xyz, toff, cap, dev)


def _perturbed(pose, metres: float = 1.0, yaw_deg: float = 5.0):
    """``pose`` moved by ``metres`` (along (0.8, 0.6, 0)) and turned by
    ``yaw_deg`` about z."""
    a = np.deg2rad(yaw_deg)
    d = np.eye(4, dtype=np.float32)
    d[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    d[:3, 3] = np.array([0.8, 0.6, 0.0]) * metres
    return (pose @ d).astype(np.float32)


def localize_phase(dev, root: str, bundle: str, ref_pose, n_scans: int = 200):
    """``MapLocalizer`` on the long run's bundle (2^19 slots, the
    localizer's defaults): ``global_init`` on scan 0 from its pose in the
    map perturbed by 1 m and 5 degrees of yaw, then ``process`` on scans
    0..n_scans-1 with the empty IMU batch of ``scripts/localize.py``."""
    import torch

    from fastliosam_tpu_torch.eval import align_umeyama
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.map import VoxelMapConfig
    from fastliosam_tpu_torch.odom import ImuBatch, OdomConfig
    from fastliosam_tpu_torch.runtime import MapLocalizer

    seq = KittiSequence(root, "00")
    no_imu = ImuBatch(torch.full((8,), 1e9, device=dev), torch.zeros((8, 3), device=dev),
                      torch.zeros((8, 3), device=dev),
                      torch.zeros((8,), dtype=torch.bool, device=dev))

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc = MapLocalizer(bundle, map_cfg=VoxelMapConfig(capacity=1 << 19),
                           odom_cfg=OdomConfig(), device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fitness = loc.global_init(_kitti_scan(seq, 0, dev), _perturbed(ref_pose))
        poses, matched = [], []
        t_prev = float(seq.times[0]) - 0.1
        t1 = time.perf_counter()
        for i in range(n_scans):
            stamp = float(seq.times[i])
            T, n = loc.process(_kitti_scan(seq, i, dev), no_imu, max(stamp - t_prev, 0.05))
            poses.append(T)
            matched.append(n)
            t_prev = stamp
        return loc, build_s, fitness, np.stack(poses), matched, time.perf_counter() - t1

    (loc, build_s, fitness, poses, matched, steps_s), launches = _launch_counts(run)
    est = poses[:, :3, 3]
    gt = seq.gt_poses()[:n_scans, :3, 3]
    _, R, t = align_umeyama(est, gt)
    ate = float(np.sqrt(np.mean(np.sum((est @ R.T + t - gt) ** 2, axis=1))))
    result = {"scans": n_scans, "map_build_s": build_s,
              "map_voxels": int((loc.vmap.fp != 0).sum()), "global_init_fitness": fitness,
              "matched_min": int(min(matched)), "matched_mean": float(np.mean(matched)),
              "matched": matched, "ate_m": ate, "steps_per_s": n_scans / steps_s,
              "launches": launches}
    print("  " + json.dumps(result))
    print(f"  localize: map build {build_s:.3f} s, global-init fitness {fitness:.4f}, matched "
          f"{min(matched)}..{max(matched)} per scan, localized ATE {ate:.4f} m over {n_scans} "
          f"scans (no IMU, no motion model: the JAX step's behaviour)")
    _fail("localize", {
        "every pose finite": bool(np.all(np.isfinite(poses))),
        "every step matched points": min(matched) > 0,
        "nearest_neighbors, refresh_planes, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "refresh_planes", "merged_moments",
                                      "insert_claim")) > 0,
        **_default_path(launches),
    })
    return result, loc


def localizer_kernel_inputs(dev, bundle: str, loc, root: str, ref_pose, batch: int = 65536):
    """The localizer's kernel inputs at their own shapes: the map of
    ``build_map_from_keyframes`` after half its batches and the next
    65,536-point batch (the insert), the slots that insert gives (the
    plane refresh's reads of the (2^19, 10) moments and (2^19, 3)
    coordinates), and ``global_init``'s first ICP query: the 8192
    downsampled points of scan 0 at the perturbed guess against the
    finished map's (2^19,) voxel centroids."""
    import torch

    from fastliosam_tpu_torch.core.pointcloud import Cloud, voxel_downsample
    from fastliosam_tpu_torch.io import KittiSequence
    from fastliosam_tpu_torch.map import insert, make_map, occupied_centroids
    from fastliosam_tpu_torch.runtime.localizer import keyframe_world_points

    cfg = loc.map_cfg
    flat, fmask = keyframe_world_points(bundle)
    half = (len(flat) // batch // 2) * batch
    m = make_map(cfg, dev)
    for s in range(0, half, batch):
        m, _ = insert(m, cfg, torch.from_numpy(flat[s: s + batch]).to(dev),
                      torch.from_numpy(fmask[s: s + batch]).to(dev))
    xyz = torch.from_numpy(flat[half: half + batch]).to(dev)
    mask = torch.from_numpy(fmask[half: half + batch]).to(dev)
    seq = KittiSequence(root, "00")
    scan = _kitti_scan(seq, 0, dev)
    ds = voxel_downsample(Cloud(scan.xyz, scan.mask), loc.odom_cfg.filter_size_surf)
    guess = torch.from_numpy(_perturbed(ref_pose)).to(dev)
    src = (ds.xyz[:8192] @ guess[:3, :3].T + guess[:3, 3]).contiguous()
    dst, occ = occupied_centroids(loc.vmap, cfg)
    return {"map": m, "cfg": cfg, "xyz": xyz, "mask": mask,
            "nn": (src, dst.contiguous(), occ.contiguous())}


def check_localizer_shapes(dev, inp, reps: int = 10) -> dict:
    """Each kernel against its plain version at the localizer's shapes,
    timed beside the plain version, a one-call PyTorch yardstick and the
    bound. Returns ``{kernel: record}``."""
    import torch

    from fastliosam_tpu_torch.map import insert
    from fastliosam_tpu_torch.ops import insert_cuda, nn_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    out = {}
    # the insert: 65,536 points into the half-built 2^19-slot map
    m, cfg, xyz, mask = inp["map"], inp["cfg"], inp["xyz"], inp["mask"]
    rounds = max(cfg.insert_probes, cfg.claim_probes)
    args = (m.fp, m.coords, m.moments, xyz, mask, cfg.voxel_size, rounds,
            cfg.max_points_per_voxel)
    got = insert_cuda.insert_claim_cuda(*args)
    want = insert_cuda.insert_claim_ref(*args)
    torch.cuda.synchronize()
    assigned = want[2] < cfg.capacity
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]) and torch.equal(got[4], want[4])
            and torch.equal(got[3][assigned].view(torch.int32),
                            want[3][assigned].view(torch.int32))):
        raise AssertionError("insert_claim at the localizer's shape: kernel and plain differ")
    fresh = iter([(m.fp.clone(), m.coords.clone()) for _ in range(reps + 3)])
    ms = device_ms(lambda: insert_cuda.insert_claim_into(*next(fresh), *args[2:]), [()] * reps)
    plain_ms = device_ms(lambda: insert_cuda.insert_claim_ref(*args), [()] * 3)
    nbytes = insert_cuda.hbm_bytes(m.fp.cpu().numpy(), xyz, mask, got[2], cfg.voxel_size, rounds)
    blocks, per_thread = insert_cuda.insert_claim_grid(xyz.shape[0], dev)
    out["insert_claim"] = {
        "shape": f"{xyz.shape[0]} points into the 2^19-slot localizer map after half its "
                 f"batches, {rounds} rounds", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        "grid_blocks": blocks, "points_per_thread": per_thread,
        "dropped": int(got[4]), "new_voxels": int((got[0] != 0).sum() - (m.fp != 0).sum())}
    # the plane refresh after that insert, at its slots: the moments after
    # its scatter, the plane tables before it
    m2, _ = insert(m, cfg, xyz, mask, refresh_planes=False)
    out["refresh_planes"] = check_refresh_planes(
        dev, f"(2^{cfg.capacity.bit_length() - 1}, 10) x {xyz.shape[0]} int64 slots (the "
        "localizer's map build)", [(m2.moments, m2.coords, got[2], m.normal, m.d,
                                     m.plane_valid)], cfg, launch_floor_ms(1), repeat=reps)
    # the NN: global_init's ICP query against the map's voxel centroids
    src, dst, occ = inp["nn"]
    k_idx, k_d2 = nn_cuda.nearest_neighbors_cuda(src, dst, occ)
    r_idx, r_d2 = nn_cuda.nearest_neighbors_ref(src, dst, occ)
    torch.cuda.synchronize()
    # both compute d2 = |s|^2 + |d|^2 - 2 s.d in float32, summed in other
    # orders: with map coordinates of ~100 m the expansion's own rounding
    # is a few ulps of |s|^2 + |d|^2 (~1e4 m^2), far above rtol 1e-5 of
    # the O(1) m^2 distances, so the tolerance is 4 ulps of that sum
    # (indices may differ only where the two candidates' d2 agree as well)
    mag = (src ** 2).sum(-1) + (dst[r_idx.long()] ** 2).sum(-1)
    tol = 1e-5 * r_d2.abs() + 4 * 2.0 ** -23 * mag
    if not bool(((k_d2 - r_d2).abs() <= tol).all()):
        raise AssertionError("nn at the localizer's shape: d2 differs")
    diff = k_idx != r_idx
    if bool(diff.any()):
        s = src[diff]
        dk = ((s - dst[k_idx[diff].long()]) ** 2).sum(-1)
        dr = ((s - dst[r_idx[diff].long()]) ** 2).sum(-1)
        if not bool(((dk - dr).abs() <= tol[diff]).all()):
            raise AssertionError("nn at the localizer's shape: an index differs (not a tie)")
    n, mm = src.shape[0], dst.shape[0]

    def library():  # one cdist + masked min over 8192 x 2^19 distances (17 GB)
        d = torch.cdist(src, dst)
        return d.masked_fill_(~occ[None, :], float("inf")).min(dim=1)

    valid = int(occ.sum())
    t_ops = 8.0 * n * valid / H100_F32_FLOPS * 1e3
    t_bytes = (n * 12 + mm * 12 + mm + n * 8) / H100_BYTES_PER_S * 1e3
    slices, slice_len = nn_cuda.slice_plan(n, mm)
    out["nearest_neighbors"] = {
        "shape": f"{n} x {mm} ({valid} occupied voxels)",
        "max_abs_err": float((k_d2 - r_d2).abs().max()), "ties": int(diff.sum()),
        "tolerance": "1e-5 |d2| + 4 ulp(|s|^2 + |d|^2)",
        "ms": device_ms(lambda: nn_cuda.nearest_neighbors_cuda(src, dst, occ), [()] * reps),
        "plain_ms": device_ms(lambda: nn_cuda.nearest_neighbors_ref(src, dst, occ), [()] * 2),
        "library_ms": device_ms(library, [()] * 2),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "slices": slices, "slice_len": slice_len}
    for name, rec in out.items():
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        print(f"  {name} at {rec['shape']}: equal to the plain version, kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, library {lib}, bound {rec['bound_ms']:.5f} ms")
    return out


def kitti_phase(dev, root: str, chunk: int = 5) -> tuple:
    """The dataset entry point at the bench's width and depth: the long
    run, its export, the resume and the relocalization, and the kernels at
    the localizer's shapes. Returns the results and the loop-free engine
    (phase 16's oracle starts from it)."""
    out_dir = ROOT / "build" / "kitti_export"
    print(f"  long-run (drive_kitti, chunk {chunk}, q16):")
    longrun, engine, loop_free = kitti_longrun_phase(dev, root, chunk)
    print("  export (save_results):")
    export, paths = export_phase(engine, out_dir)
    ref_pose = np.asarray(engine.realtime_traj[0])
    del engine
    print("  resume (save_checkpoint / load_checkpoint):")
    resume = resume_phase(dev, root, out_dir / "resume_ckpt.npz", chunk=chunk)
    print("  localize (MapLocalizer):")
    localize, loc = localize_phase(dev, root, paths["keyframes"], ref_pose)
    print("  kernels at the localizer's shapes:")
    shapes = check_localizer_shapes(
        dev, localizer_kernel_inputs(dev, paths["keyframes"], loc, root, ref_pose))
    return {"longrun": longrun, "export": export, "resume": resume, "localize": localize,
            "kernel_shapes": shapes}, loop_free


# ---------------------------------------------------------------------------
# bag phase: the ROS-bag entry point (run_slam --dataset bag) at Ouster OS1-64
# width, and the MulRan and Newer College readers over the same recording
# ---------------------------------------------------------------------------
BAG_PRESET = "newer-college2020"
OS1_64 = (1024, 64)  # azimuths x rings: 65,536 points a scan
BAG_SHORT_SCANS = 50  # the MulRan and Newer College runs
# ATE gates (m): the figure-8 gate, which holds for the bag run while the
# JAX package on the CPU reads <= 0.05 m at 512 x 64 over the same 150
# scans (it read 0.0358 m; tests/test_torch_longrun.py), and for the MulRan
# run with GPS the larger of 0.10 m and twice JAX's reading there (0.0344 m)
BAG_ATE_GATE = 0.10
MULRAN_ATE_GATE = max(0.10, 2 * 0.0344)


def bag_feed(n_scans: int = 150, seed: int = 11) -> str:
    """The figure-8 recording (``sim/writers.py: render_figure8``: the
    loop feed of phases 4-7, started from rest) at OS1-64 geometry in the
    ``newer-college2020`` preset's LiDAR frame, written under build/ as
    the Ouster driver publishes it: ``figure8.bag`` (all scans; IMU at
    100 Hz, NavSatFix at 1 Hz), ``figure8_short.bag`` and
    ``registered_poses.csv`` (the first ``BAG_SHORT_SCANS`` scans, for the
    Newer College reader), ``mulran/`` (the same scans as a MulRan
    directory, GPS at 10 Hz) and ``truth.npz``. The recording's clock
    starts at 1000 s (``writers.T0_NS``), not at a Unix epoch as a real
    bag's does: both engines keep keyframe stamps in float32, so at an
    epoch no loop is ever tried and the bag phase's loop gate could not
    hold (ROADMAP Queue 3 fault 3, queued). Runs in a worker process at
    nice 10 (it takes minutes of host time); kept when complete."""
    import os
    import shutil

    from fastliosam_tpu_torch.io.presets import PRESETS
    from fastliosam_tpu_torch.sim import writers

    os.nice(10)
    out = ROOT / "build" / f"chip_smoke_bag_{n_scans}_{seed}_{OS1_64[0]}x{OS1_64[1]}"
    if out.exists():
        return str(out)
    tmp = out.with_name(out.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    pre = PRESETS[BAG_PRESET]
    data = writers.render_figure8(n_scans, pre, *OS1_64, seed=seed)
    writers.write_bag(str(tmp / "figure8.bag"), data, pre, *OS1_64)
    writers.write_bag(str(tmp / "figure8_short.bag"), data, pre, *OS1_64,
                      n_scans=BAG_SHORT_SCANS)
    writers.write_gt_csv(str(tmp / "registered_poses.csv"), data, n_scans=BAG_SHORT_SCANS)
    writers.write_mulran(str(tmp / "mulran"), data, *OS1_64, pre.extrinsic_R, pre.extrinsic_T,
                         n_scans=BAG_SHORT_SCANS)
    np.savez(tmp / "truth.npz", gt_p=np.stack([g[1] for g in data["gt"]]))
    tmp.rename(out)
    return str(out)


@contextlib.contextmanager
def _trace_from_scan(k: int):
    """``torch.profiler`` from the ``k``-th call of ``SlamEngine.process``
    (patched on the class inside the block) to the end of the block: the
    last scans of a ``run_slam`` run, its finish and output included.
    Yields a dict that holds the profiler and the window's wall seconds
    once the block ends."""
    from fastliosam_tpu_torch.runtime import SlamEngine

    trace, calls, process = {}, [0], SlamEngine.process

    def traced(self, *args, **kw):
        if calls[0] == k:
            trace["prof"], trace["t0"] = _start_profile()
        calls[0] += 1
        return process(self, *args, **kw)

    SlamEngine.process = traced
    try:
        yield trace
    finally:
        SlamEngine.process = process
        if "prof" in trace:
            trace["prof"].__exit__(None, None, None)
            trace["wall_s"] = time.perf_counter() - trace["t0"]


def _cli_run(argv):
    """``run_slam.run(argv)`` (the body of its ``main``) with every
    kernel's launch count set to 0 just before and the host reads counted:
    returns the engine, the drive's host seconds, the host reads and the
    launch counts."""
    from fastliosam_tpu_torch.scripts import run_slam
    from fastliosam_tpu_torch.utils import host_reads, reset_host_reads

    def drive():
        reset_host_reads()
        engine, drive_s = run_slam.run(argv)
        return engine, drive_s, host_reads()

    (engine, drive_s, reads), launches = _launch_counts(drive)
    return engine, drive_s, reads, launches


def _cli_result(engine, drive_s, reads, launches, gt_p) -> dict:
    from fastliosam_tpu_torch.eval import ate_rmse

    rt = np.stack(engine.realtime_traj)
    n = len(rt)
    return {
        "scans": n, "scans_per_s": n / drive_s, "keyframes": engine.kf.n,
        "loops": len(engine.loop_pairs), "verifications": len(engine.loop_attempts),
        "solves": engine.solve_count, "gps_factors": int(engine.graph.n_gps),
        "ate_m": ate_rmse(rt[:, :3, 3], gt_p[:n], align=True),
        "host_reads_per_scan": reads / n, "launches": launches,
        "launches_per_scan": {k: v / n for k, v in launches.items()},
        "finite": _finite(engine), "loop_pairs": [list(map(int, p)) for p in engine.loop_pairs],
    }


def _decoded_equal(short_bag: str) -> dict:
    """The Newer College reader's scans and IMU against ``BagSequence``'s
    on the same bag: xyz, intensity and stamps bit for bit, the IMU as
    float32 (the reader keeps float64, the preset stream float32), point
    times within one float32 step of the 0.1 s sweep (the reader scales
    in float32, the preset stream in float64)."""
    from fastliosam_tpu_torch.io.newer_college import NewerCollegeSequence
    from fastliosam_tpu_torch.io.presets import PRESETS, BagSequence

    nc = list(NewerCollegeSequence(bags=short_bag).stream())
    bs = [e for e in BagSequence(short_bag, PRESETS[BAG_PRESET]).stream() if e[0] != "gps"]
    ok = len(nc) == len(bs)
    dt_max, n_scans = 0.0, 0
    for (k1, s1, p1), (k2, s2, p2) in zip(nc, bs):
        ok = ok and k1 == k2 and s1 == s2
        if not ok:
            break
        if k1 == "scan":
            n_scans += 1
            ok = np.array_equal(p1[0], p2[0]) and np.array_equal(p1[1], p2[1])
            dt_max = max(dt_max, float(np.abs(p1[2].astype(np.float64) - p2[2]).max()))
        else:
            ok = all(np.array_equal(np.float32(a), np.float32(b)) for a, b in zip(p1, p2))
    return {"equal": bool(ok and dt_max <= float(np.spacing(np.float32(0.1)))),
            "events": len(nc), "scans": n_scans,
            "max_point_time_diff_s": dt_max}


def bag_phase(dev, feed_dir: str) -> dict:
    """The ROS-bag entry point through the port's CLI (``run_slam.run``,
    the body of ``run_slam.main``) on the card: ``--dataset bag --preset
    newer-college2020`` over the 150-scan OS1-64 recording at the default
    131,072-point scan capacity, 8192 iEKF points, a 2^19-slot map and
    loops at 10 m / 4 s (GPS off: the fixes are decoded, not used), twice,
    each from a freshly built engine; the replay is traced with
    ``torch.profiler``. Gates: the two runs bit-identical (trajectories and
    loop pairs), ATE < ``BAG_ATE_GATE`` (Umeyama-aligned: the CLI starts at
    the identity), a loop verification (possible only because the
    recording's clock starts at 1000 s: see :func:`bag_feed`), every pose
    finite and
    merged_moments, insert_claim, gather_rows and nearest_neighbors
    launched. Then ``--dataset mulran --use-gps`` over the first 50 scans'
    MulRan directory (GPS factors > 0, ATE < ``MULRAN_ATE_GATE``) and
    ``--dataset newer-college --gt-csv`` over their bag (the decoded scans
    and IMU those of ``BagSequence``; finite poses; its ATE printed, not
    gated: that path applies no extrinsic, as the JAX script's)."""
    import torch

    d = Path(feed_dir)
    gt_p = np.load(d / "truth.npz")["gt_p"]
    out = ROOT / "build" / "bag_runs"
    argv = ["--dataset", "bag", "--preset", BAG_PRESET, "--root", str(d / "figure8.bag"),
            "--num-ds-points", "8192", "--map-capacity-log2", "19", "--loop-radius", "10",
            "--loop-time-gap", "4", "--out", str(out / "bag")]
    print(f"  bag: run_slam {' '.join(argv)}")
    engine, drive_s, reads, launches = _cli_run(argv)
    bag = _cli_result(engine, drive_s, reads, launches, gt_p)
    first = (np.stack(engine.realtime_traj), list(engine.loop_pairs))
    del engine
    window = min(TRACED_BAG_SCANS, bag["scans"])
    with _trace_from_scan(bag["scans"] - window) as trace:
        engine, _, _, _ = _cli_run(argv)
        torch.cuda.synchronize()
    bag["replay_bit_identical"] = _replay(engine, first)
    bag["device_ops_per_scan"] = profile_summary(
        trace["prof"], trace["wall_s"], window, top=6)["device_ops_per_scan"]
    del engine
    print("  bag: " + json.dumps(bag))
    _fail("bag phase, bag", {
        "150 scans": bag["scans"] == len(gt_p),
        "every pose finite": bag["finite"],
        f"ATE < {BAG_ATE_GATE} m": bag["ate_m"] < BAG_ATE_GATE,
        "at least one verification": bag["verifications"] >= 1,
        "replay bit-identical": bag["replay_bit_identical"],
        "merged_moments, insert_claim, refresh_planes and nearest_neighbors launched":
            min(launches[k] for k in ("merged_moments", "insert_claim", "refresh_planes",
                                      "nearest_neighbors")) > 0,
        **_default_path(launches),
    })

    argv = ["--dataset", "mulran", "--root", str(d / "mulran"), "--use-gps",
            "--num-ds-points", "8192", "--map-capacity-log2", "19", "--out", str(out / "mulran")]
    print(f"  mulran: run_slam {' '.join(argv)}")
    mulran = _cli_result(*_cli_run(argv), gt_p)
    print("  mulran: " + json.dumps(mulran))
    _fail("bag phase, mulran", {
        "50 scans": mulran["scans"] == BAG_SHORT_SCANS,
        "every pose finite": mulran["finite"],
        "GPS factors > 0": mulran["gps_factors"] > 0,
        f"ATE < {MULRAN_ATE_GATE} m": mulran["ate_m"] < MULRAN_ATE_GATE,
    })

    argv = ["--dataset", "newer-college", "--root", str(d / "figure8_short.bag"),
            "--gt-csv", str(d / "registered_poses.csv"), "--num-ds-points", "8192",
            "--map-capacity-log2", "19", "--out", str(out / "newer_college")]
    print(f"  newer college: run_slam {' '.join(argv)}")
    engine, *rest = _cli_run(argv)
    nc = _cli_result(engine, *rest, gt_p)
    nc["decoded"] = _decoded_equal(str(d / "figure8_short.bag"))
    from fastliosam_tpu_torch.io.newer_college import NewerCollegeSequence

    gt_csv = NewerCollegeSequence(bags=str(d / "figure8_short.bag"),
                                  gt_csv=str(d / "registered_poses.csv")).gt
    nc["gt_csv_rows"] = len(gt_csv["stamps"])
    nc["gt_csv_max_diff_m"] = float(np.abs(gt_csv["poses"][:, :3, 3]
                                           - gt_p[:BAG_SHORT_SCANS]).max())
    del engine
    print("  newer college: " + json.dumps(nc))
    print(f"  ATE (Umeyama-aligned, m): bag {bag['ate_m']:.4f} (gate {BAG_ATE_GATE}), MulRan "
          f"with GPS {mulran['ate_m']:.4f} (gate {MULRAN_ATE_GATE}), Newer College "
          f"{nc['ate_m']:.4f} (not gated: no extrinsic applied)")
    _fail("bag phase, newer college", {
        "50 scans": nc["scans"] == BAG_SHORT_SCANS,
        "every pose finite": nc["finite"],
        "decoded scans and IMU equal BagSequence's": nc["decoded"]["equal"],
        "ground-truth csv read": nc["gt_csv_rows"] == BAG_SHORT_SCANS
        and nc["gt_csv_max_diff_m"] < 1e-6,
    })
    return {"bag": bag, "mulran": mulran, "newer_college": nc}


# ---------------------------------------------------------------------------
# batched phase (eval/batch_eval.py: batched_rollout)
# ---------------------------------------------------------------------------
BATCH_LANES = 8
BATCH_SCANS = 75
BATCH_STRIDE = 10  # lane b runs scans [10 b, 10 b + 75) of the figure-8 feed
BATCH_TRACED = 15  # the replay's last steps, traced
BATCH_CACHED_SCANS = 20
# each lane's ATE (m) in the JAX package's odom_rollout of its window at this
# width, on the CPU (tests/test_torch_batch_eval.py::test_figure8_windows_jax_reference);
# from scan 0 the reference reads 0.02 m, as the per-scan phase, but three windows
# started mid-path read 0.11-0.18 m in the reference itself, so each lane is held to
# max(0.10 m, its window's reading + 1 cm). The cause is the empty map a window
# starts from, not the filter's start state: merged3 matches under 100 points in
# scan 1 against a one-scan map, and on the map built from scan 0 a fresh filter
# reads 0.02 m on those windows in both packages
# (tests/test_torch_batch_eval.py::test_figure8_windows_drift_source)
BATCH_JAX_ATE_M = (0.0198, 0.1114, 0.1686, 0.0641, 0.1578, 0.0697, 0.0539, 0.0169)
BATCH_CACHED_JAX_ATE_M = (0.0638, 0.0380, 0.0676, 0.0184, 0.0325, 0.0257, 0.1782, 0.0093)
BATCH_ATE_GATE, BATCH_ATE_MARGIN = 0.10, 0.01
BATCH_VS_UNBATCHED_M = 5e-3  # over the first 4 scans: tests/test_batch_eval.py's bound
BATCH_KERNEL_LANES = (8, 32)  # the insert's lane counts; the association's 8 and a ragged 3


def batch_inputs(dev, feed, firsts, n_scans: int):
    """The windows ``[f, f + n_scans)`` of the feed stacked lane by lane on
    the card, ``(Scan, ImuBatch)`` with ``(B, S, ...)`` members, and their
    ground-truth positions ``(B, S, 3)``."""
    import torch

    from fastliosam_tpu_torch.odom import ImuBatch, Scan

    def stack(key):
        return torch.from_numpy(np.stack([feed[key][f:f + n_scans] for f in firsts])).to(dev)

    return (Scan(stack("xyz"), stack("toff"), stack("mask")),
            ImuBatch(stack("imu_t"), stack("imu_g"), stack("imu_a"), stack("imu_m")),
            np.stack([feed["gt_p"][f:f + n_scans] for f in firsts]))


def batch_states(dev, feed, firsts, cfg, map_cfg):
    """``init_odom(..., lanes=B)`` with lane b at the ground truth's pose and
    velocity where its window starts (the end of scan ``f - 1``; the feed
    starts at t = 0)."""
    import torch

    from fastliosam_tpu_torch.odom import init_odom

    traj = figure8_traj()
    t0 = [float(feed["stamps"][f] - feed["stamps"][0]) for f in firsts]
    R = np.stack([traj.pose(t)[0] for t in t0]).astype(np.float32)
    p = np.stack([traj.pose(t)[1] for t in t0]).astype(np.float32)
    v = np.stack([traj.velocity(t) for t in t0]).astype(np.float32)
    st = init_odom(map_cfg, cfg, device=dev, lanes=len(firsts))
    return st._replace(nav=st.nav._replace(
        R=torch.from_numpy(R).to(dev), p=torch.from_numpy(p).to(dev),
        v=torch.from_numpy(v).to(dev)))


def _window(tree, k0: int, k1: int):
    """Scans ``[k0, k1)`` of every lane of a ``(B, S, ...)`` stack."""
    return type(tree)(*(t[:, k0:k1] for t in tree))


def _lane_ate(p, gt) -> np.ndarray:
    return np.sqrt(np.mean(np.sum((p - gt) ** 2, axis=-1), axis=-1))


def _same(a: dict, b: dict, lanes_a=slice(None), lanes_b=slice(None)) -> bool:
    """Bit-identical poses and match counts of the given lanes."""
    import torch

    return all(torch.equal(a[k][lanes_a], b[k][lanes_b]) for k in ("R", "p", "n_matched"))


def batched_phase(dev, feed, floor) -> dict:
    """``batched_rollout`` at the per-scan phase's width (8 lanes x 75
    scans, lane b over scans [10 b, 10 b + 75) from the ground truth there):
    each lane's ATE, the matches a scan, the replay (its last steps traced),
    lane isolation, lane 0 against the unbatched ``odom_rollout``, the map
    kernels' launches a step at 1 lane and at 8, and a cached-mode batch
    (8 lanes x 20 scans); then the lane kernels at the rollout's maps
    (``check_lane_kernels``)."""
    import torch

    from fastliosam_tpu_torch.eval.batch_eval import batched_rollout
    from fastliosam_tpu_torch.odom import ImuBatch, Scan, init_odom, odom_rollout
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(dev)
    cfg, map_cfg = engine.odom_cfg, engine.map_cfg
    del engine
    dt = float(feed["scan_dt"])
    n_scans = min(BATCH_SCANS, len(feed["stamps"]) - BATCH_STRIDE * (BATCH_LANES - 1))
    firsts = [BATCH_STRIDE * b for b in range(BATCH_LANES)]
    scans, imus, gt = batch_inputs(dev, feed, firsts, n_scans)

    def roll(states, sc, im, cfg_=cfg):
        return batched_rollout(states, sc, im, dt, cfg_, map_cfg, device=dev)

    def fresh(fs=firsts, cfg_=cfg):
        return batch_states(dev, feed, fs, cfg_, map_cfg)

    roll(fresh(), _window(scans, 0, 3), _window(imus, 0, 3))  # warm-up: allocator, cuBLAS
    states = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    (fin, aux), launches = _launch_counts(lambda: roll(states, scans, imus))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    p, matched = aux["p"].cpu().numpy(), aux["n_matched"].cpu().numpy()
    ate = _lane_ate(p, gt)

    # the replay, its last steps traced (tracing changes no result)
    split = n_scans - BATCH_TRACED
    st2, first = roll(fresh(), _window(scans, 0, split), _window(imus, 0, split))
    prof, t_prof = _start_profile()
    fin2, last = roll(st2, _window(scans, split, n_scans), _window(imus, split, n_scans))
    torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t_prof
    prof.__exit__(None, None, None)
    print(f"  traced: the replay's last {BATCH_TRACED} batched steps "
          f"({BATCH_LANES} lanes each)")
    prof_sum = profile_summary(prof, prof_wall, BATCH_TRACED)
    replay = {k: torch.cat([first[k], last[k]], 1) for k in ("R", "p", "n_matched")}
    replay_ok = _same(replay, aux) and all(torch.equal(a, b) for a, b in zip(fin2.vmap, fin.vmap))

    # lane isolation: lane 7 carries lane 0's window
    iso_firsts = firsts[:-1] + [firsts[0]]
    iso_scans, iso_imus, _ = batch_inputs(dev, feed, iso_firsts, n_scans)
    _, iso = roll(fresh(iso_firsts), iso_scans, iso_imus)
    last_lane = BATCH_LANES - 1
    iso_others = _same(iso, aux, slice(0, last_lane), slice(0, last_lane))
    iso_copy = _same(iso, iso, slice(last_lane, None), slice(0, 1))

    # launches a step at 1 lane, over the first 5 scans of lane 0's window
    one_scans = 5
    one_sc = Scan(*(t[:1, :one_scans] for t in scans))
    one_im = ImuBatch(*(t[:1, :one_scans] for t in imus))
    _, one = _launch_counts(lambda: roll(fresh(firsts[:1]), one_sc, one_im))
    per_step = {k: {"lanes_8": launches[k] / n_scans, "lanes_1": one[k] / one_scans}
                for k in ("merged_moments", "insert_claim")}

    # lane 0 against the unbatched rollout of its window
    st1 = init_odom(map_cfg, cfg, device=dev)
    nav0 = fresh(firsts[:1]).nav
    st1 = st1._replace(nav=type(st1.nav)(*(t[0] for t in nav0)))
    _, ref = odom_rollout(st1, Scan(*(t[0] for t in scans)), ImuBatch(*(t[0] for t in imus)),
                          dt, cfg, map_cfg, device=dev)
    diff = np.abs(p[0] - ref["p"].cpu().numpy()).max(axis=-1)

    # the cached query mode: its two lane kernels on the rollout's path
    ccfg = cfg._replace(query_mode="cached")
    c_scans, c_imus, c_gt = batch_inputs(dev, feed, firsts, BATCH_CACHED_SCANS)
    (_, c_aux), c_launches = _launch_counts(
        lambda: roll(fresh(cfg_=ccfg), c_scans, c_imus, ccfg))
    c_ate = _lane_ate(c_aux["p"].cpu().numpy(), c_gt)
    lanes = len(firsts)
    gate = np.maximum(BATCH_ATE_GATE, np.asarray(BATCH_JAX_ATE_M[:lanes]) + BATCH_ATE_MARGIN)
    c_gate = np.maximum(BATCH_ATE_GATE,
                        np.asarray(BATCH_CACHED_JAX_ATE_M[:lanes]) + BATCH_ATE_MARGIN)

    result = {
        "lanes": BATCH_LANES, "scans": n_scans, "wall_s": wall,
        "lane_scans_per_s": BATCH_LANES * n_scans / wall,
        "ate_m": ate.tolist(), "ate_gate_m": gate.tolist(), "jax_cpu_ate_m": BATCH_JAX_ATE_M,
        "min_matched_from_scan3": matched[:, 3:].min(axis=1).tolist(),
        "replay_bit_identical": replay_ok,
        "isolation_lanes_0_6_unchanged": iso_others, "isolation_lane7_equals_lane0": iso_copy,
        "lane0_vs_unbatched_first4_m": float(diff[:4].max()),
        "lane0_vs_unbatched_window_m": float(diff.max()),
        "launches": launches, "launches_per_step": per_step,
        "device_ops_per_step": prof_sum["device_ops_per_scan"],
        "device_idle_share": prof_sum["device_idle_share"],
        "max_memory_allocated_bytes": int(peak),
        "cached": {"scans": BATCH_CACHED_SCANS, "ate_m": c_ate.tolist(),
                   "ate_gate_m": c_gate.tolist(), "jax_cpu_ate_m": BATCH_CACHED_JAX_ATE_M,
                   "launches": c_launches},
    }
    print("  " + json.dumps(result))
    print(f"  {BATCH_LANES} lanes x {n_scans} scans: {result['lane_scans_per_s']:.2f} lane-scans/s "
          f"({wall:.3f} s), ATE per lane {np.round(ate, 4).tolist()} m (JAX on the CPU "
          f"{list(BATCH_JAX_ATE_M)}; gates {np.round(gate, 4).tolist()}), "
          f"lane 0 against the unbatched rollout {result['lane0_vs_unbatched_first4_m']:.3g} m over "
          f"4 scans, {result['lane0_vs_unbatched_window_m']:.3g} m over the window; "
          f"{result['device_ops_per_step']:.0f} device ops a batched step, device idle "
          f"{result['device_idle_share']:.1%}; peak memory {peak / 2**30:.3f} GiB; "
          f"cached mode ATE per lane {np.round(c_ate, 4).tolist()} m (JAX on the CPU "
          f"{list(BATCH_CACHED_JAX_ATE_M)})")
    _fail("batched phase", {
        "every pose finite": bool(np.all(np.isfinite(p))),
        f"ATE < max({BATCH_ATE_GATE} m, the reference's + {BATCH_ATE_MARGIN} m) in every lane":
            bool(np.all(ate < gate)),
        "n_matched > 500 a scan in every lane from scan 3 on": bool(matched[:, 3:].min() > 500),
        "replay bit-identical": replay_ok,
        "lanes 0-6 bit-identical with lane 7 changed": iso_others,
        "lane 7 bit-identical with lane 0 on lane 0's window": iso_copy,
        f"lane 0 within {BATCH_VS_UNBATCHED_M} m of the unbatched rollout over 4 scans":
            result["lane0_vs_unbatched_first4_m"] <= BATCH_VS_UNBATCHED_M,
        "merged_moments and insert_claim launched": min(launches["merged_moments"],
                                                        launches["insert_claim"]) > 0,
        "merged_moments and insert_claim launch as often a step at 8 lanes as at 1":
            all(v["lanes_8"] == v["lanes_1"] for v in per_step.values()),
        "cached mode: cached_rows, refresh_planes and insert_claim launched":
            min(c_launches[k] for k in ("cached_rows", "refresh_planes", "insert_claim")) > 0,
        "cached mode: query_cached not launched (its probe is in cached_rows)":
            c_launches["query_cached"] == 0,
        "merged3 batch: cached_rows not launched": launches["cached_rows"] == 0,
        "gather_rows not launched (both batches)":
            launches["gather_rows"] == 0 and c_launches["gather_rows"] == 0,
        "cached mode: ATE < max(0.10 m, the reference's + 0.01 m) in every lane":
            bool(np.all(c_ate < c_gate)),
    })
    result["kernels"] = check_lane_kernels(dev, feed, fin, aux, cfg, map_cfg, firsts, floor)
    return result


def _lane_queries(dev, feed, aux, firsts, back: int, n: int = 8192, seed: int = 0):
    """``(B, n, 3)`` queries: ``n`` points of scan ``f + S - 1 - back`` of
    each lane's window at the lane's pose of that scan (world frame, not
    deskewed), as its iEKF queries them."""
    import torch

    rng = np.random.default_rng(seed + back)
    k = aux["p"].shape[1] - 1 - back
    out = []
    for b, f in enumerate(firsts):
        keep = np.nonzero(feed["mask"][f + k])[0]
        pick = torch.from_numpy(np.sort(rng.choice(keep, n, replace=False))).to(dev)
        xyz = torch.from_numpy(feed["xyz"][f + k]).to(dev)[pick]
        out.append(xyz @ aux["R"][b, k].T + aux["p"][b, k])
    return torch.stack(out).contiguous()


def _lane_downsampled(dev, feed, aux, firsts, back: int, budget: int = 8192):
    """Each lane's scan ``f + S - 1 - back`` downsampled as the odometry
    does and placed at the lane's pose: ``(xyz (B, budget, 3), mask)``."""
    import torch

    k = aux["p"].shape[1] - 1 - back
    pts, masks = [], []
    for b, f in enumerate(firsts):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = aux["R"][b, k].cpu().numpy(), aux["p"][b, k].cpu().numpy()
        xyz, mask = _downsampled_world(feed, f + k, pose, dev, budget)
        pts.append(xyz)
        masks.append(mask)
    return torch.stack(pts).contiguous(), torch.stack(masks).contiguous()


def check_lane_kernels(dev, feed, fin, aux, cfg, map_cfg, firsts, floor, reps: int = 5) -> dict:
    """The map kernels at the batched rollout's lane shapes, each bit for
    bit against its lane-batched plain version AND, lane by lane, against
    the unbatched kernel on that lane's table alone: ``merged_moments`` on
    the 8 lanes' 2^19-slot maps after the rollout (8 x 8192 queries, merged3
    pools, 2 probes; and a ragged 3 lanes x 5000), ``insert_claim`` of 8 x
    8192 and 32 x 8192 downsampled points (the 8 maps four times over; 2
    rounds, one cooperative launch), ``query_cached`` on the maps with their
    planes fitted and ``gather_rows`` of the moment rows at the insert's
    slots (beside ``torch.gather`` of the same rows, its library call). Each
    timed over ``reps`` fresh input sets as the other kernels are, beside
    the timing floor and its HBM byte bound."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.ops import assoc_cuda, gather_cuda, insert_cuda, query_cuda
    from fastliosam_tpu_torch.ops.gather_cuda import sector_bytes
    from fastliosam_tpu_torch.utils.timing import device_ms

    m = fin.vmap
    c, vs, probes = map_cfg.capacity, map_cfg.voxel_size, map_cfg.query_probes
    rounds = max(map_cfg.insert_probes, map_cfg.claim_probes)
    maxp = map_cfg.max_points_per_voxel
    lanes = m.fp.shape[0]
    fp_np = m.fp.cpu().numpy()
    floor_ms = floor["132_blocks"]
    out = {}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def equal(a, b):
        return torch.equal(bits(a), bits(b))

    def record(name, shape, ms, plain_ms, nbytes, library_ms=None, **extra):
        bound = nbytes / H100_BYTES_PER_S * 1e3
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  {name} at {shape}: equal to its plain version and, lane by lane, to the "
              f"unbatched kernel; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
              f"bound {bound:.5f} ms ({nbytes:.0f} HBM bytes), floor {floor_ms:.4f} ms"
              + "".join(f", {k} {v}" for k, v in extra.items()))
        return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
                "timing_floor_ms": floor_ms, **extra}

    # -- the association: 8 lanes x 8192 queries, 3 pools, 2 probes; ragged 3 x 5000
    sets = []
    for back in range(reps):
        xyz = _lane_queries(dev, feed, aux, firsts, back)
        coords0, pools = vh.merged3_pools(xyz, vs)
        sets.append((pools, coords0, torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)))
    args, tail = (m.fp, m.moments), (vs, probes)
    for pools, coords0, mask in sets:
        got = assoc_cuda.merged_moments_cuda(*args, pools, coords0, mask, *tail)
        want = assoc_cuda.merged_moments_ref(*args, pools, coords0, mask, *tail)
        lane = [assoc_cuda.merged_moments_cuda(m.fp[b], m.moments[b], pools[:, b].contiguous(),
                                               coords0[b], mask[b], *tail) for b in range(lanes)]
        rag = (slice(0, 3), slice(0, 5000))
        r_pools, r_c0, r_mask = (pools[(slice(None),) + rag].contiguous(),
                                 coords0[rag].contiguous(), mask[rag].contiguous())
        r_got = assoc_cuda.merged_moments_cuda(m.fp[:3], m.moments[:3], r_pools, r_c0, r_mask,
                                               *tail)
        r_want = assoc_cuda.merged_moments_ref(m.fp[:3], m.moments[:3], r_pools, r_c0, r_mask,
                                               *tail)
        torch.cuda.synchronize()
        if not (equal(got, want) and all(equal(got[b], lane[b]) for b in range(lanes))
                and equal(r_got, r_want) and equal(r_got, got[:3, :5000])):
            raise AssertionError("merged_moments at lanes: kernel, plain version and the "
                                 "unbatched kernel per lane differ")
    ms = device_ms(lambda p, c0, k: assoc_cuda.merged_moments_cuda(*args, p, c0, k, *tail), sets)
    plain_ms = device_ms(lambda p, c0, k: assoc_cuda.merged_moments_ref(*args, p, c0, k, *tail),
                         sets)
    nbytes = [assoc_cuda.hbm_bytes(fp_np, pools, coords0, probes) for pools, coords0, _ in sets]
    out["merged_moments"] = record(
        "merged_moments", f"{lanes} lanes x 8192 queries x 3 pools x {probes} probes "
        "(and a ragged 3 lanes x 5000)", ms, plain_ms, float(np.mean(nbytes)))

    # -- the insert: 8 and 32 lanes x 8192 points, one cooperative launch each
    pts = [_lane_downsampled(dev, feed, aux, firsts, back) for back in range(reps)]
    for n_lanes in BATCH_KERNEL_LANES:
        tile = n_lanes // lanes
        fp, coords, moments = (torch.cat([t] * tile) for t in (m.fp, m.coords, m.moments))
        # lanes past the 8th take later scans of their lane's window
        lane_sets = []
        for back in range(reps):
            xyz = torch.cat([pts[(back + k) % reps][0] for k in range(tile)]).contiguous()
            mask = torch.cat([pts[(back + k) % reps][1] for k in range(tile)]).contiguous()
            lane_sets.append((xyz, mask))
        blocks, per_thread = insert_cuda.insert_claim_grid(n_lanes * 8192, dev)
        for xyz, mask in lane_sets:
            got = insert_cuda.insert_claim_cuda(fp, coords, moments, xyz, mask, vs, rounds, maxp)
            want = insert_cuda.insert_claim_ref(fp, coords, moments, xyz, mask, vs, rounds, maxp)
            assigned = want[2] < c
            ok = (equal(got[0], want[0]) and equal(got[1], want[1]) and equal(got[2], want[2])
                  and equal(got[4], want[4])
                  and equal(got[3][assigned], want[3][assigned]))
            for b in range(n_lanes):
                one = insert_cuda.insert_claim_cuda(fp[b], coords[b], moments[b], xyz[b],
                                                    mask[b], vs, rounds, maxp)
                ok = ok and (equal(got[0][b], one[0]) and equal(got[1][b], one[1])
                             and equal(got[2][b], one[2]) and equal(got[4][b], one[4])
                             and equal(got[3][b][assigned[b]], one[3][assigned[b]]))
            torch.cuda.synchronize()
            if not ok:
                raise AssertionError(f"insert_claim at {n_lanes} lanes: kernel, plain version "
                                     "and the unbatched kernel per lane differ")
        copies = iter([(fp.clone(), coords.clone()) for _ in range(reps + 3)])
        ms = device_ms(lambda x, k: insert_cuda.insert_claim_into(*next(copies), moments, x, k,
                                                                  vs, rounds, maxp), lane_sets)
        plain_ms = device_ms(lambda x, k: insert_cuda.insert_claim_ref(
            fp, coords, moments, x, k, vs, rounds, maxp), lane_sets)
        nbytes = []
        for xyz, mask in lane_sets:
            sl = insert_cuda.insert_claim_cuda(fp, coords, moments, xyz, mask, vs, rounds,
                                               maxp)[2]
            nbytes.append(sum(insert_cuda.hbm_bytes(fp_np[b % lanes], xyz[b], mask[b], sl[b],
                                                    vs, rounds) for b in range(n_lanes)))
        key = "insert_claim" if n_lanes == lanes else f"insert_claim_{n_lanes}_lanes"
        out[key] = record("insert_claim", f"{n_lanes} lanes x 8192 points, {rounds} rounds",
                          ms, plain_ms, float(np.mean(nbytes)),
                          grid=f"{blocks} x 256 threads, {per_thread} point(s) a thread")
    out["insert_claim"]["at_32_lanes"] = out.pop(f"insert_claim_{BATCH_KERNEL_LANES[1]}_lanes")

    # -- the cached mode's two: the query on the maps with planes fitted, the
    # plane refresh's gather of the moment rows at the insert's slots
    lane_maps = [_cached_map(vh.VoxelMap(*(t[b] for t in m)), map_cfg) for b in range(lanes)]
    cm = vh.VoxelMap(*(torch.stack(f) for f in zip(*lane_maps)))
    q_sets = [(_lane_queries(dev, feed, aux, firsts, back),) for back in range(reps)]
    qargs = (cm.fp, cm.normal, cm.d, cm.plane_valid)
    ones = torch.ones((lanes, 8192), dtype=torch.bool, device=dev)
    for (xyz,) in q_sets:
        got = query_cuda.query_cached_cuda(*qargs, xyz, ones, vs, probes)
        want = query_cuda.query_cached_ref(*qargs, xyz, ones, vs, probes)
        ok = all(equal(a, b) for a, b in zip(got, want))
        for b in range(lanes):
            one = query_cuda.query_cached_cuda(cm.fp[b], cm.normal[b], cm.d[b],
                                               cm.plane_valid[b], xyz[b], ones[b], vs, probes)
            ok = ok and all(equal(a[b], o) for a, o in zip(got, one))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError("query_cached at lanes: kernel, plain version and the "
                                 "unbatched kernel per lane differ")
    ms = device_ms(lambda x: query_cuda.query_cached_cuda(*qargs, x, ones, vs, probes), q_sets)
    plain_ms = device_ms(lambda x: query_cuda.query_cached_ref(*qargs, x, ones, vs, probes),
                         q_sets)
    nbytes = float(np.mean([sum(query_cuda.hbm_bytes(cm.fp[b], xyz[b], ones[b], vs, probes)
                                for b in range(lanes)) for (xyz,) in q_sets]))
    out["query_cached"] = record("query_cached", f"{lanes} lanes x 8192 queries, {probes} probes",
                                 ms, plain_ms, nbytes)
    out["cached_rows"] = check_cached_rows_lanes(dev, feed, aux, firsts, cm, map_cfg, record,
                                                 reps)
    g_sets = [(insert_cuda.insert_claim_cuda(m.fp, m.coords, m.moments, x, k, vs, rounds,
                                             maxp)[2],) for x, k in pts]
    for (sl,) in g_sets:
        got = gather_cuda.gather_rows_cuda(m.moments, sl, lane_major=True)
        want = gather_cuda.gather_rows_ref(m.moments, sl, lane_major=True)
        ok = equal(got, want) and all(
            equal(got[b], gather_cuda.gather_rows_cuda(m.moments[b], sl[b])) for b in range(lanes))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError("gather_rows at lanes: kernel, plain version and the unbatched "
                                 "kernel per lane differ")
    ms = device_ms(lambda s: gather_cuda.gather_rows_cuda(m.moments, s, lane_major=True), g_sets)
    plain_ms = device_ms(lambda s: gather_cuda.gather_rows_ref(m.moments, s, lane_major=True),
                         g_sets)
    # the library's one call for the same rows: torch.gather along each lane's
    # slot dim, reading the slots clamped to C - 1 beforehand (the drop slot C
    # reads row C - 1, as the kernel's index rule does)
    wide = [(s.clamp(max=c - 1)[..., None].expand(-1, -1, m.moments.shape[-1]),)
            for (s,) in g_sets]
    for (s,), (i,) in zip(g_sets, wide):
        if not equal(torch.gather(m.moments, 1, i),
                     gather_cuda.gather_rows_cuda(m.moments, s, lane_major=True)):
            raise AssertionError("gather_rows at lanes: torch.gather reads other rows")
    library_ms = device_ms(lambda i: torch.gather(m.moments, 1, i), wide)
    nbytes = float(np.mean([
        sector_bytes((np.clip(s.cpu().numpy(), 0, c - 1) + (np.arange(lanes) * c)[:, None]), 10)
        + s.numel() * (8 + 40) for (s,) in g_sets]))
    out["gather_rows"] = record("gather_rows", f"({lanes}, 2^{c.bit_length() - 1}, 10) moment "
                                f"rows x ({lanes}, 8192) int64 slots, lane-major", ms, plain_ms,
                                nbytes, library_ms=library_ms)
    # the cached batch's plane refresh: each insert's moments after its
    # scatter at its slots, the maps' fitted planes before it
    rp_sets = []
    for (sl,), (xyz, mask) in zip(g_sets, pts):
        m2, _ = vh.insert(cm, map_cfg, xyz, mask, refresh_planes=False)
        rp_sets.append((m2.moments, m2.coords, sl, cm.normal, cm.d, cm.plane_valid))
    out["refresh_planes"] = check_refresh_planes(
        dev, f"({lanes}, 2^{c.bit_length() - 1}, 10) x ({lanes}, 8192) int64 slots, "
        "lane-major (the cached batch)", rp_sets, map_cfg, floor["1_blocks"])
    return out


def check_cached_rows_lanes(dev, feed, aux, firsts, cm, map_cfg, record, reps: int) -> dict:
    """``cached_rows`` at the cached batch's lane shape: each lane's scan
    downsampled to 8192 body points at the lane's pose, against the lanes'
    2^19-slot maps with their planes fitted (``cm``), one launch with a
    per-lane device flag (even lanes probe, odd lanes carry the association
    of a probe 10 cm away): bit for bit against the lane-batched plain
    version and, lane by lane, against the unbatched kernel. Timed over
    ``reps`` fresh input sets beside the plain version and its bound."""
    import torch

    from fastliosam_tpu_torch.core.voxel import hash_slot, voxel_coords
    from fastliosam_tpu_torch.odom import OdomConfig
    from fastliosam_tpu_torch.ops import cached_rows_cuda as crc
    from fastliosam_tpu_torch.utils.timing import device_ms

    oc = OdomConfig()
    tail = (map_cfg.voxel_size, map_cfg.query_probes, oc.point_cov, oc.max_residual,
            oc.degen_conf_ratio)
    lanes = cm.fp.shape[0]
    table = (cm.fp, cm.normal, cm.d, cm.plane_valid)
    flag = (torch.arange(lanes, device=dev) % 2) == 0

    def words(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    sets = []
    for back in range(reps):
        k = aux["p"].shape[1] - 1 - back
        body = [_downsampled_body(feed, f + k, dev) for f in firsts]
        pts = torch.stack([b[0] for b in body]).contiguous()
        mask = torch.stack([b[1] for b in body]).contiguous()
        R, p = aux["R"][:, k].contiguous(), aux["p"][:, k].contiguous()
        away = crc.cached_rows_cuda(R, p + 0.1, pts, mask, table, None, True, *tail)
        args = (R, p, pts, mask, table, away.slots, flag)
        got = crc.cached_rows_cuda(*args, *tail)
        want = crc.cached_rows_ref(*args, *tail)
        ok = all(g.shape == w.shape and torch.equal(words(g), words(w))
                 for g, w in zip(got, want))
        for b in range(lanes):
            one = crc.cached_rows_cuda(R[b], p[b], pts[b], mask[b], tuple(t[b] for t in table),
                                       away.slots[b], bool(flag[b]), *tail)
            ok = ok and all(torch.equal(words(g[b]), words(o)) for g, o in zip(got, one))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError("cached_rows at lanes: kernel, plain version and the unbatched "
                                 "kernel per lane differ")
        sets.append(args)
    ms = device_ms(lambda *a: crc.cached_rows_cuda(*a, *tail), sets)
    plain_ms = device_ms(lambda *a: crc.cached_rows_ref(*a, *tail), sets)
    nbytes = []
    for a in sets:
        rows = crc.cached_rows_ref(*a, *tail)
        h0 = hash_slot(voxel_coords(a[2] @ a[0].mT + a[1][:, None], map_cfg.voxel_size),
                       map_cfg.capacity).cpu().numpy()
        nbytes.append(crc.hbm_bytes(rows, table, a[3], flag, h0, map_cfg.query_probes))
    return record("cached_rows", f"{lanes} lanes x 8192 body points, {map_cfg.query_probes} "
                  "probes, even lanes probing", ms, plain_ms, float(np.mean(nbytes)),
                  n_matched_mean=float(np.mean([float(crc.cached_rows_ref(*a, *tail)
                                                      .n_matched.float().mean())
                                                for a in sets])))


# ---------------------------------------------------------------------------
# mesh phase: SlamEngine(mesh=...) over torch.distributed, 4 ranks on one card
# ---------------------------------------------------------------------------
MESH_RANKS = 4
MESH_NCCL_SCANS = 20  # the NCCL run at world size 1
MESH_TRAJ_GATE_M = 0.05  # tests/test_engine.py:318-320


def mesh_engine(dev, chunk: int, mesh=None):
    """The per-scan cell's engine (:func:`make_bench_engine`) with the mesh's
    loop semantics: untrimmed loop ICP of a fixed length (``trim_fraction``
    1.0, ``convergence_eps`` 0), as ``tests/test_engine.py:276-281`` pins;
    with ``mesh``, in mesh mode on the rank's device."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import make_bench_engine

    engine = make_bench_engine(None if mesh is not None else dev, chunk=chunk, mesh=mesh)
    engine.loop_cfg = engine.loop_cfg._replace(trim_fraction=1.0, convergence_eps=0.0)
    return engine


def _feed_head(feed, n_scans: int) -> dict:
    """The feed's first ``n_scans`` scans (per-scan arrays cut, the rest kept)."""
    n = len(feed["stamps"])
    return {k: (v[:n_scans] if getattr(v, "ndim", 0) and len(v) == n else v)
            for k, v in feed.items()}


def mesh_rank(rank: int, world: int, coord: str, backend: str, device: str, feed_path: str,
              n_scans: int, chunk: int, out_path: str, go, threads: int = 2) -> None:
    """One rank of the mesh phase (a spawned process): join the group,
    wait for ``go``, run ``SlamEngine(mesh=make_mesh(world))`` with
    ``process_chunk`` over the feed's first ``n_scans`` scans twice from
    ``reset()``, and write its trajectories and counts to ``out_path``. It
    loads the kernels the parent built and never builds one."""
    import torch

    torch.set_num_threads(threads)
    from fastliosam_tpu_torch.ops import build

    missing = [n for n in build.sources() if not build.library_path(n).exists()]
    if missing and torch.device(device).type == "cuda":
        raise RuntimeError(f"rank {rank}: kernels not built by the parent: {missing}")
    from fastliosam_tpu_torch.ops import nn_cuda
    from fastliosam_tpu_torch.parallel import init_distributed, make_mesh
    from fastliosam_tpu_torch.utils import geometry_precision, host_reads

    init_distributed(coord, world, rank, backend=backend, device=device)
    mesh = make_mesh(world)
    dev = mesh.device
    if dev.type == "cpu":  # a rehearsal on the CPU: nothing to wait for
        torch.cuda.synchronize = lambda *a, **k: None
    feed = _feed_head(load_feed(feed_path), n_scans)
    engine = mesh_engine(dev, chunk, mesh)
    go.wait()
    out = {}
    with geometry_precision():
        for run in ("first", "replay"):
            mesh.reset_counts()
            r0 = host_reads()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            res, launches = _launch_counts(
                lambda: run_chunks(engine, feed, dev, chunk, deferred=False))
            out[f"{run}.traj"] = np.stack(engine.realtime_traj)
            out[f"{run}.loops"] = np.asarray(engine.loop_pairs, np.int64).reshape(-1, 2)
            out[f"{run}.stats"] = json.dumps({
                "scans": res["scans"], "chunks": res["chunks"], "total_s": res["total_s"],
                "keyframes": engine.kf.n, "solves": engine.solve_count,
                "verifications": len(engine.loop_attempts),
                "launches": launches, "nn_launches": launches[nn_cuda.KERNEL["name"]],
                "collectives": mesh.collectives, "collective_s": mesh.collective_s,
                "host_reads": host_reads() - r0,
                "solve_s": res["solve_s"], "verify_s": res["verify_s"],
                "peak_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                               else 0),
                "backend": backend, "world": world, "rank": rank,
            })
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


def _start_ranks(ctx, world: int, backend: str, device: str, feed_path: str, n_scans: int,
                 chunk: int, out_dir: Path, go):
    from fastliosam_tpu_torch.parallel.distributed import free_port

    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(world):
        p = ctx.Process(target=mesh_rank, name=f"{backend}-rank{r}", args=(
            r, world, coord, backend, device, feed_path, n_scans, chunk,
            str(out_dir / f"{backend}{world}_rank{r}.npz"), go))
        p.start()
        procs.append(p)
    return procs


def _join_ranks(procs, timeout_s: float) -> list:
    """Wait for the rank processes; any non-zero exit (a failed rank, a
    collective timeout) or a rank still alive after ``timeout_s`` fails."""
    deadline = time.perf_counter() + timeout_s
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    alive = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = [f"{p.name} (exit {p.exitcode})" for p in procs if p.exitcode != 0]
    if alive or failed:
        raise AssertionError(f"mesh phase: ranks failed: {failed}; still running: {alive}")
    return procs


def _load_rank(path: Path) -> dict:
    with np.load(path) as f:
        out = dict(f)
    for run in ("first", "replay"):
        out[f"{run}.stats"] = json.loads(str(out[f"{run}.stats"]))
    return out


def mesh_phase(dev, feed_path: str, chunk: int = 5, n_scans: int | None = None,
               rank_device: str = "cuda:0") -> dict:
    """Mesh mode over ``torch.distributed`` (``parallel``): 4 gloo ranks on
    one card, each ``SlamEngine(mesh=make_mesh(4))`` with ``process_chunk``
    over the figure-8 feed at the per-scan cell's width, twice from
    ``reset()``; the reference is the replicated engine with the same loop
    semantics, on the same card, run while the ranks start; then one NCCL
    rank (world size 1) over the first 20 scans."""
    import torch

    t_phase = time.perf_counter()
    feed = load_feed(feed_path)
    n_scans = n_scans or len(feed["stamps"])
    feed = _feed_head(feed, n_scans)
    out_dir = ROOT / "build" / "mesh_phase"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*.npz"):
        f.unlink()
    ctx = multiprocessing.get_context("spawn")
    go, go1 = ctx.Event(), ctx.Event()
    ranks = _start_ranks(ctx, MESH_RANKS, "gloo", rank_device, feed_path, n_scans, chunk,
                         out_dir, go)
    # the NCCL rank starts now too and waits for the gloo ranks to finish
    nccl = _start_ranks(ctx, 1, "nccl", rank_device, feed_path, min(MESH_NCCL_SCANS, n_scans),
                        chunk, out_dir, go1)
    try:
        engine = mesh_engine(dev, chunk)
        ref_run, ref_launches = _launch_counts(
            lambda: run_chunks(engine, feed, dev, chunk, deferred=False))
        ref = np.stack(engine.realtime_traj)
        ref_loops = list(engine.loop_pairs)
        ref_info = {"keyframes": engine.kf.n, "loops": len(ref_loops),
                    "solves": engine.solve_count, "scans_per_s": ref_run["scans"] /
                    ref_run["total_s"], "ate_m": _ate(engine, feed), "loop_pairs": ref_loops}
        del engine
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        go.set()
        _join_ranks(ranks, 600.0)
        mesh_wall_s = time.perf_counter() - t0
        go1.set()
        _join_ranks(nccl, 300.0)
    finally:
        go.set()
        go1.set()
        for p in ranks + nccl:
            if p.is_alive():
                p.kill()
    outs = [_load_rank(out_dir / f"gloo{MESH_RANKS}_rank{r}.npz") for r in range(MESH_RANKS)]
    o1 = _load_rank(out_dir / "nccl1_rank0.npz")

    o0 = outs[0]
    s0, r0 = o0["first.stats"], o0["replay.stats"]
    traj = o0["first.traj"]
    dev_err = float(np.abs(traj[:, :3, 3] - ref[:, :3, 3]).max())
    rt = traj[:, :3, 3]
    ate = float(np.sqrt(np.mean(np.sum((rt - feed["gt_p"][: len(rt)]) ** 2, axis=1))))
    n1 = len(o1["first.traj"])
    nccl_err = float(np.abs(o1["first.traj"][:, :3, 3] - ref[:n1, :3, 3]).max())
    chunks = s0["chunks"]
    result = {
        "ranks": MESH_RANKS, "backend": "gloo", "rank_device": rank_device,
        "scans": s0["scans"], "chunk": chunk,
        "scans_per_s": s0["scans"] / s0["total_s"],
        "scans_per_s_replay": r0["scans"] / r0["total_s"],
        "keyframes": s0["keyframes"], "loops": len(o0["first.loops"]),
        "loop_pairs": [tuple(p) for p in o0["first.loops"].tolist()],
        "solves": s0["solves"], "verifications": s0["verifications"],
        "ate_m": ate, "max_dev_from_reference_m": dev_err,
        "host_reads_per_chunk": s0["host_reads"] / chunks,
        "collectives_per_chunk": s0["collectives"] / chunks,
        "collective_ms_per_chunk": 1e3 * s0["collective_s"] / chunks,
        "collective_ms_per_chunk_replay": 1e3 * r0["collective_s"] / chunks,
        "nn_launches_per_rank": [o["first.stats"]["nn_launches"] for o in outs],
        "peak_gib_per_rank": [o["first.stats"]["peak_bytes"] / 2**30 for o in outs],
        "launches_per_rank": [o["first.stats"]["launches"] for o in outs],
        "verify_s": s0["verify_s"], "solve_s": s0["solve_s"],
        "mesh_wall_s": mesh_wall_s,
        "reference": ref_info, "reference_launches": ref_launches,
        "nccl": {"scans": n1, "max_dev_from_reference_m": nccl_err,
                 "scans_per_s": o1["first.stats"]["scans"] / o1["first.stats"]["total_s"],
                 "collectives_per_chunk": o1["first.stats"]["collectives"] /
                 o1["first.stats"]["chunks"],
                 "launches": o1["first.stats"]["launches"]},
    }
    result["phase_s"] = time.perf_counter() - t_phase
    print("  " + json.dumps(result))
    print(f"  mesh: {result['scans_per_s']:.2f} scans/s ({result['scans_per_s_replay']:.2f} on "
          f"the replay; 4 ranks share one card and gloo stages every collective through host "
          f"memory: a correctness run, not a scaling one), "
          f"{result['collectives_per_chunk']:.1f} collectives a chunk, "
          f"{result['collective_ms_per_chunk']:.1f} ms of them, phase {result['phase_s']:.1f} s")
    same = all(np.array_equal(o[f"{run}.traj"], traj) and
               np.array_equal(o[f"{run}.loops"], o0["first.loops"])
               for o in outs for run in ("first", "replay"))
    _fail("mesh phase", {
        "every pose finite": bool(np.all(np.isfinite(traj))),
        "keyframes as the reference": s0["keyframes"] == ref_info["keyframes"],
        "loop pairs as the reference": result["loop_pairs"] == [tuple(p) for p in ref_loops],
        "solves as the reference": s0["solves"] == ref_info["solves"],
        "at least one loop": result["loops"] >= 1,
        f"trajectory within {MESH_TRAJ_GATE_M} m of the reference at every scan":
            dev_err < MESH_TRAJ_GATE_M,
        "ATE < 0.10 m": ate < 0.10,
        "every rank equal to rank 0 and each replay equal, bit for bit": same,
        "nearest_neighbors launched on every rank":
            min(result["nn_launches_per_rank"]) > 0,
        "gather_rows launched on no rank":
            all(r["gather_rows"] == 0 for r in result["launches_per_rank"]),
        f"NCCL world size 1 within {MESH_TRAJ_GATE_M} m of the reference":
            nccl_err < MESH_TRAJ_GATE_M and bool(np.all(np.isfinite(o1["first.traj"]))),
    })
    return result


# ---------------------------------------------------------------------------
# postprocess phase (phase 12): the toolbox on the KITTI phase's export
# ---------------------------------------------------------------------------
# float64 instructions a second outside the tensor cores: the SXM data
# sheet's 33.5 TFLOP/s counts a fused multiply-add as two operations, and
# the kernels issue every DSUB / DMUL / DADD on its own (no FMA)
H100_F64_INSTR = 16.75e12
PP_SUBSET = 65536  # the kernel checks' points of the exported map
PP_ICP_POINTS = 8192  # the k = 1 check's 2D points, each side
PP_YARDSTICK_ROWS = 4096  # the whole map's cdist + topk: timed on these query rows only
PP_SOR = (20, 2.0)  # neighbours, std ratio
PP_CLUSTER = (0.5, 10)  # eps, min points
PP_TRUE_SIM = (np.radians(30.0), 1.05, 100.0, 0.0)  # theta, scale, tx, ty
PP_GATES = {"ground_deg": 2.0, "georef_m": 2.0, "icp_deg": 0.5, "icp_m": 0.5,
            "icp_scale": 1e-2, "route": 0.02}


def event_ms(fn, reps: int = 1, warm=None) -> float:
    """Mean device time of ``reps`` calls of a slow ``fn`` (tens of ms and
    more, where the host's enqueue time does not matter) between two CUDA
    events, after one call of ``warm`` (default ``fn``) that warms it up."""
    import torch

    (warm or fn)()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_call(fn):
    """``(fn(), its device time in ms between two CUDA events)``: one call,
    for a function too slow to call twice."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _bound(ops: float, nbytes: float, rate: float = H100_F64_INSTR) -> dict:
    t_ops, t_bytes = ops / rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_knn_shape(src, dst, k: int, exclude_self: bool, reps: int,
                    library: bool = True, library_rows: int | None = None) -> dict:
    """``knn`` against its plain version bit for bit (d2 and indices), timed
    beside the plain version, ``cdist`` (no matrix-product expansion) with
    ``topk`` a chunk of rows at a time, and its bound. The bound counts the
    pairs the kernel tests (the grid route's count from its counters, the
    rescue pass's M a rescued query; all N x M for brute force), 8 FP64
    instructions each against the FP64 instruction rate, or the points read
    and the neighbours written, whichever is larger; the all-pairs bound
    stands beside it. With ``library`` false (the whole map, where the plain
    version takes tens of seconds) the plain time is that of the
    comparison's own call, ``library_ms`` is null, and with
    ``library_rows`` the yardstick runs on that many query rows against
    every destination, its time under ``library_ms_rows``."""
    import torch

    from fastliosam_tpu_torch.ops import kneighbors_cuda

    n, m = src.shape[0], dst.shape[0]
    grid = m >= kneighbors_cuda.GRID_MIN_DST
    search = {}
    if grid:
        from fastliosam_tpu_torch.scripts.exp_knn import grid_stats

        k_d2, k_idx, stats, index = kneighbors_cuda._knn_grid(src, dst, k, exclude_self)
        search = grid_stats(n, m, stats, index)
        pairs = round(search.pop("pairs_per_query") * n)
        search["cell_edge_m"] = search.pop("h") * 2 ** search["level"]
    else:
        k_d2, k_idx = kneighbors_cuda.knn_cuda(src, dst, k, exclude_self)
        pairs = n * (m - int(exclude_self))
    (r_d2, r_idx), compare_ms = event_call(
        lambda: kneighbors_cuda.knn_ref(src, dst, k, exclude_self))
    if not (torch.equal(k_d2.view(torch.int64), r_d2.view(torch.int64))
            and torch.equal(k_idx, r_idx)):
        raise AssertionError(f"knn {n}x{m} k={k}: kernel and plain version differ "
                             f"({int((k_idx != r_idx).sum())} indices)")

    from fastliosam_tpu_torch.scripts.exp_knn import library_block_rows, library_knn

    def yardstick(rows_of=n):  # unused by the port
        library_knn(src[:rows_of], dst, k, exclude_self)

    # one block of rows warms the yardstick: every block is the same call
    block_rows = library_block_rows(m)
    library_ms = (event_ms(yardstick, warm=lambda: yardstick(min(n, block_rows)))
                  if library else None)
    nbytes = (n + (0 if exclude_self else m)) * 24 + n * k * 16
    rec = {"shape": [n, m, k], "exclude_self": exclude_self, "max_abs_err": 0.0,
           "dispatch": "grid" if grid else "brute",
           "ms": cuda_ms(lambda: kneighbors_cuda.knn_cuda(src, dst, k, exclude_self), reps),
           "plain_ms": (event_ms(lambda: kneighbors_cuda.knn_ref(src, dst, k, exclude_self))
                        if library else compare_ms),
           "library_ms": library_ms, "pairs_tested": pairs, "pairs_per_query": pairs / n,
           **search, **_bound(8.0 * pairs, nbytes),
           "all_pairs_bound_ms": _bound(8.0 * n * (m - int(exclude_self)), nbytes)["bound_ms"]}
    lib = "not timed" if library_ms is None else f"{library_ms:.4f} ms"
    if library_rows and not library:
        rec["library_rows"] = library_rows
        rec["library_ms_rows"] = event_ms(lambda: yardstick(library_rows),
                                          warm=lambda: yardstick(min(library_rows, block_rows)))
        lib = f"{rec['library_ms_rows']:.4f} ms on {library_rows} of the {n} query rows"
    print(f"  knn {n}x{m} k={k}{' (self excluded)' if exclude_self else ''}, {rec['dispatch']}: "
          f"bit for bit; kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, cdist+topk "
          f"{lib}, {rec['pairs_per_query']:.1f} pairs a query"
          + (f" ({search['rescued']} rescued, {search['probes_per_query']:.1f} probes, level "
             f"{search['level']}, cells {search['cell_edge_m']:.4f} m)" if grid else "")
          + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; all pairs "
          f"{rec['all_pairs_bound_ms']:.4f} ms)")
    return rec


def check_knn_hazards(dev) -> dict:
    """``scripts/exp_knn.py``'s hazard sets through both routes and the
    dispatch, each bit for bit with the plain version."""
    from fastliosam_tpu_torch.scripts import exp_knn

    recs = exp_knn.run_hazards(dev, print_fn=lambda line: None)
    bad = [r["hazard"] for r in recs
           if not (r["brute_equal"] and r["grid_equal"] and r["dispatch_equal"])]
    if bad:
        raise AssertionError(f"knn hazard sets: kernel and plain version differ on {bad}")
    print(f"  knn hazard sets ({', '.join(r['hazard'] for r in recs)}): both routes bit for "
          f"bit; rescued {sum(r['rescued'] for r in recs)} queries in all")
    return {"sets": len(recs), "rescued": {r["hazard"]: r["rescued"] for r in recs}}


def check_voxel_edges(pts, eps: float, reps: int = 10) -> dict:
    """``voxel_edges`` against its plain version (edges equal), timed beside
    it; no one PyTorch call computes it. Its bound counts the pair tests the
    data needs (every pair where there is no edge, one where there is) and
    the points, keys and offsets read and the edges written."""
    import torch

    from fastliosam_tpu_torch.ops import cluster_cuda
    from fastliosam_tpu_torch.postprocess.cleanup import voxelize

    vox = voxelize(pts, eps)
    sorted_pts, keys, offsets = args = (vox.sorted_pts, vox.keys, vox.offsets)
    got = cluster_cuda.voxel_edges_cuda(*args, eps)
    want = cluster_cuda.voxel_edges_ref(*args, eps)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"voxel_edges: {int((got != want).sum())} edges differ")
    counts = offsets[1:] - offsets[:-1]
    code = cluster_cuda.key_coder(keys)
    codes, pairs = code(keys), 0
    for o, off in enumerate(cluster_cuda.OFFSETS):
        want_code = code(keys + torch.tensor(off, device=keys.device))
        nb = torch.searchsorted(codes, want_code).clamp(max=len(keys) - 1)
        exists = codes[nb] == want_code
        full = counts * counts[nb]
        pairs += int(torch.where(got[:, o] >= 0, 1, torch.where(exists, full, 0)).sum())
    v = len(keys)
    rec = {"shape": [len(sorted_pts), v], "eps": eps, "max_abs_err": 0.0,
           "edges": int((got >= 0).sum()),
           "ms": cuda_ms(lambda: cluster_cuda.voxel_edges_cuda(*args, eps), reps),
           "plain_ms": event_ms(lambda: cluster_cuda.voxel_edges_ref(*args, eps)),
           "library_ms": None, "pair_tests_needed": pairs,
           **_bound(8.0 * pairs, len(sorted_pts) * 24 + v * 24 + (v + 1) * 8 + v * 13 * 8)}
    print(f"  voxel_edges {len(sorted_pts)} points, {v} voxels, eps {eps}: edges equal "
          f"({rec['edges']} of them); kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def _detector_head(path: Path, anchors: int = 8400, classes: int = 2) -> None:
    """A stub YOLOv8-style TorchScript head: a fixed seeded (1, 4 + nc,
    anchors) output whose scores move with the input's mean (distinct
    scores), saved to ``path``."""
    import torch

    rng = np.random.default_rng(12)
    base = np.zeros((1, 4 + classes, anchors), np.float32)
    base[0, :2] = rng.uniform(20, 620, (2, anchors))
    base[0, 2:4] = rng.uniform(8, 160, (2, anchors))
    base[0, 4:] = rng.uniform(0, 0.6, (classes, anchors))

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("base", torch.from_numpy(base))

        def forward(self, x):
            out = self.base.clone()
            out[:, 4:] = out[:, 4:] + x.mean()
            return out

    path.parent.mkdir(parents=True, exist_ok=True)
    torch.jit.script(Head()).save(str(path))


def postprocess_phase(dev, map_pcd: Path, corridor, gps_kf, fig8, fig8_traj) -> dict:
    """The post-processing toolbox (``fastliosam_tpu_torch.postprocess``)
    on the KITTI phase's exported map and on the GPS and per-scan phases'
    trajectories. Kernel checks first (not counted), on subsets and at the
    main path's own inputs, then the main path with every count at 0: ``denoise_slam_map`` on the whole map twice
    (masks bit for bit), ``ransac_ground_plane``, ``georeference_trajectory``,
    ``icp_2d_with_scale``, ``match_trajectory`` and the detector."""
    import torch

    from fastliosam_tpu_torch.eval.feeds import _fixes_from_data
    from fastliosam_tpu_torch.io.pcd import read_pcd, xyz_of
    from fastliosam_tpu_torch.postprocess import (Similarity2D, denoise_slam_map,
                                                  euclidean_clusters, georeference_trajectory,
                                                  icp_2d_with_scale, ransac_ground_plane,
                                                  sor_denoise)
    from fastliosam_tpu_torch.postprocess.align import _apply_t, _pad_z
    from fastliosam_tpu_torch.postprocess.detect import YoloDetector, decode_yolo, nms, to_chw
    from fastliosam_tpu_torch.postprocess.mapmatch import match_trajectory, route_length

    t_phase = time.perf_counter()
    card = card_line()
    xyz = xyz_of(read_pcd(str(map_pcd)))
    rng = np.random.default_rng(10)
    sub = torch.from_numpy(xyz[rng.choice(len(xyz), PP_SUBSET, replace=False)]).to(dev)
    pair = rng.choice(len(xyz), 2 * PP_ICP_POINTS, replace=False)
    flat = torch.nn.functional.pad(torch.from_numpy(xyz[pair, :2]).to(dev), (0, 1)).contiguous()
    print(f"  kernels ({card}):")
    kernels = {"knn": check_knn_shape(sub, sub, PP_SOR[0], True, reps=3),
               "voxel_edges": check_voxel_edges(sub, PP_CLUSTER[0])}
    kernels["knn"]["at_k50"] = check_knn_shape(sub, sub, 50, True, reps=3)
    kernels["knn"]["at_icp_shape"] = check_knn_shape(
        flat[:PP_ICP_POINTS].contiguous(), flat[PP_ICP_POINTS:].contiguous(), 1, False, reps=10)
    kernels["knn"]["hazards"] = check_knn_hazards(dev)
    del sub, flat

    # the inputs of the alignment and matching runs
    kf_t, kf_p = gps_kf
    fixes = _fixes_from_data(corridor)
    gps_lat, gps_lon, gps_alt = (np.array([getattr(f, a) for f in fixes])
                                 for a in ("lat", "lon", "alt"))
    theta, scale, tx, ty = PP_TRUE_SIM
    true = Similarity2D(scale, theta, tx, ty)
    init = Similarity2D(scale, theta + np.radians(5.0), tx + 1.2, ty - 1.6)
    icp_src, icp_dst = fig8_traj[:, :2, 3], true.apply(fig8["gt_p"][: len(fig8_traj), :2])

    # the kernels again at the main path's own inputs: the whole map (the
    # SOR's k-NN), its SOR-kept points (the clustering's voxels) and the
    # ICP's first iteration
    print(f"  kernels at the main path's inputs ({card}):")
    full = torch.from_numpy(xyz).to(dev)
    icp_cur = _apply_t(init, torch.from_numpy(np.asarray(icp_src, np.float64)).to(dev))
    icp_ref = torch.from_numpy(np.asarray(icp_dst, np.float64)).to(dev)
    kernels["knn"]["at_main_path"] = {
        "sor": check_knn_shape(full, full, PP_SOR[0], True, reps=3, library=False,
                               library_rows=PP_YARDSTICK_ROWS),
        "icp": check_knn_shape(_pad_z(icp_cur), _pad_z(icp_ref), 1, False, reps=10)}
    sor_keep = torch.from_numpy(sor_denoise(xyz, *PP_SOR, device=dev)).to(dev)
    kernels["voxel_edges"]["at_main_path"] = check_voxel_edges(full[sor_keep], PP_CLUSTER[0])
    del full, sor_keep
    head = ROOT / "build" / "pp_phase" / "head.pt"
    _detector_head(head)
    image = rng.integers(0, 255, (640, 640, 3)).astype(np.uint8)

    def main_path():
        out, t0 = {}, time.perf_counter()
        masks = []
        for _ in range(2):
            t1 = time.perf_counter()
            masks.append(denoise_slam_map(xyz, sor_neighbors=PP_SOR[0], sor_std=PP_SOR[1],
                                          cluster_eps=PP_CLUSTER[0],
                                          cluster_min_points=PP_CLUSTER[1], device=dev))
            out.setdefault("denoise_s", []).append(time.perf_counter() - t1)
        out["masks"] = masks
        out["labels"] = euclidean_clusters(xyz[masks[0]], *PP_CLUSTER, device=dev)
        t1 = time.perf_counter()
        out["plane"], out["inliers"] = ransac_ground_plane(xyz, device=dev)
        out["ransac_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["georef"] = georeference_trajectory(kf_t, kf_p, corridor["gps_t"], gps_lat,
                                                gps_lon, gps_alt, device=dev)
        out["icp"] = icp_2d_with_scale(icp_src, icp_dst, init=init, device=dev)
        out["align_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        sim = out["georef"][2]
        out["xy"] = sim.apply(kf_p[:, :2])
        out["net"] = corridor_roads(corridor, fixes)
        out["match"] = match_trajectory(out["xy"], out["net"], device=dev)
        out["match_s"] = time.perf_counter() - t1
        det = YoloDetector(str(head), imgsz=640, conf=0.25, device=dev)
        out["raw"] = det.model(to_chw(image))
        out["detect"] = decode_yolo(out["raw"], 0.25, device=dev)
        out["path_s"] = time.perf_counter() - t0
        return out

    out, launches = _launch_counts(main_path)
    from fastliosam_tpu_torch.ops import kneighbors_cuda

    aux_launches = {"knn_cell_hash": kneighbors_cuda.build_launches,
                    "knn_rescue": kneighbors_cuda.rescue_launches}
    keep = out["masks"][0]
    plane = out["plane"]
    ground_deg = float(np.degrees(np.arccos(min(1.0, abs(plane[2])))))
    lat, lon, sim_g, report = out["georef"]
    sim_i, rms = out["icp"]
    edge, snapped, matched = out["match"]
    travelled = _gt_length(corridor, kf_t)
    route = route_length(snapped[matched])
    raw = out["raw"]
    on_card = decode_yolo(raw, 0.25, device=dev)
    on_cpu = decode_yolo(raw.cpu(), 0.25, device="cpu")
    boxes = out["detect"][0]
    nms_card = nms(torch.from_numpy(boxes).to(dev), torch.from_numpy(out["detect"][1]).to(dev))
    nms_cpu = nms(boxes, out["detect"][1], device="cpu")
    result = {
        "card": card, "map_points": len(xyz), "kept": int(keep.sum()),
        "kept_share": float(keep.mean()), "clusters": int(out["labels"].max() + 1),
        "denoise_s": out["denoise_s"], "masks_bit_identical":
            bool(np.array_equal(out["masks"][0], out["masks"][1])),
        "ransac_s": out["ransac_s"], "ground_plane": plane.tolist(),
        "ground_normal_deg": ground_deg, "ground_inliers": int(out["inliers"].sum()),
        "georef_mean_error_m": report["mean_error_m"], "georef_pairs": report["n_pairs"],
        "georef_keyframes": len(kf_t),
        "icp": {"theta_err_deg": abs(float(np.degrees(sim_i.theta - theta))),
                "t_err_m": float(np.hypot(sim_i.tx - tx, sim_i.ty - ty)),
                "scale_err": abs(sim_i.scale - scale), "rms_m": rms,
                "points": len(icp_src)},
        "align_s": out["align_s"],
        "mapmatch": {"points": len(edge), "on_centreline": int((edge == 0).sum()),
                     "route_m": route, "travelled_m": travelled,
                     "route_rel_err": abs(route - travelled) / travelled},
        "match_s": out["match_s"],
        "detections": int(len(out["detect"][1])),
        "head_on_card": raw.device.type == "cuda",
        "launches": launches, "aux_launches": aux_launches, "path_s": out["path_s"],
    }
    result["phase_s"] = time.perf_counter() - t_phase
    print("  " + json.dumps(result))
    print(f"  postprocess ({card}): {len(xyz)}-point map, kept {result['kept_share']:.4f}, "
          f"{result['clusters']} clusters, denoise {', '.join(f'{s:.2f}' for s in out['denoise_s'])}"
          f" s, knn x{launches['knn']}, voxel_edges x{launches['voxel_edges']}; ground "
          f"{ground_deg:.3f} deg off +z; georef mean error {report['mean_error_m']:.3f} m; ICP-2D "
          f"{result['icp']['theta_err_deg']:.4f} deg / {result['icp']['t_err_m']:.4f} m / "
          f"{result['icp']['scale_err']:.2e}; route {route:.2f} m of {travelled:.2f} m; "
          f"phase {result['phase_s']:.1f} s")
    _fail("postprocess phase", {
        "denoise masks bit for bit": result["masks_bit_identical"],
        "kept points all clustered": bool((out["labels"] >= 0).all()),
        "some points kept": result["kept"] > 0,
        f"ground normal within {PP_GATES['ground_deg']} deg of +z":
            ground_deg < PP_GATES["ground_deg"],
        f"georeference mean error < {PP_GATES['georef_m']} m":
            report["mean_error_m"] < PP_GATES["georef_m"],
        "ICP-2D recovers the similarity": result["icp"]["theta_err_deg"] < PP_GATES["icp_deg"]
            and result["icp"]["t_err_m"] < PP_GATES["icp_m"]
            and result["icp"]["scale_err"] < PP_GATES["icp_scale"],
        "every point matched to the centreline": bool(matched.all() and (edge == 0).all()),
        f"route length within {PP_GATES['route']:.0%} of the distance travelled":
            result["mapmatch"]["route_rel_err"] < PP_GATES["route"],
        "detector head ran on the card": result["head_on_card"],
        "decode_yolo on the card = on the CPU": all(
            np.array_equal(a, b) for a, b in zip(on_card, on_cpu)) and len(on_cpu[1]) > 0,
        "nms on the card = on the CPU": np.array_equal(nms_card, nms_cpu),
        "knn and voxel_edges launched": launches["knn"] > 0 and launches["voxel_edges"] > 0,
    })
    return {"result": result, "kernels": kernels}


def corridor_roads(corridor, fixes):
    """The corridor's road network in the ENU frame of its first fix (the
    frame ``georeference_trajectory`` anchors there): the centreline (the
    ground-truth path every 10 scans and its last point, run on 20 m past
    both ends, as a road goes on past a drive), two parallel roads 40 m
    off and one crossing road through its middle."""
    import torch

    from fastliosam_tpu_torch.core.geodesy import LocalCartesian
    from fastliosam_tpu_torch.eval.feeds import GPS_ANCHOR
    from fastliosam_tpu_torch.postprocess.mapmatch import RoadNetwork

    bench = LocalCartesian.from_origin(*GPS_ANCHOR)  # the fixes' anchor
    first = LocalCartesian.from_origin(fixes[0].lat, fixes[0].lon, fixes[0].alt)
    path = np.concatenate([corridor["gt_p"][::10], corridor["gt_p"][-1:]]).astype(np.float32)
    lat, lon, alt = bench.reverse(torch.from_numpy(path))
    centre = first.forward(lat, lon, alt).numpy()[:, :2].astype(np.float64)
    d = (centre[-1] - centre[0]) / np.linalg.norm(centre[-1] - centre[0])
    centre = np.concatenate([centre[:1] - 20 * d, centre, centre[-1:] + 20 * d])
    normal = np.array([-d[1], d[0]])
    mid = centre.mean(0)
    return RoadNetwork([centre, centre + 40 * normal, centre - 40 * normal,
                        np.stack([mid - 100 * normal, mid + 100 * normal])])


def _gt_length(corridor, stamps) -> float:
    """Ground-truth path length between the first and the last of
    ``stamps``: the distance travelled."""
    t = corridor["stamps"]
    i0, i1 = (int(np.argmin(np.abs(t - s))) for s in (stamps[0], stamps[-1]))
    p = corridor["gt_p"][i0:i1 + 1, :2]
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


# ---------------------------------------------------------------------------
# pipeline-scripts phase: profile_pipeline, exp_gps_noinit_probe,
# roofline_odom, the XLA gather experiments and microbench_gather on the
# feeds of eval/feeds.py
# ---------------------------------------------------------------------------
PIPE_SCANS = 150  # the bench's figure-8 feed length (eval/feeds.py: PIPE_SCANS)
PIPE_REPS = 1  # timed runs a profile_pipeline variant, after its warm run
ROOFLINE_REPS = 30
# the JAX package's no-init ATE on the bench's odometry feed, on the CPU: the
# largest over its identity start and 29 starts moved by 1-100 µm (0.0886 m
# from the identity itself; 0.0847-0.1532 m over the 30, median 0.1022: float32
# rounding after the first scans; tests/test_torch_feeds_scripts.py:
# test_noinit_probe_jax_reading, slow); the port's card reading is gated at
# this + 1 cm
NOINIT_JAX_ATE_M = 0.153156
NOINIT_MARGIN_M = 0.01
PIPE_KERNELS = ("nearest_neighbors", "refresh_planes", "merged_moments", "insert_claim")


def pipeline_feeds() -> None:
    """The feeds that phase 14 reads (``eval/feeds.py``: the
    figure-8 feed with its 10 Hz GPS draws, and the odometry feed), made in
    a feed worker at nice 10 and cached under ``build/feeds/``."""
    import os

    from fastliosam_tpu_torch.eval import feeds

    os.nice(10)
    feeds.fig8_sequence(PIPE_SCANS)
    feeds.get_sequence()


def pipeline_phase(dev) -> dict:
    """Phase 14: the pipeline scripts on ``eval/feeds.py``'s feeds, each path's
    kernel launches counted (``launches_by_path`` ``pipeline_*``).
    ``profile_pipeline`` (4 variants, a warm and ``PIPE_REPS`` timed runs
    each), both probes of ``exp_gps_noinit_probe`` (the no-init rollout
    twice), ``roofline_odom`` at 32,768 / 8192 points (``ROOFLINE_REPS``
    steps), ``exp_gather``'s XLA experiments and ``microbench_gather``
    (C = 2^19, N = 8192). Gates: in the module docstring."""
    from fastliosam_tpu_torch.eval import feeds
    from fastliosam_tpu_torch.scripts import (
        exp_gather, exp_gps_noinit_probe, microbench_gather, profile_pipeline, roofline_odom)

    t_phase = time.perf_counter()
    card = card_line()
    launches, parts_s = {}, {}
    fig8, seq = feeds.fig8_sequence(PIPE_SCANS), feeds.get_sequence()

    ctx = profile_pipeline.setup(fig8, 5, dev)
    (prof, runs), launches["pipeline_profile"] = _launch_counts(
        lambda: profile_pipeline.profile(ctx, PIPE_REPS))
    del ctx
    # full_deferred is bench.py: bench_pipeline's deferred run from p0: its
    # ATE is the bench's pipeline_ate_m (phase 16's degraded-GPS yardstick)
    deferred = runs["full_deferred"]["traj"][:, :3, 3]
    pipeline_ate = float(np.sqrt(np.mean(np.sum(
        (deferred - fig8["gt_p"][: len(deferred)]) ** 2, axis=1))))
    v = {name: prof[name] for name, _ in profile_pipeline.VARIANTS}
    for name, rec in v.items():
        print(f"  profile_pipeline {name}: {rec['scans_per_sec']} scans/s, {rec['wall_s']} s, "
              f"keyframes / loops / solves {rec['kf_loops_solves']}, timed = warm "
              f"{rec['replay_equal']}, launches "
              f"{ {k: rec['launches'][k] for k in PIPE_KERNELS} } ({card})")
    print(f"  profile_pipeline attribution (s): {prof['attribution_s']}; full_deferred ATE "
          f"{pipeline_ate:.4f} m ({card})")
    checks = {f"{name}: the timed run equals the warm run": rec["replay_equal"]
              for name, rec in v.items()}
    checks.update({f"{name} launches no gather_rows": rec["launches"]["gather_rows"] == 0
                   for name, rec in v.items()})
    for name in ("full", "full_deferred"):
        _, loops, solves = v[name]["kf_loops_solves"]
        checks[f"{name}: a loop and a solve"] = loops >= 1 and solves >= 1
        for k in PIPE_KERNELS:
            checks[f"{name} launches {k}"] = v[name]["launches"][k] > 0
    checks["no_verify: no loop"] = v["no_verify"]["kf_loops_solves"][1] == 0
    checks["no_kf: at most one keyframe"] = v["no_kf"]["kf_loops_solves"][0] <= 1
    for k in ("merged_moments", "insert_claim"):
        checks[f"no_kf launches {k}"] = v["no_kf"]["launches"][k] > 0
    checks["no_kf launches no nearest_neighbors"] = v["no_kf"]["launches"][
        "nearest_neighbors"] == 0
    _fail("pipeline phase, profile_pipeline", checks)
    parts_s["profile_pipeline"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    (hop, _), launches["pipeline_hop"] = _launch_counts(
        lambda: exp_gps_noinit_probe.probe_per_hop(dev, fig8))
    noinit, launches["pipeline_noinit"] = _launch_counts(
        lambda: [exp_gps_noinit_probe.probe_no_init(dev, seq) for _ in range(2)])
    (rec_ni, first), (_, second) = noinit
    print(f"  exp_gps_noinit_probe hop: {hop} ({card})")
    print(f"  exp_gps_noinit_probe noinit: ate_all {rec_ni['ate_all']} m (JAX on the CPU "
          f"{NOINIT_JAX_ATE_M} m), ate_skip5 {rec_ni['ate_skip5']}, ate_skip10 "
          f"{rec_ni['ate_skip10']}, per-scan error {rec_ni['per_scan_err']} ({card})")
    _fail("pipeline phase, probes", {
        "hops measured, finite": hop["n_hops"] > 0 and bool(np.isfinite(
            [hop[k] for k in hop if k.endswith("_m")]).all()),
        "no-init errors finite": bool(np.isfinite(first["err"]).all()),
        "no-init rollout repeats bit for bit": np.array_equal(first["p"], second["p"]),
        f"no-init ate_all <= {NOINIT_JAX_ATE_M} + {NOINIT_MARGIN_M} m": bool(
            np.sqrt(np.mean(first["err"] ** 2)) <= NOINIT_JAX_ATE_M + NOINIT_MARGIN_M),
    })
    parts_s["exp_gps_noinit_probe"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    roof, launches["pipeline_roofline"] = _launch_counts(
        lambda: roofline_odom.measure(dev, reps=ROOFLINE_REPS, data=seq))
    roof["card"] = card
    print("  roofline_odom " + json.dumps(roof))
    _fail("pipeline phase, roofline", {
        f"{k} finite and positive": bool(np.isfinite(roof[k]) and roof[k] > 0)
        for k in ("flops_per_step", "xla_bytes_accessed", "io_bytes_per_step", "measured_ms")}
        | {"the step's outputs finite": roof["finite"],
           "the kernels' bytes counted": set(roof["kernel_bytes"]) >= {"merged_moments",
                                                                       "insert_claim"}})
    parts_s["roofline_odom"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    xla, launches["pipeline_exp_gather_xla"] = _launch_counts(lambda: exp_gather.run_xla(
        dev, print_fn=lambda line: print(f"  exp_gather {line} ({card})")))
    _fail("pipeline phase, exp_gather", {
        f"{r['name']} equals the CPU's": r["equal_cpu"] is True
        for r in xla if r["name"] != "scatter_add_c16"})
    parts_s["exp_gather_xla"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mb, launches["pipeline_microbench"] = _launch_counts(lambda: microbench_gather.run(dev))
    same = {}
    for name in ("narrow", "bucketed"):
        fn = getattr(microbench_gather, name)
        got, want = fn(dev), fn("cpu")
        same[name] = all(torch_equal_bits(a, b) for a, b in zip(got, want))
    same["narrow_scatter"] = torch_equal_bits(microbench_gather.narrow_scatter(dev),
                                              microbench_gather.narrow_scatter("cpu"))
    mb["equal_cpu"] = same
    print(f"  microbench_gather: narrow {mb['narrow_ms']:.4f} ms, bucketed "
          f"{mb['bucketed_ms']:.4f} ms ({mb['bucketed_speedup']:.2f}x), one (8192, 10) "
          f"scatter-add {mb['narrow_scatter_ms']:.4f} ms; equal to the CPU's {same} ({card})")
    _fail("pipeline phase, microbench_gather", {
        f"{name} equals the CPU's": same[name] for name in ("narrow", "bucketed")})
    parts_s["microbench_gather"] = time.perf_counter() - t0
    print("  pipeline phase parts (s): " + json.dumps({k: round(v, 1) for k, v in parts_s.items()}))
    return {"profile": prof, "pipeline_ate_m": pipeline_ate, "hop": hop, "noinit": rec_ni,
            "roofline": roof, "exp_gather_xla": xla, "microbench": mb, "launches": launches,
            "parts_s": parts_s, "phase_s": time.perf_counter() - t_phase}


def torch_equal_bits(a, b) -> bool:
    """Equal bit for bit (float32 compared as its int32 words), wherever the
    two tensors live."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# measurement phase: the odometry step's per-stage profiling scripts and the
# pose-graph solve's dense-against-PCG crossover, through their main(argv)
# ---------------------------------------------------------------------------
MEASURE_SCRIPTS = ("profile_step2", "profile_step", "profile_insert")
# the crossover's sizes: the JAX script's 512-4096 and the engines' own graph
# capacities (128 in the figure-8 engine, 256 in the corridor's; bench.py:391,651)
MEASURE_SIZES = (128, 256, 512, 1024, 2048, 4096)
MEASURE_REPS = 1  # timed solves a size and mode (the phase's time: < 60 s)
# the stages whose path runs each kernel: the association, the insert, the gather
MEASURE_KERNEL_STAGES = {
    "merged_moments": {"profile_step2": ("step", "iekf", "query", "probe"),
                       "profile_step": ("step", "query_merged", "iekf"),
                       "profile_insert": ("query", "find_slots")},
    "insert_claim": {"profile_step2": ("step", "insert"), "profile_step": ("step", "insert"),
                     "profile_insert": ("insert",)},
    "gather_rows": {"profile_insert": ("gather", "gather_int")},
    "refresh_planes": {"profile_step": ("insert",)},
}


def measurement_phase(dev, out_dir: Path) -> dict:
    """``profile_step2``, ``profile_step`` and ``profile_insert`` at their
    full widths and ``bench_pgo_crossover`` over ``MEASURE_SIZES``, each
    through its ``main(argv)`` with every kernel's launch count set to 0
    just before and read just after (``launches_by_path`` keys
    ``measure_<script>``). Gates: every stage's outputs finite; the
    association stages launch ``merged_moments``, the insert stages
    ``insert_claim`` and the gather stages ``gather_rows``; at every size
    both solvers' costs finite and not above the starting cost, no row
    with an error."""
    import torch

    from fastliosam_tpu_torch.scripts import (
        bench_pgo_crossover, profile_insert, profile_step, profile_step2)

    t_phase = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    mods = {"profile_step2": profile_step2, "profile_step": profile_step,
            "profile_insert": profile_insert}
    stages, launches = {}, {}
    for name in MEASURE_SCRIPTS:
        path = out_dir / f"{name}.json"
        rc, launches[f"measure_{name}"] = _launch_counts(
            lambda: mods[name].main(["--out", str(path)]))
        stages[name] = {r["stage"]: r for r in json.loads(path.read_text())
                        if r["stage"] != "baseline"}
        _fail(f"measurement phase, {name}", {
            "exit 0": rc == 0,
            "every stage of the script": list(stages[name]) == list(mods[name].STAGES),
            "every stage's outputs finite": all(r["finite"] for r in stages[name].values()),
        })
    checks = {}
    for kernel, by_script in MEASURE_KERNEL_STAGES.items():
        for name, names in by_script.items():
            checks[f"{name} launches {kernel}"] = launches[f"measure_{name}"][kernel] > 0
            for st in names:
                checks[f"{name} {st} launches {kernel}"] = (
                    stages[name][st]["launches"].get(kernel, 0) > 0)
    _fail("measurement phase, kernels", checks)
    # the iEKF's e_x fallback (core/eigh3.py) builds its vector on the card:
    # no synchronizing call of any stage comes from there any more
    sites = {site: r["sync_sites"][site] for name in ("profile_step2", "profile_step")
             for r in stages[name].values() for site in (r["sync_sites"] or {})}
    step = stages["profile_step2"]["step"]
    print(f"  host syncs: profile_step2 step {step['syncs']} an iteration, iekf "
          f"{stages['profile_step2']['iekf']['syncs']}; sync sites of every stage {sites}")
    _fail("measurement phase, host syncs", {
        "no synchronizing call from core/eigh3.py": not any("eigh3.py" in k for k in sites),
        "profile_step2 step: fewer than 6 syncs an iteration": step["syncs"] < 6.0,
    })

    path = out_dir / "bench_pgo_crossover.json"
    rc, launches["measure_crossover"] = _launch_counts(lambda: bench_pgo_crossover.main(
        ["--sizes", *map(str, MEASURE_SIZES), "--reps", str(MEASURE_REPS), "--out", str(path)]))
    rows = json.loads(path.read_text())["rows"]
    checks = {"exit 0": rc == 0, "every size": [r["keyframes"] for r in rows]
              == list(MEASURE_SIZES)}
    for r in rows:
        K = r["keyframes"]
        checks[f"K={K}: no error"] = not any(k.endswith("_error") for k in r)
        for mode in ("dense", "pcg"):
            cost = r.get(f"{mode}_cost", float("nan"))
            checks[f"K={K}: {mode} cost finite, not above the start"] = bool(
                np.isfinite(cost) and cost <= r["start_cost"])
        print(f"  crossover K={K}: dense {r.get('dense_ms')} ms, pcg {r.get('pcg_ms')} ms, "
              f"dense/pcg {r.get('dense_over_pcg')}, costs {r.get('dense_cost')} / "
              f"{r.get('pcg_cost')} (start {r['start_cost']}; relative gap "
              f"{r.get('cost_gap_rel')}), device ops a solve {r.get('dense_device_ops')} / "
              f"{r.get('pcg_device_ops')}, dense peak {r.get('dense_peak_gib')} GiB")
    _fail("measurement phase, crossover", checks)
    torch.cuda.empty_cache()  # the dense solves' cached blocks (GiBs at 4096)
    return {"stages": stages, "crossover": rows, "launches": launches,
            "phase_s": time.perf_counter() - t_phase}


def measurement_child(out_dir: str) -> None:
    """Phase 13 in a process of its own (spawned): ``torch.profiler``
    leaves CUDA launches slower in the process that used it, which would
    slow every later engine phase of the script. Writes the phase's record
    to ``out_dir/phase.json``; a failed gate exits non-zero."""
    import torch

    out = Path(out_dir)
    rec = measurement_phase(torch.device("cuda", 0), out)
    (out / "phase.json").write_text(json.dumps(rec, default=str))


def _start_child(target, name: str, out: Path, *args):
    """``target(*args)`` in a spawned process (the kernels are built: it
    only loads them), which writes its record to ``out``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    sys.stdout.flush()
    proc = multiprocessing.get_context("spawn").Process(target=target, name=name, args=args)
    proc.start()
    return proc


def _child_record(proc, out: Path, timeout_s: float, what: str) -> dict:
    """Waits for a process of :func:`_start_child` (killed after
    ``timeout_s``); the record it wrote to ``out``, or a failure."""
    proc.join(timeout_s)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"{what} failed (exit {proc.exitcode})")
    return json.loads(out.read_text())


def run_measurement_phase(timeout_s: float = 600.0) -> dict:
    """:func:`measurement_child` in a spawned process; its record, or a
    failure."""
    out = ROOT / "build" / "measure"
    proc = _start_child(measurement_child, "measurement", out / "phase.json", str(out))
    return _child_record(proc, out / "phase.json", timeout_s, "measurement phase")


# ---------------------------------------------------------------------------
# scaling phase: the JAX scripts that sweep device counts, over
# torch.distributed ranks on the one card
# ---------------------------------------------------------------------------
# the sweeps' sizes are cut for the script's time limit: on one card they
# measure the gloo collectives' cost, not scaling
SCALING_ARGV = ["--keyframes", "256", "--devices", "1", "4"]
# the solved ring's positions at 4 ranks against 1 rank's: float32 composes
# the 256-step ring (radius 20.4 m, one ulp 1.9e-6 m) with tens of ulps of
# error, so its positions are defined to that; 1024 steps (radius 81.5 m)
# read 1.37e-4 m at 4 ranks
SCALING_POSE_GATE_M = 1e-3
# the crossover's sweep cut to one size and 4 ranks (its single twin and the
# 4-rank programs): the sharded solve's 269 gloo collectives take ~3.5 s a
# call at 4 ranks on one card
CROSSOVER_ARGV = ["--sizes", "256", "--devices", "4"]
PP_OVERLAP_ARGV = ["--n-chunks", "4"]  # of its 12: the time limit


def _summed(records) -> dict:
    """Kernel launch records summed by kernel name."""
    tot = {}
    for rec in records:
        for k, v in rec.items():
            tot[k] = tot.get(k, 0) + v
    return tot


def scaling_phase(dev) -> dict:
    """``bench_scaling``, ``bench_crossover`` and ``bench_pp_overlap``
    through their ``main(argv)`` (see the module docstring, phase 15)."""
    from fastliosam_tpu_torch.scripts import bench_crossover, bench_pp_overlap, bench_scaling

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "scaling_phase"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, parts_s = {}, {}
    for name, mod, argv in (("bench_scaling", bench_scaling, SCALING_ARGV),
                            ("bench_crossover", bench_crossover, CROSSOVER_ARGV),
                            ("bench_pp_overlap", bench_pp_overlap, PP_OVERLAP_ARGV)):
        path = out_dir / f"{name}.json"
        path.unlink(missing_ok=True)
        t0 = time.perf_counter()
        rc = mod.main(argv + ["--out", str(path)])
        parts_s[name] = time.perf_counter() - t0
        _fail(f"scaling phase, {name}", {"exit 0 with its JSON": rc == 0 and path.exists()})
        runs[name] = json.loads(path.read_text())
    sc, xo, pp = runs["bench_scaling"], runs["bench_crossover"], runs["bench_pp_overlap"]
    nn, mm, ins = "nearest_neighbors", "merged_moments", "insert_claim"
    checks = {"ranks share cuda:0 over gloo": sc["dist_backend"] == "gloo"
              and xo["dist_backend"] == "gloo"}
    fit1, idx1 = (sc[k][0]["aux"] for k in ("loop_icp", "loop_detect"))
    for row in sc["pgo_solve"]:
        # build_graph's poses satisfy every factor: its costs are float32
        # rounding, another at every rank count (the device's sums in another
        # order), so each is held to its own count's start and the solved
        # positions to the 1-rank solve's
        n, c = row["devices"], row["aux"]
        checks[f"{n} ranks: the solve's cost the same on every rank"] = (
            row["aux_by_rank"] == [c] * n)
        checks[f"{n} ranks: the cost finite, not above its start"] = bool(
            np.isfinite(c) and c <= row["start_cost"])
        checks[f"{n} ranks: the solved positions within {SCALING_POSE_GATE_M} m of 1 rank's"] = (
            row["pose_dev_m"] <= SCALING_POSE_GATE_M)
    for row in sc["loop_icp"]:
        n = row["devices"]
        checks[f"{n} ranks: the ICP fitness within 1e-4 of 1 rank's"] = (
            abs(row["aux"] - fit1) <= 1e-4 and row["aux_by_rank"] == [row["aux"]] * n)
        checks[f"{n} ranks: the NN launched on every rank of the ICP"] = all(
            r.get(nn, 0) > 0 for r in row["launches_by_rank"])
    for row in sc["loop_detect"]:
        checks[f"{row['devices']} ranks: the candidate index 1 rank's"] = (
            row["aux_by_rank"] == [idx1] * row["devices"])
    times = [t for rows in xo["stages"].values() for r in rows
             for t in [r["single_ms"], *r["sharded_ms"].values()]]
    checks["every crossover time finite and positive"] = bool(
        len(times) == 4 * 2 and all(np.isfinite(t) and t > 0 for t in times))
    vq = xo["stages"]["voxel_query"][0]["single_launches"]
    checks["the replicated voxel query launches merged_moments and insert_claim"] = (
        vq.get(mm, 0) > 0 and vq.get(ins, 0) > 0)
    flags = [f for run in pp["accepted_by_run"]["same_device"] for f in run]
    odo, ver = pp["launches"].get("odometry", {}), pp["launches"].get("verification", {})
    checks.update({
        "pp_overlap's times positive": pp["odom_only_s"] > 0 and pp["same_device_s"] > 0,
        "pp_overlap's flag the same in every chunk of every run": (
            len(flags) == 3 * pp["n_chunks"] and len(set(flags)) == 1),
        "pp_overlap's split keys null, with the reason": (
            pp["split_device_s"] is None and pp["verify_cost_hidden_frac"] is None
            and pp["speedup"] is None and "2 CUDA devices" in pp.get("split", "")),
        "pp_overlap's odometry launches merged_moments and insert_claim": (
            odo.get(mm, 0) > 0 and odo.get(ins, 0) > 0),
        "pp_overlap's verification launches the NN": ver.get(nn, 0) > 0,
    })
    launches = {
        "bench_scaling": _summed(r for key in ("pgo_solve", "loop_icp", "loop_detect")
                                 for row in sc[key] for r in row["launches_by_rank"]),
        "bench_crossover": _summed([row["single_launches"] for rows in xo["stages"].values()
                                    for row in rows] +
                                   [r for rows in xo["stages"].values() for row in rows
                                    for ranks in row["sharded_launches"].values()
                                    for r in ranks]),
        "bench_pp_overlap": _summed([odo, ver]),
    }
    result = {"bench_scaling": sc, "bench_crossover": xo, "bench_pp_overlap": pp,
              "parts_s": parts_s, "launches": launches,
              "phase_s": time.perf_counter() - t_phase}
    for key in ("pgo_solve", "loop_icp", "loop_detect"):
        print(f"  bench_scaling {key}: " + ", ".join(
            f"{r['devices']} ranks {r['ms']} ms (efficiency {r['efficiency']}, "
            f"{r['collectives_per_call']:.0f} collectives a call, result {r['aux']}"
            + (f" from {r['start_cost']}, positions {r['pose_dev_m']} m from 1 rank's"
               if "start_cost" in r else "") + ")"
            for r in sc[key]))
    for stage, rows in xo["stages"].items():
        r = rows[0]
        print(f"  bench_crossover {stage} K={r['K']}: single {r['single_ms']} ms, sharded "
              f"{r['sharded_ms']} ms, within 1.2x at {r['within_1p2x']}")
    print(f"  bench_pp_overlap: odometry alone {pp['odom_only_s']} s, with verification on the "
          f"same card {pp['same_device_s']} s; split: {pp.get('split')}; parts "
          + json.dumps({k: round(v, 1) for k, v in parts_s.items()})
          + f" s, of them rank 0 in the sweeps {sc['rank_s']:.1f} / {xo['rank_s']:.1f} s; "
          f"the worlds' start-up and end (s) {json.dumps(sc['ranks_s'])} / "
          f"{json.dumps(xo['ranks_s'])}")
    _fail("scaling phase", checks)
    return result


# ---------------------------------------------------------------------------
# bench-configurations phase (phase 16): bench.py's reference-exact and
# adversarial configurations through eval/feeds.py
# ---------------------------------------------------------------------------
LIVOX_NUM_DS = 4096  # bench.py: bench_livox's num_ds
LIVOX_MAP_SCANS = 33  # the Livox shapes' map: the rollout's after these scans
# the JAX package's Livox ATE on the CPU at full width (tests/test_torch_bench_configs.py:
# test_livox_jax_reading, slow; JAX on a TPU: 0.008 m, BENCH_r05.json); the
# port's card reading is gated below max(0.10 m, this + 1 cm)
LIVOX_JAX_ATE_M = 0.008401
LIVOX_MARGIN_M = 0.01
ATE_GATE_M = 0.10  # the figure-8 and Livox feeds' odometry gate (the JAX tests')
REFEXACT_CORRIDOR_SCANS = 30  # of the corridor feed's (bench: 400): the time limit
# the JAX package's reference-exact corridor ATE on the CPU at that depth
# (tests/test_torch_bench_gps.py: test_refexact_corridor_jax_reading, slow;
# 2 GPS factors, 6 solves); printed beside the card's, not gated
REFEXACT_CORRIDOR_JAX_ATE_M = 0.119347
REFEXACT_LOOP_PAIR = (10.0, 4.0)  # the figure-8 pair's gating: the bench engine's


def bench_feeds() -> None:
    """The feed only phase 16 reads (``eval/feeds.py: livox_sequence``),
    made in a feed worker at nice 10 and cached under ``build/feeds/``."""
    import os

    from fastliosam_tpu_torch.eval import feeds

    os.nice(10)
    feeds.livox_sequence()


def _twice(run, snap):
    """``run()`` twice (each from ``reset()``): the first with every launch
    count set to 0 before it and read after it, ``snap()`` after each.
    Returns the first run's result, its launches, both snapshots and the
    second run's host seconds (from and to a drained queue)."""
    import torch

    torch.cuda.synchronize()
    first, launches = _launch_counts(run)
    a = snap()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    return first, launches, a, snap(), second_s


def _engine_snap(engine):
    """Everything a replay must repeat bit for bit: the realtime trajectory,
    keyframe poses, loop pairs, solves and GPS factors."""
    from fastliosam_tpu_torch.utils import host_read

    n_gps = engine._n_gps_host
    gps = host_read(engine.graph.gps_idx[:n_gps], engine.graph.gps_xyz[:n_gps])
    return (np.stack(engine.realtime_traj), engine.keyframe_poses(), list(engine.loop_pairs),
            engine.solve_count, gps)


def _snaps_equal(a, b) -> bool:
    def eq(x, y):
        if isinstance(x, (tuple, list)):
            return len(x) == len(y) and all(eq(u, v) for u, v in zip(x, y))
        if isinstance(x, np.ndarray):
            return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
                x.view(np.uint8), y.view(np.uint8))
        return x == y
    return eq(a, b)


def _chunks_with_keyframes(engine, feed, chunk: int) -> int:
    """How many chunks added a keyframe (each keyframe's stamp to its scan)."""
    kf_st = engine.keyframe_stamps().astype(np.float64)
    scans = np.argmin(np.abs(np.asarray(feed["stamps"])[None, :] - kf_st[:, None]), axis=1)
    return len(set((scans // chunk).tolist()))


def livox_part(dev, floor) -> dict:
    """The Livox rollout (``bench.py: bench_livox``): ``make_rollout(data,
    raw_pts=8192, query_mode="merged", num_ds=4096)`` over the 43-scan
    rosette feed from the true start, twice (bit for bit), then the
    association and the insert at its shapes on its own map."""
    from fastliosam_tpu_torch.eval import feeds
    from fastliosam_tpu_torch.utils import host_read

    data = feeds.livox_sequence()
    ctx = feeds.make_rollout(data, raw_pts=feeds.LIVOX_PTS, query_mode="merged",
                             num_ds=LIVOX_NUM_DS, device=dev)
    out = {}

    def run():
        out["aux"] = ctx["roll"](ctx["gt_state"](), ctx["scans"], ctx["imus"])[1]

    def snap():
        return host_read(out["aux"]["R"], out["aux"]["p"], out["aux"]["n_matched"])

    _, launches, a, b, second_s = _twice(run, snap)
    R, p, matched = a
    S = ctx["S"]
    ate = float(np.sqrt(np.mean(np.sum((p - data["gt_p"][:S]) ** 2, axis=1))))
    gate = max(ATE_GATE_M, LIVOX_JAX_ATE_M + LIVOX_MARGIN_M)
    result = {"scans": S, "raw_pts": feeds.LIVOX_PTS, "num_ds": LIVOX_NUM_DS,
              "query_mode": "merged", "ate_m": ate, "ate_gate_m": gate,
              "scans_per_s": S / second_s, "min_matched_after_scan2": int(matched[2:].min()),
              "replay_bit_identical": _snaps_equal(a, b), "launches": launches}
    print("  livox " + json.dumps(result))
    print(f"  livox ATE {ate:.4f} m (JAX on the CPU {LIVOX_JAX_ATE_M} m; accuracy reference, "
          f"JAX on a TPU: 0.008 m), {result['scans_per_s']:.2f} scans/s ({card_line()})")
    _fail("bench configurations, livox", {
        "every pose finite": bool(np.all(np.isfinite(p)) and np.all(np.isfinite(R))),
        f"ATE < {gate:.4f} m": ate < gate,
        "n_matched > 500 after scan 2": result["min_matched_after_scan2"] > 500,
        "replay bit-identical": result["replay_bit_identical"],
        "merged_moments and insert_claim launched":
            launches["merged_moments"] > 0 and launches["insert_claim"] > 0,
        **_default_path(launches),
    })
    poses = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    poses[:, :3, :3], poses[:, :3, 3] = R, p
    result["kernels"] = check_livox_shapes(dev, data, ctx, poses, floor, launches)
    return result


def check_livox_shapes(dev, data, ctx, poses, floor, launches, reps: int = 10) -> dict:
    """``merged_moments`` (4096 downsampled points x the merged stencil's 7
    pools x 2 probes) and ``insert_claim`` (4096 points, 2 rounds) against
    their plain versions, bit for bit, on the Livox rollout's own 2^19-slot
    map after ``LIVOX_MAP_SCANS`` scans, with the downsampled points of the
    next ``reps`` scans at the rollout's poses; each timed over those sets
    beside the timing floor, its HBM byte bound and its plain version.
    Printed under ``at_livox_shape`` in the kernels line."""
    import torch

    from fastliosam_tpu_torch.map import voxel_hash as vh
    from fastliosam_tpu_torch.odom import ImuBatch, Scan
    from fastliosam_tpu_torch.ops import assoc_cuda, insert_cuda
    from fastliosam_tpu_torch.utils.timing import device_ms

    k0 = LIVOX_MAP_SCANS
    st, _ = ctx["roll"](ctx["gt_state"](), Scan(*(t[:k0] for t in ctx["scans"])),
                        ImuBatch(*(t[:k0] for t in ctx["imus"])))
    m, cfg = st.vmap, ctx["map_cfg"]
    vs, probes = cfg.voxel_size, cfg.query_probes
    rounds, maxp = max(cfg.insert_probes, cfg.claim_probes), cfg.max_points_per_voxel
    fp_np = m.fp.cpu().numpy()
    pts = [_downsampled_world(data, k, poses[k], dev, budget=LIVOX_NUM_DS)
           for k in range(k0, k0 + reps)]
    floor_ms = floor["1_blocks"]
    out = {}

    def record(name, shape, ms, plain_ms, nbytes):
        bound = nbytes / H100_BYTES_PER_S * 1e3
        print(f"  {name} at the Livox shape, {shape}: equal to its plain version; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound {bound:.5f} ms "
              f"({nbytes:.0f} HBM bytes), floor {floor_ms:.4f} ms, {launches[name]} launches "
              f"on the Livox rollout ({card_line()})")
        return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                "library_note": "none", "timing_floor_ms": floor_ms,
                "launches": launches[name]}

    sets = []
    for xyz, mask in pts:
        coords0, pools = vh.merged_pools(xyz, vs)
        sets.append((pools, coords0, mask))
    args, tail = (m.fp, m.moments), (vs, probes)
    for pools, coords0, mask in sets:
        got = assoc_cuda.merged_moments_cuda(*args, pools, coords0, mask, *tail)
        want = assoc_cuda.merged_moments_ref(*args, pools, coords0, mask, *tail)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("merged_moments at the Livox shape: kernel and plain "
                                 "version differ")
    ms = device_ms(lambda p, c, k: assoc_cuda.merged_moments_cuda(*args, p, c, k, *tail), sets)
    plain_ms = device_ms(lambda p, c, k: assoc_cuda.merged_moments_ref(*args, p, c, k, *tail),
                         sets)
    nbytes = float(np.mean([assoc_cuda.hbm_bytes(fp_np, p, c, probes) for p, c, _ in sets]))
    n_pools = sets[0][0].shape[0]
    out["merged_moments"] = record(
        "merged_moments", f"{LIVOX_NUM_DS} points x {n_pools} pools x {probes} probes, "
        f"2^{cfg.capacity.bit_length() - 1} slots", ms, plain_ms, nbytes)
    for xyz, mask in pts:
        _insert_equal("at the Livox shape", m.fp, m.coords, m.moments, xyz, mask, vs, rounds,
                      maxp)
    fresh = iter([(m.fp.clone(), m.coords.clone()) for _ in range(reps + 3)])
    ms = device_ms(lambda x, k: insert_cuda.insert_claim_into(*next(fresh), m.moments, x, k, vs,
                                                              rounds, maxp), pts)
    plain_ms = device_ms(lambda x, k: insert_cuda.insert_claim_ref(
        m.fp, m.coords, m.moments, x, k, vs, rounds, maxp), pts)
    nbytes = float(np.mean([insert_cuda.hbm_bytes(fp_np, x, k, insert_cuda.insert_claim_cuda(
        m.fp, m.coords, m.moments, x, k, vs, rounds, maxp)[2], vs, rounds) for x, k in pts]))
    out["insert_claim"] = record(
        "insert_claim", f"{LIVOX_NUM_DS} points, {rounds} rounds, "
        f"2^{cfg.capacity.bit_length() - 1} slots", ms, plain_ms, nbytes)
    return out


def refexact_fig8_part(dev, data, chunk: int) -> dict:
    """The reference-exact figure-8 (``bench.py: bench_reference_exact``):
    ``make_refexact(256, 512, 64)``, ``process_chunk`` over the bench's 150
    scans, twice from ``reset()``; then one ``verify_loop`` with
    ``LoopConfig.reference_exact(submap_points=16384)`` between the last
    keyframe and its nearest keyframe more than 4 s before within 10 m,
    twice."""
    import torch

    from fastliosam_tpu_torch.core import se3
    from fastliosam_tpu_torch.eval import feeds
    from fastliosam_tpu_torch.loop import LoopConfig, fetch_closest_keyframe_idx, verify_loop
    from fastliosam_tpu_torch.utils import host_read

    engine = feeds.make_refexact(256, 512, 64, chunk=chunk, device=dev)
    feed, _ = feeds._stage_chunks(data, chunk, dev)
    n = len(feed) * chunk

    def run():
        feeds._init_engine_at(engine, data)
        with _Probe(engine) as probe:
            feeds._run_pipeline(engine, feed)
        return probe.s["_solve"]

    solve_s, launches, a, b, second_s = _twice(run, lambda: _engine_snap(engine))
    kf_chunks = _chunks_with_keyframes(engine, data, chunk)
    result = {"scans": n, "keyframes": engine.kf.n, "solves": engine.solve_count,
              "chunks_with_keyframes": kf_chunks, "loops": len(engine.loop_pairs),
              "verifications": len(engine.loop_attempts), "ate_m": _ate(engine, data),
              "scans_per_s": n / second_s,
              "solve_ms_each": 1e3 * solve_s / max(engine.solve_count, 1),
              "replay_bit_identical": _snaps_equal(a, b), "launches": launches}
    # one verification between real submaps, in the branch without surfels
    q = engine.kf.n - 1
    idx, _ = fetch_closest_keyframe_idx(se3.trans(engine.graph.poses), engine.kf.stamps,
                                        engine.graph.kf_valid, q, *REFEXACT_LOOP_PAIR)
    c = int(host_read(idx))
    loop_cfg = LoopConfig.reference_exact(submap_points=16384)

    def verify():
        return verify_loop(engine.kf.clouds, engine.kf.masks, engine.graph.poses,
                           engine.graph.kf_valid, q, c, loop_cfg, device=dev)

    if c < 0:
        raise AssertionError("bench configurations, reference-exact figure-8: no keyframe "
                             "within 10 m and 4 s of the last one")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, v_launches = _launch_counts(verify)
    torch.cuda.synchronize()
    verify_ms = 1e3 * (time.perf_counter() - t0)
    again = verify()
    rel, si, acc, fit = host_read(*first)
    same = all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(first, again))
    want_si = 1.0 / np.sqrt(max(float(fit), 1e-4))
    result["verify"] = {"pair": [q, c], "fitness": float(fit), "accepted": bool(acc),
                        "sqrt_info": si.tolist(), "correction_m": float(np.linalg.norm(
                            rel[:3, 3] - host_read(se3.between(
                                engine.graph.poses[q], engine.graph.poses[c]))[:3, 3])),
                        "ms": verify_ms, "launches": v_launches, "replay_bit_identical": same}
    print("  reference-exact figure-8 " + json.dumps(result))
    print(f"  reference-exact figure-8: ATE {result['ate_m']:.4f} m, {engine.kf.n} keyframes, "
          f"{engine.solve_count} solves of {result['solve_ms_each']:.1f} ms, "
          f"{len(engine.loop_pairs)} loops, {result['scans_per_s']:.2f} scans/s (accuracy "
          f"reference, JAX on a TPU: 0.0315 m, 150 keyframes, 30 solves, 0 loops); "
          f"verify_loop {q} -> {c}: fitness {float(fit):.4f}, accepted {bool(acc)}, "
          f"{verify_ms:.1f} ms ({card_line()})")
    _fail("bench configurations, reference-exact figure-8", {
        "every pose finite": bool(np.all(np.isfinite(a[0])) and np.all(np.isfinite(a[1]))),
        "a keyframe every moving scan": engine.kf.n == n,
        "a solve in each chunk that adds a keyframe": engine.solve_count == kf_chunks,
        "no loop (the 30 s gap is longer than the feed)": not engine.loop_pairs,
        f"ATE < {ATE_GATE_M} m": result["ate_m"] < ATE_GATE_M,
        "replay bit-identical": result["replay_bit_identical"],
        "merged_moments and insert_claim launched":
            launches["merged_moments"] > 0 and launches["insert_claim"] > 0,
        **_default_path(launches),
        "verify_loop: the NN launched": v_launches["nearest_neighbors"] > 0,
        "verify_loop: no surfel map (no refresh_planes, no query_cached)":
            v_launches["refresh_planes"] == 0 and v_launches["query_cached"] == 0,
        "verify_loop: sqrt-info 1/sqrt(fitness) on all six axes": bool(
            np.all(si == si[0]) and abs(float(si[0]) / want_si - 1.0) < 1e-6),
        "verify_loop: replay bit-identical": same,
    })
    return result


def refexact_corridor_part(dev, corridor, chunk: int) -> dict:
    """The reference-exact corridor with GPS (``bench.py:
    bench_reference_exact``): ``make_refexact(512, 1024, 64, use_gps=True)``
    over the corridor feed's first ``REFEXACT_CORRIDOR_SCANS`` scans, fixes
    through WGS84 geodesy, twice from ``reset()``."""
    from fastliosam_tpu_torch.eval import feeds

    data = _feed_head(corridor, REFEXACT_CORRIDOR_SCANS)
    engine = feeds.make_refexact(512, 1024, 64, use_gps=True, chunk=chunk, device=dev)
    feed, _ = feeds._stage_chunks(data, chunk, dev)
    fixes = feeds._fixes_from_data(data)
    n = len(feed) * chunk

    def run():
        feeds._init_engine_at(engine, data)
        with _Probe(engine) as probe:
            feeds._run_pipeline(engine, feed, gps_fixes=fixes)
        return probe.s["_solve"]

    solve_s, launches, a, b, second_s = _twice(run, lambda: _engine_snap(engine))
    kf_chunks = _chunks_with_keyframes(engine, data, chunk)
    result = {"scans": n, "keyframes": engine.kf.n, "gps_factors": int(engine._n_gps_host),
              "solves": engine.solve_count, "chunks_with_keyframes": kf_chunks,
              "ate_m": _ate(engine, data), "jax_cpu_ate_m": REFEXACT_CORRIDOR_JAX_ATE_M,
              "scans_per_s": n / second_s,
              "solve_ms_each": 1e3 * solve_s / max(engine.solve_count, 1),
              "replay_bit_identical": _snaps_equal(a, b), "launches": launches}
    print("  reference-exact corridor " + json.dumps(result))
    print(f"  reference-exact corridor ({n} scans): ATE {result['ate_m']:.4f} m (JAX on the CPU "
          f"at this depth {REFEXACT_CORRIDOR_JAX_ATE_M} m; not gated: the corridor is chaotic), "
          f"{result['gps_factors']} GPS factors, {engine.solve_count} solves of "
          f"{result['solve_ms_each']:.1f} ms (accuracy reference, JAX on a TPU over 400 scans: "
          f"1.8376 m, 41 factors, 80 solves) ({card_line()})")
    _fail("bench configurations, reference-exact corridor", {
        "every pose finite": bool(np.all(np.isfinite(a[0])) and np.all(np.isfinite(a[1]))),
        "at least 2 GPS factors": result["gps_factors"] >= 2,
        "at least 2 solves": engine.solve_count >= 2,
        "a solve in each chunk that adds a keyframe": engine.solve_count == kf_chunks,
        "replay bit-identical": result["replay_bit_identical"],
        "merged_moments and insert_claim launched":
            launches["merged_moments"] > 0 and launches["insert_claim"] > 0,
        **_default_path(launches),
    })
    return result


def degraded_gps_part(dev, data, chunk: int) -> dict:
    """``bench.py: bench_gps_degraded`` on the bench's figure-8 engine: the
    middle third of the fixes at a 3 m sigma, Huber GPS residuals (2
    sigma), 2 m spacing, odometry sqrt information 200 / 1000, twice from
    ``reset()``. Its ``within_2x`` yardstick, phase 14's ``full_deferred``
    ATE, is applied in :func:`bench_configs_phase`."""
    from fastliosam_tpu_torch.eval import feeds

    engine = feeds.make_engine_for(data, chunk=chunk, device=dev)
    feed, _ = feeds._stage_chunks(data, chunk, dev)
    n = len(feed) * chunk
    fixes = feeds._fixes_from_data(data, degrade_middle=True)
    engine.pgo_cfg = engine.pgo_cfg._replace(gps_huber_delta=2.0)
    engine.cfg = engine.cfg._replace(use_gps=True, gps_dist_thres=2.0,
                                     odom_trans_sqrt_info=200.0, odom_rot_sqrt_info=1000.0)

    def run():
        feeds._init_engine_at(engine, data)
        with _Probe(engine) as probe:
            feeds._run_pipeline(engine, feed, gps_fixes=fixes)
        return probe.s["_solve"]

    solve_s, launches, a, b, second_s = _twice(run, lambda: _engine_snap(engine))
    n_gps = int(engine._n_gps_host)
    idx, _ = a[4]
    kf_st = engine.keyframe_stamps()[idx.astype(np.int64)].astype(np.float64)
    fix_t = np.asarray([f.stamp for f in fixes])
    used = np.argmin(np.abs(fix_t[None, :] - kf_st[:, None]), axis=1).tolist()
    third = len(fixes) // 3
    result = {"scans": n, "fixes": len(fixes), "gps_factors": n_gps, "fixes_used": used,
              "degraded": [third, 2 * third], "keyframes": engine.kf.n,
              "loops": len(engine.loop_pairs), "verifications": len(engine.loop_attempts),
              "solves": engine.solve_count, "ate_m": _ate(engine, data),
              "scans_per_s": n / second_s,
              "solve_ms_each": 1e3 * solve_s / max(engine.solve_count, 1),
              "replay_bit_identical": _snaps_equal(a, b), "launches": launches}
    print("  degraded GPS " + json.dumps(result))
    _fail("bench configurations, degraded GPS", {
        "every pose finite": bool(np.all(np.isfinite(a[0])) and np.all(np.isfinite(a[1]))),
        "at least 1 GPS factor": n_gps >= 1,
        "no factor from a fix in the degraded middle third":
            not [i for i in used if third <= i < 2 * third],
        f"ATE < {ATE_GATE_M} m": result["ate_m"] < ATE_GATE_M,
        "replay bit-identical": result["replay_bit_identical"],
        "a verification": result["verifications"] >= 1,
        "nearest_neighbors, refresh_planes, merged_moments and insert_claim launched":
            min(launches[k] for k in ("nearest_neighbors", "refresh_planes", "merged_moments",
                                      "insert_claim")) > 0,
        **_default_path(launches),
    })
    return result


def oracle_part(loop_free, root: str) -> dict:
    """``bench.py: bench_longrun_oracle`` on phase 8's loop-free engine
    (``exp_loop_trust.longrun_oracle``): ground-truth loops and one deep
    solve. Its graph, the card's solved positions and the ground truth go
    to ``ORACLE_GRAPH`` (the JAX package solves the same graph on the CPU in
    ``tests/test_torch_bench_configs.py``)."""
    from fastliosam_tpu_torch.scripts.exp_loop_trust import longrun_oracle

    if loop_free.loop_pairs:
        raise AssertionError("bench configurations, oracle: the engine closed loops")
    ORACLE_GRAPH.parent.mkdir(parents=True, exist_ok=True)
    out, launches = _launch_counts(lambda: longrun_oracle(loop_free, root, save_to=ORACLE_GRAPH))
    out["launches"] = launches
    print("  oracle " + json.dumps(out), flush=True)
    print(f"  oracle: {out['oracle_loops_injected']} loops injected, keyframe ATE "
          f"{out['oracle_odom_kf_ate_m']:.4f} m -> {out['oracle_solved_kf_ate_m']:.4f} m, the "
          f"solve {out['oracle_solve_s']:.1f} s (accuracy reference, JAX on a TPU: 287 loops, "
          f"3.5085 m -> 1.8184 m) ({card_line()})", flush=True)
    _fail("bench configurations, oracle", {
        "loops injected": out["oracle_loops_injected"] > 0,
        "finite": bool(np.isfinite([out["oracle_odom_kf_ate_m"],
                                    out["oracle_solved_kf_ate_m"]]).all()),
        "solved keyframe ATE < odometry keyframe ATE":
            out["oracle_solved_kf_ate_m"] < out["oracle_odom_kf_ate_m"],
    })
    return out


ORACLE_GRAPH = ROOT / "build" / "bench_configs" / "oracle_graph.npz"
BENCH_CHILD_OUT = ROOT / "build" / "bench_configs" / "engine_parts.json"
BENCH_CHILD_TIMEOUT_S = 900.0


def bench_child(corridor_path: str, chunk: int) -> None:
    """Phase 16's engine parts (the reference-exact figure-8 and corridor,
    the degraded GPS), in sequence, in a spawned process that runs beside
    the mesh phase (the kernels are built: it only loads them). Writes
    their records and seconds to ``BENCH_CHILD_OUT``; a failed gate exits
    non-zero."""
    import torch

    from fastliosam_tpu_torch.eval import feeds
    from fastliosam_tpu_torch.utils import geometry_precision

    sys.stdout.reconfigure(line_buffering=True)  # whole lines beside the mesh phase's
    dev = torch.device("cuda", 0)
    fig8 = feeds.fig8_sequence(PIPE_SCANS)
    parts, parts_s = {}, {}
    with geometry_precision():
        for name, run in (
                ("refexact_fig8", lambda: refexact_fig8_part(dev, fig8, chunk)),
                ("refexact_corridor",
                 lambda: refexact_corridor_part(dev, load_feed(corridor_path), chunk)),
                ("gps_degraded", lambda: degraded_gps_part(dev, fig8, chunk))):
            t0 = time.perf_counter()
            parts[name] = run()
            parts_s[name] = time.perf_counter() - t0
    BENCH_CHILD_OUT.write_text(json.dumps({"parts": parts, "parts_s": parts_s}, default=str))


def bench_configs_phase(dev, floor, engine_parts: dict, loop_free, kitti_root: str,
                        pipe_ate: float) -> dict:
    """Phase 16: the Livox part and the oracle in this process, in sequence
    and with nothing beside them (the Livox part's kernel timings), with
    the records of the engine parts that ran beside the mesh phase
    (:func:`bench_child`); ``pipe_ate`` is phase 14's ``full_deferred``
    ATE, the degraded GPS's ``within_2x`` yardstick. Each path's launches
    counted (``launches_by_path`` ``bench_*``), each part's seconds
    printed."""
    t_phase = time.perf_counter()
    parts = dict(engine_parts["parts"])
    parts_s = {f"{k} (beside the mesh phase)": v for k, v in engine_parts["parts_s"].items()}
    for name, run in (("livox", lambda: livox_part(dev, floor)),
                      ("oracle", lambda: oracle_part(loop_free, kitti_root))):
        t0 = time.perf_counter()
        parts[name] = run()
        parts_s[name] = time.perf_counter() - t0
    deg = parts["gps_degraded"]
    margin = 2.0 * pipe_ate - deg["ate_m"]
    deg.update(pipeline_ate_m=pipe_ate, within_2x=bool(margin >= 0.0), margin_m=margin)
    print(f"  degraded GPS: ATE {deg['ate_m']:.4f} m against the pipeline's {pipe_ate:.4f} m, "
          f"within_2x {deg['within_2x']} (margin {margin:.4f} m; not gated: JAX on a TPU "
          f"fails it), {deg['gps_factors']} of {deg['fixes']} fixes (accuracy reference, JAX "
          f"on a TPU: 0.0461 m, 2 of 146 fixes, margin -0.0089 m) ({card_line()})")
    print("  bench configurations parts (s): "
          + json.dumps({k: round(v, 1) for k, v in parts_s.items()}), flush=True)
    launches = {f"bench_{k}": r["launches"] for k, r in parts.items()}
    launches["bench_refexact_verify"] = parts["refexact_fig8"]["verify"]["launches"]
    return {"parts": parts, "parts_s": parts_s, "launches": launches,
            "kernels": parts["livox"].pop("kernels"), "phase_s": time.perf_counter() - t_phase}


def profile_summary(prof, wall_s: float, n_scans: int, top: int = 12) -> dict:
    """Device time by kernel over the traced window, and the device's busy
    share of the window's wall time (the port runs on one stream, so the
    kernels' times add up to the busy time)."""
    from fastliosam_tpu_torch.utils.timing import device_events

    # device-side rows only (kernels, copies, sets); the CPU op rows that
    # launched them would count the same time again
    rows = sorted(((ns, c, k) for k, (c, ns) in device_events(prof).items()), reverse=True)
    busy_s = sum(r[0] for r in rows) * 1e-9
    launches = sum(r[1] for r in rows)
    out = {
        "window_scans": n_scans, "wall_s": wall_s, "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "device_ops_per_scan": launches / n_scans,
        "top": [{"op": k[:80], "device_ms": ns / 1e6, "count": c} for ns, c, k in rows[:top]],
    }
    print(f"  profile over {n_scans} scans: wall {wall_s:.3f} s, device busy "
          f"{busy_s:.3f} s (idle {out['device_idle_share']:.1%}), "
          f"{out['device_ops_per_scan']:.0f} device ops/scan")
    for r in out["top"]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:6d}  {r['op']}")
    return out


def _phase_s(number: int, name: str, seconds: float) -> None:
    """One line with a phase's wall seconds."""
    print("phase_s " + json.dumps({"phase": number, "name": name, "s": round(seconds, 1)}))


def _wait_s(what: str, since: float) -> None:
    """One line with the seconds the card waited for a feed."""
    print("wait_s " + json.dumps({"wait": what, "s": round(time.perf_counter() - since, 1)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=150, help="figure-8 scans to run")
    ap.add_argument("--corridor-scans", type=int, default=CORRIDOR_SCANS,
                    help="GPS corridor scans (the bench runs 400; cut to keep the script "
                    "inside its time)")
    ap.add_argument("--chunk", type=int, default=5, help="scans per chunk")
    ap.add_argument("--seed", type=int, default=0, help="seed of the kernel inputs")
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    ap.add_argument("--profile-scans", type=int, default=0,
                    help="trace the last N scans of an extra per-scan run with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    print(card_line())
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from fastliosam_tpu_torch.ops import KERNEL_MODULES, build
    from fastliosam_tpu_torch.utils import geometry_precision

    # the KITTI sequence is written by its own worker processes from the
    # start, while every earlier phase runs
    kitti_pool = ThreadPoolExecutor(max_workers=1)
    kitti_job = kitti_pool.submit(kitti_feed)
    # two worker processes make the figure-8 and corridor feeds while the
    # kernels build and the kernel and measurement phases run; the bag
    # phase's recording follows in one of them at nice 10 (as the KITTI
    # generators run) while the engine phases run, and the pool is shut down
    # once it is made (more worker processes at once took the 8-core host down)
    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    bench_proc = None
    try:
        fig8_job = pool.submit(figure8_feed, args.scans)
        corridor_job = pool.submit(corridor_feed, args.corridor_scans)
        bag_job = pool.submit(bag_feed, args.scans)
        pipe_job = pool.submit(pipeline_feeds)
        bench_job = pool.submit(bench_feeds)
        _phase_s(1, "card and workers", time.perf_counter() - t_start)

        t0 = time.perf_counter()
        build.build(build.sources())
        print(f"build: {len(build.sources())} source(s) in {time.perf_counter() - t0:.1f} s")
        for name, log in sorted(build.build_logs.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}.cu: {line.strip()}")
        _phase_s(2, "build", time.perf_counter() - t0)

        with geometry_precision():
            t0 = time.perf_counter()
            print("kernel phase:")
            floor = {f"{b}_blocks": launch_floor_ms(b) for b in (1, 132)}
            print(f"  timing floor: an empty kernel (csrc/empty.cu) timed as the kernels are: "
                  f"1 block {floor['1_blocks']:.4f} ms, 132 blocks {floor['132_blocks']:.4f} ms")
            kernels = {"nearest_neighbors": check_nn(dev, args.seed)}
            kernels["nearest_neighbors"]["at_mesh_rank_shape"] = check_nn_rank_shape(
                dev, args.seed)
            print("experiment entry point (fastliosam_tpu_torch.scripts.exp_gather):")
            kernels["take_along_axis"], exp_launches, exp_recs = experiment_phase(dev)
            _fail("experiment entry point", {
                "take_along_axis launched": exp_launches["take_along_axis"] > 0})
            _phase_s(3, "kernels (no feed)", time.perf_counter() - t0)
        print("measurement phase (profile_step2, profile_step, profile_insert, "
              "bench_pgo_crossover, in a process of its own; beside the feed and KITTI "
              "workers, which share the host's cores: host times there read high):", flush=True)
        measure = run_measurement_phase()
        _phase_s(13, "measurement scripts", measure["phase_s"])
        t0 = time.perf_counter()
        fig8 = load_feed(fig8_job.result())
        corridor = load_feed(corridor_job.result())
        print(f"feeds: figure-8 {len(fig8['stamps'])} x {fig8['xyz'].shape[1]} points, "
              f"corridor {len(corridor['stamps'])} scans, {len(corridor['gps_t'])} fixes")
        _wait_s("figure-8 and corridor feeds", t0)

        with geometry_precision():
            t0 = time.perf_counter()
            print("kernel phase, row gather, plane refresh, point-to-plane normal equations, "
                  "association and insert (on the figure-8 map):")
            fig8_map = figure8_map(dev, fig8)
            kernels["gather_rows"], gather_cases = check_gather(dev, args.seed, *fig8_map[3:5])
            kernels["refresh_planes"] = check_plane_refresh(dev, fig8, fig8_map,
                                                            floor["1_blocks"])
            kernels["p2pl_normal_eq"] = check_p2pl(dev, fig8_map, floor["1_blocks"])
            kernels["merged_moments"] = check_assoc(dev, fig8, fig8_map)
            kernels["insert_claim"] = check_insert(dev, fig8, fig8_map)
            kernels["query_cached"] = check_query(dev, fig8, fig8_map)
            kernels["cached_rows"] = check_cached_rows(dev, fig8, fig8_map, floor["1_blocks"])
            del fig8_map
            _phase_s(3, "kernels (figure-8 map)", time.perf_counter() - t0)
            t0 = time.perf_counter()
            print("per-scan phase (SlamEngine.process):")
            per_scan, fig8_traj = per_scan_phase(dev, fig8)
            _phase_s(4, "per-scan", time.perf_counter() - t0)
            t0 = time.perf_counter()
            print(f"chunked phase (SlamEngine.process_chunk_deferred, chunk {args.chunk}):")
            chunked = chunked_phase(dev, fig8, args.chunk)
            _phase_s(5, "chunked", time.perf_counter() - t0)
            t0 = time.perf_counter()
            print(f"GPS phase (corridor, SlamEngine.process_chunk, chunk {args.chunk}):")
            gps, gps_kf = gps_phase(dev, corridor, args.chunk)
            _phase_s(6, "GPS", time.perf_counter() - t0)
            t0 = time.perf_counter()
            print("modes phase (cached + point-to-plane per scan; merged2 + multi-start chunked):")
            modes = modes_phase(dev, fig8, args.chunk)
            _phase_s(7, "modes", time.perf_counter() - t0)
            t0 = time.perf_counter()
            kitti_root, kitti_s = kitti_job.result()
            kitti_pool.shutdown()
            _wait_s("KITTI sequence", t0)
            t0 = time.perf_counter()
            print(f"KITTI phase ({KITTI_SCANS} scans generated in {kitti_s:.1f} s):")
            kitti, kitti_loop_free = kitti_phase(dev, kitti_root, args.chunk)
            kitti["feed_s"] = kitti_s
            _phase_s(8, "KITTI", time.perf_counter() - t0)
            t0 = time.perf_counter()
            bag_dir = bag_job.result()
            _wait_s("bag recording", t0)
            t0 = time.perf_counter()
            print(f"bag phase (run_slam --dataset bag|mulran|newer-college, {OS1_64[0]} x "
                  f"{OS1_64[1]} rays):")
            bag = bag_phase(dev, bag_dir)
            _phase_s(9, "bag", time.perf_counter() - t0)
            t0 = time.perf_counter()
            print(f"batched phase (eval/batch_eval.py: batched_rollout, {BATCH_LANES} lanes x "
                  f"{BATCH_SCANS} figure-8 scans):")
            batched = batched_phase(dev, fig8, floor)
            _phase_s(10, "batched", time.perf_counter() - t0)
            t0 = time.perf_counter()
            pipe_job.result()  # the bench's figure-8 feed, which the engine parts read
            _wait_s("pipeline feeds", t0)
            print("bench configurations, engine parts (phase 16's reference-exact figure-8 "
                  "and corridor and degraded GPS, in a process of its own beside the mesh "
                  "phase, a correctness run: host times in both read high):")
            bench_proc = _start_child(bench_child, "bench_configs", BENCH_CHILD_OUT,
                                      corridor_job.result(), args.chunk)
            print(f"mesh phase (SlamEngine(mesh=make_mesh({MESH_RANKS})), gloo ranks on one "
                  f"card, process_chunk, chunk {args.chunk}; then NCCL at world size 1):")
            mesh = mesh_phase(dev, fig8_job.result(), args.chunk)
            _phase_s(11, "mesh", mesh["phase_s"])
            t0 = time.perf_counter()
            engine_parts = _child_record(bench_proc, BENCH_CHILD_OUT, BENCH_CHILD_TIMEOUT_S,
                                         "bench configurations, engine parts")
            _wait_s("bench configurations, engine parts", t0)
            print("postprocess phase (fastliosam_tpu_torch.postprocess on the KITTI export, the "
                  "GPS keyframes and the figure-8 trajectory):")
            pp = postprocess_phase(dev, ROOT / "build" / "kitti_export" / "00_map.pcd",
                                   corridor, gps_kf, fig8, fig8_traj)
            kernels.update(pp["kernels"])
            _phase_s(12, "postprocess", pp["result"]["phase_s"])
            print("pipeline phase (profile_pipeline, exp_gps_noinit_probe, roofline_odom, "
                  "exp_gather --xla, microbench_gather on eval/feeds.py's feeds):", flush=True)
            pipe = pipeline_phase(dev)
            _phase_s(14, "pipeline scripts", pipe["phase_s"])
            print("scaling phase (bench_scaling, bench_crossover: 4 gloo ranks on cuda:0; "
                  "bench_pp_overlap on cuda:0):", flush=True)
            scaling = scaling_phase(dev)
            _phase_s(15, "scaling scripts", scaling["phase_s"])
            t0 = time.perf_counter()
            bench_job.result()
            _wait_s("bench configuration feeds", t0)
            print("bench configurations phase (the Livox rollout and the long-run oracle; the "
                  "engine parts ran beside the mesh phase):", flush=True)
            bench = bench_configs_phase(dev, floor, engine_parts, kitti_loop_free, kitti_root,
                                        pipe["pipeline_ate_m"])
            del kitti_loop_free
            _phase_s(16, "bench configurations", bench["phase_s"])
            if args.profile_scans > 0:
                print(f"profile (SlamEngine.process, last {args.profile_scans} scans):")
                per_scan["profile"] = profile_phase(dev, fig8, args.profile_scans)
    finally:
        pool.shutdown(cancel_futures=True)
        if bench_proc is not None and bench_proc.is_alive():
            bench_proc.kill()
            bench_proc.join()

    paths = {"per_scan": per_scan["launches"], "chunked": chunked["launches"],
             "gps": gps["launches"], "exp_gather": exp_launches,
             **{f"modes_{k}": r["launches"] for k, r in modes.items()},
             "kitti_longrun": kitti["longrun"]["launches"],
             "kitti_resume": kitti["resume"]["launches"],
             "kitti_localize": kitti["localize"]["launches"],
             **{k: r["launches"] for k, r in bag.items()},
             "batched": batched["launches"], "batched_cached": batched["cached"]["launches"],
             "mesh": {k: sum(r[k] for r in mesh["launches_per_rank"])
                      for k in mesh["launches_per_rank"][0]},
             "mesh_nccl": mesh["nccl"]["launches"],
             "postprocess": pp["result"]["launches"], **measure["launches"],
             **pipe["launches"], **scaling["launches"], **bench["launches"]}
    shapes = kitti["kernel_shapes"]
    at_localizer = {"nearest_neighbors": shapes["nearest_neighbors"],
                    "insert_claim": shapes["insert_claim"],
                    "refresh_planes": shapes["refresh_planes"]}
    line = {"kernels": [], "timing_floor_ms": floor}
    for mod in KERNEL_MODULES:
        rec = dict(mod.KERNEL)
        name = rec["name"]
        rec["launches"] = sum(p.get(name, 0) for p in paths.values())
        rec["launches_by_path"] = {k: p.get(name, 0) for k, p in paths.items()}
        rec.update(kernels[name])
        if rec["route"] != mod.KERNEL["route"]:
            raise AssertionError(f"{name}: a check overwrote the kernel's route")
        if name in at_localizer:
            rec["at_localizer_shape"] = at_localizer[name]
        if name in batched["kernels"]:
            rec["at_lanes"] = batched["kernels"][name]
        if name in bench["kernels"]:
            rec["at_livox_shape"] = bench["kernels"][name]
        if "at_mesh_rank_shape" in rec:
            rec["at_mesh_rank_shape"]["launches_per_rank"] = [
                r[name] for r in mesh["launches_per_rank"]]
        line["kernels"].append(rec)
    print(f"total_s {time.perf_counter() - t_start:.1f}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card_line(), "kernels": line["kernels"], "gather_cases": gather_cases,
             "exp_gather": exp_recs, "per_scan": per_scan, "chunked": chunked, "gps": gps,
             "modes": modes, "kitti": kitti, "bag": bag, "batched": batched, "mesh": mesh,
             "postprocess": pp, "measurement": measure, "pipeline": pipe,
             "scaling": scaling, "bench_configs": bench, "timing_floor_ms": floor,
             "total_s": time.perf_counter() - t_start},
            indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
