"""fastliosam_tpu_torch — the PyTorch/CUDA port of ``fastliosam_tpu``.

A second package beside the JAX one, which stays the reference. It mirrors
the JAX package's layout and public names (``core/so3.py``,
``map/voxel_hash.py``, ``odom/pipeline.py``, ...) so each module's
counterpart is easy to find, and it is held against the JAX package by the
parity tests in ``tests/test_torch_*.py``.

The package imports ``torch`` and numpy only — never ``jax`` and nothing of
``fastliosam_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit CPU device they
raise rather than fall back.

Ported so far: the engine's per-scan ``process`` path and its chunked
and deferred paths (``process_chunk``, ``process_chunk_deferred``: no host
read inside a chunk), with GPS fusion — odometry (IMU propagate, deskew,
voxel downsample, iEKF against the voxel-surfel hash map), keyframing,
loop detection, ICP verification, the LM/PCG pose-graph solve, the
marginal covariance and the WGS84 geodesy — and the user's entry point
around it: the KITTI and generic-directory readers with the native
threaded decoder, ``drive_kitti``, result export, checkpoint/resume, the
map localizer and the ``run_slam`` / ``localize`` / ``exp_loop_trust``
scripts; the ROS side (ROS1 and ROS2 bags, the sensor presets behind
``run_slam --dataset bag``, the MulRan and Newer College readers, the
sensor recorder with its telemetry sinks, ``bag_tools``); every
plane-query mode (``merged``, ``merged2``, ``merged3``,
``cached``) and every loop-ICP mode (point-to-point, point-to-plane,
multi-start); and the data-parallel batched rollout
(``eval/batch_eval.py``: B sequences in one pass a step, the map kernels
with a lane axis). Every TPU (Pallas) kernel in the repository has a
hand-written CUDA counterpart: the fused nearest-neighbour search
(``csrc/nn.cu``), the row gather (``csrc/gather.cu``: the plane refresh,
the point-to-plane ICP's reads), the association's probe-gather-merge
(``csrc/assoc.cu``), the cached-plane query's probe and read
(``csrc/query.cu``), the map insert's probe-and-claim rounds
(``csrc/insert.cu``) and the 2-D ``take_along_axis`` of the gather
experiments (``csrc/take_along.cu``). Float scatter-adds sum in a fixed
order, so a run on the card is bit-for-bit repeatable, as the JAX
package is.

Subpackages:
  core         SO3/SE3 batched ops, closed-form 3x3 eig, voxel downsample,
               fixed-order scatter-adds, WGS84/ENU/HK1980 geodesy
  map          voxel-hash surfel map
  odom         IMU propagation, deskew, iterated ESKF, per-scan step
  ops          hand-written CUDA kernels, their plain versions, the nvcc build
  loop         loop candidate search, point-to-point and point-to-plane ICP,
               multi-start loop verification
  pgo          factor-graph storage + LM/PCG solver + marginal covariance
  runtime      the engine (per scan, chunked, deferred; GPS), the KITTI
               drive loop, export and checkpoint/resume, the map localizer,
               the sensor recorder and its HTTP / WebSocket telemetry sinks
  io           KITTI / generic / MulRan / Newer College / PCD / pose-file
               readers and writers, ROS1 and ROS2 bags and their message
               codecs, the sensor presets, the native reader (numpy and
               stdlib copies; ``native/fls_native.cpp``)
  postprocess  the HTML map viewer, compressed-image decode and
               undistortion (numpy copies)
  scripts      entry points (``python -m fastliosam_tpu_torch.scripts.run_slam``,
               ``.localize``, ``.make_kitti_synth``, ``.exp_loop_trust``,
               ``.bag_tools``, ``.exp_gather``, ``.ab_trees``)
  sim          synthetic world generator (numpy copy of the JAX package's)
               and its writers of recordings (bag, MulRan, ground truth)
  eval         ATE / RPE metrics (numpy copy), the batched rollout
  convert      JAX-package state (as numpy) -> port tensors, and a batched
               odometry state back
"""

__version__ = "0.3.0"
