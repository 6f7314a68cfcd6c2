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

Ported so far: the per-scan ``SlamEngine.process`` path with GPS off —
odometry (IMU propagate, deskew, voxel downsample, iEKF against the
voxel-surfel hash map), keyframing, loop detection, ICP verification and
the LM/PCG pose-graph solve. The one TPU (Pallas) kernel on that path, the
fused nearest-neighbour search, is a hand-written CUDA kernel
(``csrc/nn.cu``, wrapper ``ops/nn_cuda.py``).

Subpackages:
  core     SO3/SE3 batched ops, closed-form 3x3 eig, voxel downsample
  map      voxel-hash surfel map
  odom     IMU propagation, deskew, iterated ESKF, per-scan step
  ops      hand-written CUDA kernels, their plain versions, the nvcc build
  loop     loop candidate search, point-to-point ICP, loop verification
  pgo      factor-graph storage + LM/PCG solver
  runtime  the per-scan engine
  sim      synthetic world generator (numpy copy of the JAX package's)
  eval     ATE / RPE metrics (numpy copy)
  convert  JAX-package state (as numpy) -> port tensors
"""

__version__ = "0.1.0"
