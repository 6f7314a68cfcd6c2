"""Geometry-precision policy (port of ``fastliosam_tpu/utils/precision.py``).

Reduced-precision matmul passes silently degrade SE(3) geometry: on the TPU
bf16 passes cost ~4x odometry ATE and left a pose-graph "optimum" cost of
79.8 on an exactly consistent graph. On an NVIDIA card the analogous hazard
is TF32 (about three decimal digits), which cuDNN enables for float32 by
default. Geometry entry points therefore run with TF32 off for both cuBLAS
matmuls and cuDNN and with float32 matmul precision "highest".
"""
from __future__ import annotations

import contextlib

import torch


class geometry_precision(contextlib.ContextDecorator):
    """Decorator / context: full-float32 matmuls inside, previous settings
    restored on exit."""

    def __enter__(self):
        self._saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        matmul_tf32, cudnn_tf32, prec = self._saved
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(prec)
        return False
