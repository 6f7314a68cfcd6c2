"""Image tooling the sensor recorder needs: compressed-image decode and
8-parameter OpenCV undistortion (`decompress_save_images*.py`,
`undistort_image.py`, `sensor_recorder.cpp:54-60`).

The port's own numpy copy of the part of ``fastliosam_tpu/postprocess/
images.py`` that ``runtime/recorder.py`` and ``scripts/bag_tools.py``
call (``HAS_CV2``, ``CameraModel`` without ``project``,
``decode_compressed``); exposure repair, projection and colouring are
not ported yet.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2

    HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAS_CV2 = False


def _require_cv2():
    if not HAS_CV2:
        raise RuntimeError("OpenCV (cv2) is required for this operation")


class CameraModel:
    """Pinhole + OpenCV 8-parameter distortion (LENSMODEL_OPENCV8, the
    reference's mrcal calibration format `camera_model/opencv8.cameramodel`)."""

    def __init__(self, fx, fy, cx, cy, dist_coeffs, width=None, height=None):
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self.dist = np.asarray(dist_coeffs, np.float64)
        self.width = width
        self.height = height

    @staticmethod
    def from_mrcal(path: str) -> "CameraModel":
        """Parse an mrcal .cameramodel file (a python-literal dict)."""
        import ast

        with open(path) as f:
            text = f.read()
        model = ast.literal_eval(text)
        intr = model["intrinsics"][1]
        fx, fy, cx, cy = intr[:4]
        dist = intr[4:]
        w, h = model.get("imagersize", (None, None))
        return CameraModel(fx, fy, cx, cy, dist, w, h)

    def undistort(self, image: np.ndarray) -> np.ndarray:
        _require_cv2()
        return cv2.undistort(image, self.K, self.dist)


def decode_compressed(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> BGR image (sensor_msgs/CompressedImage payload)."""
    _require_cv2()
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
