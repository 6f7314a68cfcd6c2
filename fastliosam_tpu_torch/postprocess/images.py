"""Image tooling: undistortion, exposure adaptation, LiDAR-camera fusion
(port of ``fastliosam_tpu/postprocess/images.py``).

Capability ports of the reference's image post-processing
(SURVEY.md §2.2): 8-parameter OpenCV undistortion (`undistort_image.py`,
`sensor_recorder.cpp:54-60`), CLAHE / exposure repair
(`exposure_adaption/*`), compressed-image decode
(`decompress_save_images*.py`), LiDAR→camera projection + coloring
(`lidar_projection.cpp`, `colorize_pcd.py`).

The image operations are OpenCV calls on the host, as in the JAX package.
``CameraModel.project`` is OpenCV's 8-parameter projection written in
float64 torch, so the projection and the colouring run on ``device``
(``None``: ``cuda``, which raises without CUDA) with no OpenCV there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

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

    def project_t(self, pts):
        """:meth:`project` of a float64 tensor ``(N, 3)`` on its device:
        ``(px (N, 2), in_front (N,))`` tensors. ``cv2.projectPoints``'
        rational model (``x' = x (1 + k1 r² + k2 r⁴ + k3 r⁶) / (1 + k4 r² +
        k5 r⁴ + k6 r⁶) + 2 p1 x y + p2 (r² + 2 x²)``, likewise ``y'``) at
        zero rotation and translation, with up to 8 coefficients."""
        if len(self.dist) not in (0, 4, 5, 8):
            raise ValueError(f"expected 0, 4, 5 or 8 distortion coefficients, got "
                             f"{len(self.dist)}")
        k1, k2, p1, p2, k3, k4, k5, k6 = np.pad(self.dist, (0, 8 - len(self.dist))).tolist()
        fx, fy, cx, cy = self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]
        z = pts[:, 2]
        inv_z = torch.where(z != 0, 1.0 / z, torch.ones_like(z))
        x, y = pts[:, 0] * inv_z, pts[:, 1] * inv_z
        r2 = x * x + y * y
        r4, r6 = r2 * r2, r2 * r2 * r2
        radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
        a1, a2, a3 = 2 * x * y, r2 + 2 * x * x, r2 + 2 * y * y
        xd = x * radial + p1 * a1 + p2 * a2
        yd = y * radial + p1 * a3 + p2 * a1
        return torch.stack([xd * fx + cx, yd * fy + cy], dim=1), z > 0.05

    def project(self, pts_cam: np.ndarray, device=None):
        """Camera-frame 3D points -> pixel coords + in-front mask
        (`lidar_projection.cpp:9-34` capability, distortion-aware)."""
        pts = torch.as_tensor(np.asarray(pts_cam, np.float64).reshape(-1, 3),
                              device=resolve_device(device))
        px, in_front = self.project_t(pts)
        return px.cpu().numpy(), in_front.cpu().numpy()


def decode_compressed(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> BGR image (sensor_msgs/CompressedImage payload)."""
    _require_cv2()
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def clahe_adjust(image: np.ndarray, clip_limit=2.0, tile_grid=(8, 8)) -> np.ndarray:
    """CLAHE on the L channel (`CLAHE_region_adjusted.py` capability)."""
    _require_cv2()
    lab = cv2.cvtColor(image, cv2.COLOR_BGR2LAB)
    l, a, b = cv2.split(lab)
    clahe = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=tile_grid)
    return cv2.cvtColor(cv2.merge([clahe.apply(l), a, b]), cv2.COLOR_LAB2BGR)


def detect_exposure(image: np.ndarray) -> str:
    """Histogram-based exposure classification (`correct_exposure`
    capability): returns 'under' / 'over' / 'ok'."""
    _require_cv2()
    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    hist = cv2.calcHist([gray], [0], None, [256], [0, 256]).ravel()
    total = hist.sum()
    dark = hist[:50].sum() / total
    bright = hist[205:].sum() / total
    if bright > 0.25:
        return "over"
    if dark > 0.5:
        return "under"
    return "ok"


def fix_overexposure(image: np.ndarray, v_thresh=235, strength=0.6) -> np.ndarray:
    """Recover over-exposed regions via HSV V-channel compression
    (`solve_overexposure` capability)."""
    _require_cv2()
    hsv = cv2.cvtColor(image, cv2.COLOR_BGR2HSV).astype(np.float32)
    v = hsv[..., 2]
    mask = v > v_thresh
    v[mask] = v_thresh + (v[mask] - v_thresh) * (1.0 - strength)
    hsv[..., 2] = np.clip(v, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


def tonemap_hdr(image: np.ndarray, gamma=2.2, saturation=1.0,
                bias=0.85) -> np.ndarray:
    """Simulated-HDR local tone mapping (`exposure_adaption/use_hdr.py`
    capability): Drago tonemap over the 8-bit input, back to 8-bit."""
    _require_cv2()
    img = image.astype(np.float32) / 255.0
    tm = cv2.createTonemapDrago(gamma=gamma, saturation=saturation, bias=bias)
    out = tm.process(img)
    out = np.nan_to_num(out, nan=0.0, posinf=1.0, neginf=0.0)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def colorize_cloud(
    pts_world: np.ndarray,
    image: np.ndarray,
    cam: CameraModel,
    T_world_cam: np.ndarray,
    device=None,
):
    """Sample image colors for 3D points (`colorize_pcd.py` capability),
    on ``device``: the transform, the projection and the image read.

    Returns ``(rgb (N,3) uint8, valid mask)``.
    """
    dev = resolve_device(device)
    T = torch.as_tensor(np.asarray(T_world_cam, np.float64), device=dev)
    Rwc, twc = T[:3, :3], T[:3, 3]
    pts = torch.as_tensor(np.asarray(pts_world, np.float64), device=dev)
    px, in_front = cam.project_t((pts - twc) @ Rwc)
    h, w = image.shape[:2]
    u = torch.round(px[:, 0]).to(torch.int64)  # halves to even, as np.round
    v = torch.round(px[:, 1]).to(torch.int64)
    valid = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    img = torch.as_tensor(np.ascontiguousarray(image), device=dev)
    rgb = torch.zeros((len(pts), 3), dtype=torch.uint8, device=dev)
    rgb[valid] = img[v[valid], u[valid]].flip(-1)
    return rgb.cpu().numpy(), valid.cpu().numpy()


def blur_regions(image: np.ndarray, boxes, ksize: int = 41) -> np.ndarray:
    """Gaussian-blur axis-aligned regions ``boxes = [(x0, y0, x1, y1), ...]``
    (pixel coords)."""
    _require_cv2()
    out = image.copy()
    h, w = image.shape[:2]
    k = ksize | 1
    for (x0, y0, x1, y1) in boxes:
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1, y1 = min(int(x1), w), min(int(y1), h)
        if x1 <= x0 or y1 <= y0:
            continue
        out[y0:y1, x0:x1] = cv2.GaussianBlur(out[y0:y1, x0:x1], (k, k), 0)
    return out


def anonymize_image(image: np.ndarray, detector, ksize: int = 41):
    """PII anonymization (the reference's `predict.py` YOLO-for-PII
    capability): run a pluggable ``detector(image) -> [(x0,y0,x1,y1), ...]``
    (e.g. an ultralytics model's boxes) and blur every detection. Returns
    ``(image, n_regions)``. Detector weights are deployment-provided; this
    module only supplies the pipeline."""
    boxes = detector(image)
    return blur_regions(image, boxes, ksize), len(boxes)


def project_clusters_to_image(
    pts_world: np.ndarray,
    image: np.ndarray,
    cam: CameraModel,
    T_world_cam: np.ndarray,
    k: int = 5,
    radius: int = 2,
    device=None,
):
    """K-means cluster the cloud and draw each cluster's projection in a
    distinct color (`lidar_projection.cpp` capability). Returns the
    annotated image copy and the labels."""
    _require_cv2()
    pts32 = np.asarray(pts_world, np.float32)
    _, labels, _ = cv2.kmeans(
        pts32, k, None,
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 20, 0.5),
        3, cv2.KMEANS_PP_CENTERS,
    )
    labels = labels.ravel()
    Rwc, twc = T_world_cam[:3, :3], T_world_cam[:3, 3]
    px, in_front = cam.project((pts32 - twc) @ Rwc, device=device)
    out = image.copy()
    h, w = image.shape[:2]
    rng = np.random.default_rng(0)
    colors = rng.integers(0, 255, size=(k, 3))
    for i in range(len(pts32)):
        if not in_front[i]:
            continue
        u, v = int(round(px[i, 0])), int(round(px[i, 1]))
        if 0 <= u < w and 0 <= v < h:
            cv2.circle(out, (u, v), radius, tuple(int(c) for c in colors[labels[i]]), -1)
    return out, labels
