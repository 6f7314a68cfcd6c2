"""YOLO-style PII detection pipeline (reference `post_process/predict.py`;
port of ``fastliosam_tpu/postprocess/detect.py``).

The reference runs ultralytics YOLOv11x over a directory of rectified
images with ``conf=0.01, classes=[0, 1]`` and saves annotated results.
Ultralytics is not a dependency and no pretrained weights ship with the
repository, so this module implements the *pipeline* ultralytics provides —
letterbox preprocessing, anchor-free YOLOv8/v11 head decoding,
class-aware NMS, box rescaling, annotation/blur, and the directory
batch runner — around a pluggable model backend:

* any callable ``model(chw_f32[1,3,H,W]) -> raw head output`` (numpy or a
  tensor),
* or a TorchScript file path, loaded onto ``device`` (the card by default)
  and run there.

Preprocessing and rescaling are numpy/cv2 on the host; the decode and the
NMS are torch on the head output's device (a numpy head: on ``device``).
Deployment supplies the weights; everything else is here.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .images import _require_cv2, blur_regions

try:  # pragma: no cover - exercised only when cv2 exists
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


# --------------------------------------------------------------------------
# preprocessing


def letterbox(image: np.ndarray, new_shape: int = 640, pad_value: int = 114):
    """Resize keeping aspect ratio and pad to ``new_shape`` square (the
    ultralytics LetterBox transform). Returns ``(padded, scale, (dx, dy))``
    where ``orig = (letterboxed - (dx, dy)) / scale``."""
    _require_cv2()
    h, w = image.shape[:2]
    scale = min(new_shape / h, new_shape / w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    dx, dy = (new_shape - nw) / 2.0, (new_shape - nh) / 2.0
    top, bottom = int(round(dy - 0.1)), int(round(dy + 0.1))
    left, right = int(round(dx - 0.1)), int(round(dx + 0.1))
    padded = cv2.copyMakeBorder(resized, top, bottom, left, right,
                                cv2.BORDER_CONSTANT,
                                value=(pad_value,) * 3)
    return padded, scale, (left, top)


def to_chw(image_bgr: np.ndarray) -> np.ndarray:
    """HWC uint8 BGR -> (1, 3, H, W) float32 RGB in [0, 1]."""
    x = image_bgr[..., ::-1].astype(np.float32) / 255.0
    return np.ascontiguousarray(x.transpose(2, 0, 1))[None]


# --------------------------------------------------------------------------
# decoding + NMS


def _nms_t(boxes, scores, iou_thresh: float):
    """Greedy IoU NMS of float32 tensors, on their device; kept indices
    (descending score) as an int64 tensor."""
    order = torch.argsort(-scores, stable=True)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    keep = []
    while order.numel():
        i = order[:1]
        keep.append(i)
        if order.numel() == 1:
            break
        rest = order[1:]
        ix0 = torch.maximum(x0[i], x0[rest])
        iy0 = torch.maximum(y0[i], y0[rest])
        ix1 = torch.minimum(x1[i], x1[rest])
        iy1 = torch.minimum(y1[i], y1[rest])
        inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
        iou = inter / torch.clamp(area[i] + area[rest] - inter, min=1e-9)
        order = rest[iou <= iou_thresh]
    if not keep:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    return torch.cat(keep)


def _head_tensor(raw, device):
    if isinstance(raw, torch.Tensor):
        return raw.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(raw, np.float32), device=resolve_device(device))


def nms(boxes, scores, iou_thresh: float = 0.45, device=None):
    """Greedy IoU NMS over xyxy ``boxes``; returns kept indices
    (descending score). Runs on the inputs' device where they are tensors,
    else on ``device``. The order of equal scores is a stable sort's (numpy's
    ``argsort`` does not promise one)."""
    b = _head_tensor(boxes, device)
    s = _head_tensor(scores, device).to(b.device)
    return _nms_t(b, s, iou_thresh).cpu().numpy()


def decode_yolo(
    raw,
    conf: float = 0.25,
    classes: Optional[Sequence[int]] = None,
    iou_thresh: float = 0.45,
    max_det: int = 300,
    device=None,
):
    """Decode an anchor-free YOLOv8/v11 head output into detections.

    ``raw`` is ``(1, 4+nc, N)`` or ``(4+nc, N)`` (also accepts the
    transposed ``(N, 4+nc)``): per anchor a ``(cx, cy, w, h)`` box in
    letterboxed-pixel coords followed by ``nc`` class scores (no
    objectness — v8+ heads). Returns ``(boxes_xyxy[N,4], scores[N],
    class_ids[N])`` after conf/class filtering and class-aware NMS, as
    numpy. Runs on ``raw``'s device where it is a tensor, else on
    ``device``.
    """
    p = _head_tensor(raw, device)
    if p.dim() == 3:
        p = p[0]
    if p.dim() != 2:
        raise ValueError(f"expected 2D/3D head output, got shape {tuple(raw.shape)}")
    # (4+nc, N) vs (N, 4+nc): anchors outnumber channels in any real head
    if p.shape[0] < p.shape[1]:
        p = p.T  # -> (N, 4+nc)
    xywh, cls = p[:, :4], p[:, 4:]
    cls_id = torch.argmax(cls, dim=1)  # the first maximum, as np.argmax
    score = torch.gather(cls, 1, cls_id[:, None])[:, 0]
    m = score >= conf
    if classes is not None:
        m &= torch.isin(cls_id, torch.as_tensor(list(classes), device=p.device))
    xywh, score, cls_id = xywh[m], score[m], cls_id[m]
    if len(score) == 0:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))
    half = xywh[:, 2:4] / 2.0
    boxes = torch.cat([xywh[:, :2] - half, xywh[:, :2] + half], dim=1)
    # class-aware NMS: offset boxes per class so cross-class pairs never
    # suppress each other (ultralytics' batched_nms trick)
    off = cls_id.to(torch.float32)[:, None] * (boxes.max() + 1.0)
    keep = _nms_t(boxes + off, score, iou_thresh)[:max_det]
    return (boxes[keep].cpu().numpy(), score[keep].cpu().numpy(),
            cls_id[keep].cpu().numpy())


def scale_boxes(boxes: np.ndarray, scale: float, pad) -> np.ndarray:
    """Map letterboxed-pixel xyxy boxes back to original image coords."""
    out = boxes.astype(np.float32).copy()
    out[:, [0, 2]] -= pad[0]
    out[:, [1, 3]] -= pad[1]
    return out / scale


# --------------------------------------------------------------------------
# detector + directory runner


class YoloDetector:
    """End-to-end detector: letterbox -> backend -> decode -> rescale.

    ``model`` is a callable ``(1,3,S,S) float32 -> raw head`` or a path to
    a TorchScript module, loaded onto ``device`` (``None``: ``cuda``, which
    raises without CUDA) and run there; the decode runs on the head
    output's device. Calling the detector on a BGR image returns
    ``(boxes_xyxy, scores, class_ids)`` in original-image pixel coords;
    ``boxes_only=True`` adapts it to ``images.anonymize_image``'s
    ``detector(image) -> boxes`` contract.
    """

    def __init__(self, model, imgsz: int = 640, conf: float = 0.25,
                 iou: float = 0.45, classes: Optional[Sequence[int]] = None,
                 device=None):
        self.device = resolve_device(device)
        if isinstance(model, (str, os.PathLike)):
            model = _torchscript_backend(model, self.device)
        self.model: Callable = model
        self.imgsz, self.conf, self.iou = imgsz, conf, iou
        self.classes = tuple(classes) if classes is not None else None

    def __call__(self, image_bgr: np.ndarray):
        padded, scale, pad = letterbox(image_bgr, self.imgsz)
        raw = self.model(to_chw(padded))
        boxes, scores, cls = decode_yolo(raw, self.conf, self.classes,
                                         self.iou, device=self.device)
        boxes = scale_boxes(boxes, scale, pad)
        h, w = image_bgr.shape[:2]
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        return boxes, scores, cls

    def boxes(self, image_bgr: np.ndarray) -> np.ndarray:
        return self(image_bgr)[0]


def _torchscript_backend(path, device: torch.device):
    """A TorchScript module loaded onto ``device``; it takes the numpy
    input and returns its head output as a tensor on ``device``."""
    mod = torch.jit.load(str(path), map_location=device).eval()

    def run(x: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            out = mod(torch.from_numpy(x).to(device))
        if isinstance(out, (tuple, list)):
            out = out[0]
        return out

    return run


def predict_directory(
    src_dir: str,
    out_dir: str,
    detector: YoloDetector,
    mode: str = "annotate",
    blur_ksize: int = 41,
    exts: Sequence[str] = (".jpg", ".jpeg", ".png", ".bmp"),
) -> dict:
    """The reference `predict.py` run: detect over every image in
    ``src_dir``, save results to ``out_dir`` (annotated boxes or, for PII
    use, blurred regions), plus a ``detections.json`` manifest. Returns
    the manifest dict."""
    _require_cv2()
    os.makedirs(out_dir, exist_ok=True)
    manifest = {}
    for name in sorted(os.listdir(src_dir)):
        if os.path.splitext(name)[1].lower() not in exts:
            continue
        img = cv2.imread(os.path.join(src_dir, name), cv2.IMREAD_COLOR)
        if img is None:
            continue
        boxes, scores, cls = detector(img)
        if mode == "blur":
            out = blur_regions(img, boxes, blur_ksize)
        else:
            out = img.copy()
            for (x0, y0, x1, y1), s, c in zip(boxes, scores, cls):
                cv2.rectangle(out, (int(x0), int(y0)), (int(x1), int(y1)),
                              (0, 0, 255), 2)
                cv2.putText(out, f"{int(c)}:{s:.2f}", (int(x0), int(y0) - 4),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 255), 1)
        cv2.imwrite(os.path.join(out_dir, name), out)
        manifest[name] = [
            {"box": [float(v) for v in b], "score": float(s),
             "class": int(c)}
            for b, s, c in zip(boxes, scores, cls)
        ]
    with open(os.path.join(out_dir, "detections.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
