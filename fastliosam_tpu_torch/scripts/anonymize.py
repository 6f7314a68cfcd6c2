"""PII detection / anonymization over a directory of rectified images —
the reference `post_process/predict.py` entry point (ultralytics YOLOv11x,
conf=0.01, classes=[0,1], save to project/name); port of
``scripts/anonymize.py``. Weights are supplied as a TorchScript module,
run on ``--device`` (the card by default); the pipeline (letterbox, decode,
NMS, blur/annotate) is ``fastliosam_tpu_torch.postprocess.detect``.

Example:
  python -m fastliosam_tpu_torch.scripts.anonymize --source rectified_image/ \
      --project yolo_results --name predict_run \
      --model best.torchscript --conf 0.01 --classes 0 1 --mode blur
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", required=True, help="input image directory")
    ap.add_argument("--project", default="yolo_results")
    ap.add_argument("--name", default="predict_run")
    ap.add_argument("--model", required=True,
                    help="TorchScript detector")
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--classes", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--mode", choices=("annotate", "blur"),
                    default="annotate")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from fastliosam_tpu_torch.postprocess.detect import (YoloDetector,
                                                         predict_directory)

    det = YoloDetector(args.model, imgsz=args.imgsz, conf=args.conf,
                       iou=args.iou, classes=args.classes or None,
                       device=args.device)
    out_dir = os.path.join(args.project, args.name)
    manifest = predict_directory(args.source, out_dir, det, mode=args.mode)
    n = sum(len(v) for v in manifest.values())
    print(f"{len(manifest)} images -> {out_dir} ({n} detections)")


if __name__ == "__main__":
    main()
