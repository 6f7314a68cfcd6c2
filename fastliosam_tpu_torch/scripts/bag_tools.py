"""Rosbag utilities: extract / split / record-to-disk (port of
``scripts/bag_tools.py``: the reference's `extraction.py`, `split_bag.py`,
`split_rosbag_overlapping.py`, `split_ros2_bag.py`, `extract_*.py` family
in one CLI).

  python -m fastliosam_tpu_torch.scripts.bag_tools extract --bag run.bag --out rec/ \
      [--lidar-topic /points --imu-topic /imu --gps-topic /gps/fix]
  python -m fastliosam_tpu_torch.scripts.bag_tools split --bag run.bag \
      --out seg_{i}.bag --seconds 300 [--overlap 60]
  python -m fastliosam_tpu_torch.scripts.bag_tools split2 --bag run_db3_dir \
      --out part_{i}.db3 --seconds 300
  python -m fastliosam_tpu_torch.scripts.bag_tools info --bag run.bag

The same subcommands, flags and printed JSON as the JAX script; no device.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter


def cmd_info(args):
    from fastliosam_tpu_torch.io.rosbag import BagReader

    counts = Counter()
    t0, t1 = float("inf"), float("-inf")
    types = {}
    for msg in BagReader(args.bag):
        counts[msg.topic] += 1
        types[msg.topic] = msg.msg_type
        t0, t1 = min(t0, msg.stamp), max(t1, msg.stamp)
    print(json.dumps({
        "duration_s": round(t1 - t0, 3) if counts else 0,
        "topics": {t: {"count": c, "type": types[t]} for t, c in counts.items()},
    }, indent=2))


def cmd_extract(args):
    from fastliosam_tpu_torch.postprocess.images import CameraModel
    from fastliosam_tpu_torch.runtime.recorder import RecorderConfig, SensorRecorder

    cam = CameraModel.from_mrcal(args.camera_model) if args.camera_model else None
    rec = SensorRecorder(
        RecorderConfig(
            out_dir=args.out,
            cloud_format=args.cloud_format,
            image_topic=args.image_topic,
            lidar_topic=args.lidar_topic,
            imu_topic=args.imu_topic,
            gps_topic=args.gps_topic,
        ),
        camera=cam,
    )
    rec.consume_bag(args.bag)
    rec.close()
    print(json.dumps(rec.counts))


def cmd_split(args):
    from fastliosam_tpu_torch.io.rosbag import split_bag

    outs = split_bag(args.bag, args.out, args.seconds, args.overlap)
    print(json.dumps({"segments": outs}))


def cmd_split2(args):
    from fastliosam_tpu_torch.io.rosbag2 import split_bag2

    outs = split_bag2(args.bag, args.out, args.seconds)
    print(json.dumps({"segments": outs}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info")
    p.add_argument("--bag", required=True)

    p = sub.add_parser("extract")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--cloud-format", choices=["pcd", "bin"], default="pcd")
    p.add_argument("--lidar-topic", default="/points")
    p.add_argument("--imu-topic", default="/imu")
    p.add_argument("--gps-topic", default="/gps/fix")
    p.add_argument("--image-topic", default="/camera/compressed")
    p.add_argument("--camera-model", default=None)

    p = sub.add_parser("split")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True, help="pattern with {i}")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--overlap", type=float, default=0.0)

    p = sub.add_parser("split2")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True, help="pattern with {i}")
    p.add_argument("--seconds", type=float, required=True)

    args = ap.parse_args(argv)
    {"info": cmd_info, "extract": cmd_extract, "split": cmd_split,
     "split2": cmd_split2}[args.cmd](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
