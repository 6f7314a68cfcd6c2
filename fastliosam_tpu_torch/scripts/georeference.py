"""Georeference a SLAM trajectory (and optionally the map PCD) against GPS
(port of ``scripts/georeference.py``).

The `geo_ref_slam_wgs84.py` / `georeference_pcd.py` workflow:

  python -m fastliosam_tpu_torch.scripts.georeference --traj out/run/seq_tum.txt \
      --gps gnss.txt --out out/georef [--pcd out/run/seq_map.pcd] [--mapmatch roads.json] \
      [--device cpu]

`--gps` accepts the recorder's gnss.txt (stamp lat lon alt [cov...]).
Outputs: WGS84 trajectory csv, alignment params json, error report,
Leaflet HTML map, optionally the georeferenced PCD. The geodesy, the
similarity fit and the map matching run on ``--device`` (the card by
default).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traj", required=True, help="TUM trajectory file")
    ap.add_argument("--gps", required=True, help="gnss.txt (stamp lat lon alt ...)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--pcd", default=None, help="map PCD to georeference")
    ap.add_argument("--tol", type=float, default=0.5, help="timestamp match tol (s)")
    ap.add_argument("--mapmatch", default=None,
                    help="JSON file with road polylines [[x,y],...] lists (ENU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from fastliosam_tpu_torch.io import read_tum_trajectory
    from fastliosam_tpu_torch.postprocess import save_alignment_params
    from fastliosam_tpu_torch.postprocess.georef import georeference_trajectory
    from fastliosam_tpu_torch.postprocess.plots import write_html_map
    from fastliosam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    stamps, poses = read_tum_trajectory(args.traj)
    gps = np.loadtxt(args.gps, ndmin=2)
    lat, lon, sim, report = georeference_trajectory(
        stamps, poses[:, :3, 3], gps[:, 0], gps[:, 1], gps[:, 2],
        gps[:, 3] if gps.shape[1] > 3 else None, tol=args.tol, device=device,
    )
    print(json.dumps(report))

    np.savetxt(
        os.path.join(args.out, "trajectory_wgs84.csv"),
        np.column_stack([stamps, lat, lon]),
        header="stamp,lat,lon", delimiter=",", comments="",
    )
    save_alignment_params(
        os.path.join(args.out, "alignment_params.json"), sim, extra=report
    )
    write_html_map(lat, lon, os.path.join(args.out, "map.html"),
                   gps_lat=gps[:, 1], gps_lon=gps[:, 2])

    if args.pcd:
        from fastliosam_tpu_torch.postprocess.georef import georeference_pcd

        out_pcd = os.path.join(args.out, "map_georef.pcd")
        georeference_pcd(args.pcd, out_pcd, sim)
        print(f"georeferenced map -> {out_pcd}")

    if args.mapmatch:
        from fastliosam_tpu_torch.postprocess.mapmatch import (
            RoadNetwork, match_trajectory, route_length,
        )

        with open(args.mapmatch) as f:
            roads = json.load(f)
        net = RoadNetwork(edges=[np.asarray(e) for e in roads])
        enu_xy = sim.apply(poses[:, :2, 3])
        edge_idx, snapped, matched = match_trajectory(enu_xy, net, device=device)
        np.savetxt(
            os.path.join(args.out, "matched_route.csv"),
            np.column_stack([stamps, snapped, edge_idx]),
            header="stamp,x,y,edge", delimiter=",", comments="",
        )
        print(json.dumps({
            "matched_fraction": float(matched.mean()),
            "route_length_m": route_length(snapped[matched]),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
