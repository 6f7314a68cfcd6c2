"""Trajectory / GPS plotting and HTML map export (host copy of
``fastliosam_tpu/postprocess/plots.py``).

Capability ports of `plot_trajectory.py`, `plot_gps_trajectory.py` and the
folium HTML maps of `geo_ref_slam_wgs84.py:246-328` (folium is not a
dependency, so the HTML map is emitted as a self-contained Leaflet page).
"""
from __future__ import annotations

import json

import numpy as np


def plot_trajectory(positions, out_path: str, title="trajectory",
                    gps_positions=None):
    """2D top-down + z-profile plot of a trajectory (and optional GPS)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = np.asarray(positions)
    fig, (ax1, ax2) = plt.subplots(
        1, 2, figsize=(12, 5), gridspec_kw={"width_ratios": [2, 1]}
    )
    ax1.plot(p[:, 0], p[:, 1], "b-", lw=1, label="trajectory")
    ax1.plot(p[0, 0], p[0, 1], "go", label="start")
    ax1.plot(p[-1, 0], p[-1, 1], "rs", label="end")
    if gps_positions is not None:
        g = np.asarray(gps_positions)
        ax1.scatter(g[:, 0], g[:, 1], c="orange", s=8, label="GPS")
    ax1.set_aspect("equal")
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax1.legend()
    ax1.set_title(title)
    ax2.plot(p[:, 2], "b-", lw=1)
    ax2.set_xlabel("frame")
    ax2.set_ylabel("z [m]")
    ax2.set_title("elevation")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_trajectory_3d(positions, out_path: str, title="trajectory 3d"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = np.asarray(positions)
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    ax.plot(p[:, 0], p[:, 1], p[:, 2], lw=1)
    ax.set_title(title)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


_LEAFLET_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"/>
<link rel="stylesheet" href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>#map {{ height: 100vh; }}</style></head>
<body><div id="map"></div><script>
var coords = {coords};
var gps = {gps};
var map = L.map('map').setView(coords.length ? coords[0] : [0, 0], 17);
L.tileLayer('https://{{s}}.tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
            {{maxZoom: 19}}).addTo(map);
if (coords.length) L.polyline(coords, {{color: 'blue', weight: 3}}).addTo(map);
gps.forEach(function(c) {{
  L.circleMarker(c, {{radius: 3, color: 'orange'}}).addTo(map);
}});
</script></body></html>
"""


def write_html_map(lat, lon, out_path: str, gps_lat=None, gps_lon=None):
    """Write a Leaflet HTML map of the georeferenced trajectory (folium
    map capability of the reference's georeferencing scripts)."""
    coords = [[float(a), float(b)] for a, b in zip(lat, lon)]
    gps = (
        [[float(a), float(b)] for a, b in zip(gps_lat, gps_lon)]
        if gps_lat is not None
        else []
    )
    with open(out_path, "w") as f:
        f.write(_LEAFLET_PAGE.format(coords=json.dumps(coords), gps=json.dumps(gps)))
    return out_path
