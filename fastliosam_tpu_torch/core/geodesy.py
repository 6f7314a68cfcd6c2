"""Geodetic math: WGS84 <-> ECEF <-> local ENU, and Transverse Mercator
(port of ``fastliosam_tpu/core/geodesy.py``).

The JAX package runs this module in float32 (nothing enables x64), and
the port reproduces that computation op for op rather than improving on
it: ECEF coordinates near 6.4e6 m have a float32 spacing of 0.5 m, so an
ENU fix carries up to ~0.5 m of rounding, in both packages. Inputs may be
Python numbers, numpy arrays or tensors; every result is a float32 tensor
on the input's device (the CPU for numbers and arrays), batched over
leading dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# WGS84 ellipsoid
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared


def _f32(x, like=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _deg2rad(x):
    return x * np.float32(np.pi / 180.0)


def _rad2deg(x):
    return x * np.float32(180.0 / np.pi)


def geodetic_to_ecef(lat_deg, lon_deg, alt):
    """WGS84 geodetic (degrees, meters) -> ECEF xyz (meters)."""
    lat_deg = _f32(lat_deg)
    lat = _deg2rad(lat_deg)
    lon = _deg2rad(_f32(lon_deg, lat_deg))
    alt = _f32(alt, lat_deg)
    sin_lat, cos_lat = torch.sin(lat), torch.cos(lat)
    sin_lon, cos_lon = torch.sin(lon), torch.cos(lon)
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    x = (n + alt) * cos_lat * cos_lon
    y = (n + alt) * cos_lat * sin_lon
    z = (n * (1.0 - WGS84_E2) + alt) * sin_lat
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def ecef_to_geodetic(xyz):
    """ECEF -> WGS84 geodetic via Bowring's method (two fixed-point
    refinements). Returns ``(lat_deg, lon_deg, h)``."""
    xyz = _f32(xyz)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    theta = torch.atan2(z * WGS84_A, p * WGS84_B)
    ep2 = (WGS84_A * WGS84_A - WGS84_B * WGS84_B) / (WGS84_B * WGS84_B)
    lat = torch.atan2(
        z + ep2 * WGS84_B * torch.sin(theta) ** 3,
        p - WGS84_E2 * WGS84_A * torch.cos(theta) ** 3,
    )
    for _ in range(2):
        sin_lat = torch.sin(lat)
        n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
        h = p / torch.cos(lat) - n
        lat = torch.atan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sin_lat = torch.sin(lat)
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    h = p / torch.cos(lat) - n
    return _rad2deg(lat), _rad2deg(lon), h


class LocalCartesian(NamedTuple):
    """An ENU frame anchored at a geodetic origin (GeographicLib's
    ``LocalCartesian``): ``origin_ecef (3,)`` and the ECEF->ENU rotation
    ``rot (3, 3)``."""

    origin_ecef: torch.Tensor
    rot: torch.Tensor

    @staticmethod
    def from_origin(lat_deg, lon_deg, alt) -> "LocalCartesian":
        origin = geodetic_to_ecef(lat_deg, lon_deg, alt)
        lat = _deg2rad(_f32(lat_deg))
        lon = _deg2rad(_f32(lon_deg, lat))
        sl, cl = torch.sin(lat), torch.cos(lat)
        so, co = torch.sin(lon), torch.cos(lon)
        zero = torch.zeros_like(sl)
        rot = torch.stack([
            torch.stack([-so, co, zero]),
            torch.stack([-sl * co, -sl * so, cl]),
            torch.stack([cl * co, cl * so, sl]),
        ])
        return LocalCartesian(origin_ecef=origin, rot=rot)

    def forward(self, lat_deg, lon_deg, alt):
        """Geodetic -> local ENU xyz (GeographicLib ``Forward``)."""
        ecef = geodetic_to_ecef(lat_deg, lon_deg, alt)
        return torch.einsum("ij,...j->...i", self.rot, ecef - self.origin_ecef)

    def reverse(self, enu):
        """Local ENU xyz -> geodetic ``(lat, lon, alt)``."""
        ecef = torch.einsum("ji,...j->...i", self.rot, _f32(enu, self.rot)) + self.origin_ecef
        return ecef_to_geodetic(ecef)


# ---------------------------------------------------------------------------
# Transverse Mercator (Krüger series) — backs grid CRSs like HK1980.
# ---------------------------------------------------------------------------


def _tm_forward(lat_deg, lon_deg, lon0_deg, k0, a, f):
    """Ellipsoidal Transverse Mercator forward projection (6th-order
    Krüger). Returns (easting from the central meridian, northing from the
    equator)."""
    n = f / (2.0 - f)
    n2, n3 = n * n, n * n * n
    A = a / (1.0 + n) * (1.0 + n2 / 4.0 + n2 * n2 / 64.0)
    alpha = [
        n / 2.0 - 2.0 * n2 / 3.0 + 5.0 * n3 / 16.0,
        13.0 * n2 / 48.0 - 3.0 * n3 / 5.0,
        61.0 * n3 / 240.0,
    ]
    lat_deg = _f32(lat_deg)
    lat = _deg2rad(lat_deg)
    dlon = _deg2rad(_f32(lon_deg, lat_deg) - lon0_deg)
    # a float32 sqrt of the float32-rounded argument, as jnp.sqrt does
    e = torch.sqrt(_f32(f * (2.0 - f), lat_deg))
    t = torch.sinh(torch.atanh(torch.sin(lat)) - e * torch.atanh(e * torch.sin(lat)))
    xi = torch.atan2(t, torch.cos(dlon))
    eta = torch.atanh(torch.sin(dlon) / torch.sqrt(1.0 + t * t))
    x = eta
    y = xi
    for j, aj in enumerate(alpha, start=1):
        x = x + aj * torch.cos(2.0 * j * xi) * torch.sinh(2.0 * j * eta)
        y = y + aj * torch.sin(2.0 * j * xi) * torch.cosh(2.0 * j * eta)
    return k0 * A * x, k0 * A * y


class TransverseMercatorCRS(NamedTuple):
    """A projected CRS: TM projection + false origin on an ellipsoid."""

    lat0_deg: float
    lon0_deg: float
    k0: float
    false_easting: float
    false_northing: float
    a: float
    f: float

    def forward(self, lat_deg, lon_deg):
        """Geodetic (on this CRS's ellipsoid datum) -> (easting, northing)."""
        x, y = _tm_forward(lat_deg, lon_deg, self.lon0_deg, self.k0, self.a, self.f)
        _, y0 = _tm_forward(_f32(self.lat0_deg, x), _f32(self.lon0_deg, x),
                            self.lon0_deg, self.k0, self.a, self.f)
        return x + self.false_easting, y - y0 + self.false_northing


# HK1980 grid (EPSG:2326) on the International 1924 (Hayford) ellipsoid; a
# full EPSG:4326 -> 2326 conversion also needs the WGS84 -> HK1980 datum
# shift (EPSG:1825), applied in wgs84_to_hk1980 below.
INTL1924_A = 6378388.0
INTL1924_F = 1.0 / 297.0
HK1980 = TransverseMercatorCRS(
    lat0_deg=22.0 + 18.0 / 60.0 + 43.68 / 3600.0,
    lon0_deg=114.0 + 10.0 / 60.0 + 42.80 / 3600.0,
    k0=1.0,
    false_easting=836694.05,
    false_northing=819069.80,
    a=INTL1924_A,
    f=INTL1924_F,
)

_HK1980_SHIFT = (-162.619, -276.959, -161.764)


def wgs84_to_hk1980(lat_deg, lon_deg, alt=0.0):
    """WGS84 geodetic -> HK1980 grid (EPSG:4326 -> EPSG:2326): the
    3-parameter geocentric datum shift, then the HK1980 TM grid. Returns
    ``(easting, northing)``."""
    ecef = geodetic_to_ecef(lat_deg, lon_deg, alt)
    ecef = ecef + _f32(_HK1980_SHIFT, ecef)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    e2 = INTL1924_F * (2.0 - INTL1924_F)
    b = INTL1924_A * (1.0 - INTL1924_F)
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    theta = torch.atan2(z * INTL1924_A, p * b)
    ep2 = (INTL1924_A**2 - b**2) / (b**2)
    lat = torch.atan2(
        z + ep2 * b * torch.sin(theta) ** 3, p - e2 * INTL1924_A * torch.cos(theta) ** 3
    )
    for _ in range(2):
        sin_lat = torch.sin(lat)
        nrad = INTL1924_A / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
        h = p / torch.cos(lat) - nrad
        lat = torch.atan2(z, p * (1.0 - e2 * nrad / (nrad + h)))
    return HK1980.forward(_rad2deg(lat), _rad2deg(lon))
