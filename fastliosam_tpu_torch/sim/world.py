"""Synthetic LiDAR-inertial world simulator (test fixture + benchmark feed).

The reference has no tests (SURVEY.md §4) — its validation is dataset replay.
With no datasets in this environment, this simulator generates a physically
consistent sequence from an analytic trajectory through a plane world:

  * LiDAR scans by ray-casting a spinning multi-beam sensor against
    rectangles, **from the sensor pose at each point's own timestamp** (so
    real motion distortion exists and deskew is actually exercised);
  * IMU samples (gyro/accel with bias + noise) derived from the analytic
    trajectory via finite differences in float64;
  * GPS fixes (position + noise, optional geodetic output via an ENU anchor).

Everything is numpy/host-side: fixtures must be framework-independent so the
engine under test can't share bugs with its ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class PlaneWorld:
    """A set of finite rectangles: center (K,3), two in-plane half-axes
    u,v (K,3) (length = half extent), normal derived = u×v normalized."""

    centers: np.ndarray
    us: np.ndarray
    vs: np.ndarray

    @property
    def normals(self):
        n = np.cross(self.us, self.vs)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    @staticmethod
    def room(size=40.0, height=8.0, n_boxes=12, seed=0) -> "PlaneWorld":
        """A closed room with floor, ceiling, 4 walls and random interior
        boxes — plane-rich, loop-friendly geometry."""
        rng = np.random.default_rng(seed)
        s, h = size / 2.0, height
        C, U, V = [], [], []

        def rect(center, u, v):
            C.append(center)
            U.append(u)
            V.append(v)

        # floor + ceiling
        rect([0, 0, 0], [s, 0, 0], [0, s, 0])
        rect([0, 0, h], [s, 0, 0], [0, -s, 0])
        # walls
        rect([s, 0, h / 2], [0, s, 0], [0, 0, h / 2])
        rect([-s, 0, h / 2], [0, -s, 0], [0, 0, h / 2])
        rect([0, s, h / 2], [-s, 0, 0], [0, 0, h / 2])
        rect([0, -s, h / 2], [s, 0, 0], [0, 0, h / 2])
        # interior boxes (4 side faces + top each)
        for _ in range(n_boxes):
            bx, by = rng.uniform(-s * 0.7, s * 0.7, size=2)
            # keep an annular corridor free for circular trajectories
            # (Trajectory.circle default radius ~8 m)
            if 4.5 < np.hypot(bx, by) < 11.5:
                continue
            w, d, bh = rng.uniform(0.8, 2.5, size=3)
            bh = min(bh + 0.5, h - 1)
            yaw = rng.uniform(0, np.pi)
            ca, sa = np.cos(yaw), np.sin(yaw)
            ux = np.array([ca, sa, 0.0])
            uy = np.array([-sa, ca, 0.0])
            rect([bx + ux[0] * w, by + ux[1] * w, bh / 2], uy * d, [0, 0, bh / 2])
            rect([bx - ux[0] * w, by - ux[1] * w, bh / 2], -uy * d, [0, 0, bh / 2])
            rect([bx + uy[0] * d, by + uy[1] * d, bh / 2], -ux * w, [0, 0, bh / 2])
            rect([bx - uy[0] * d, by - uy[1] * d, bh / 2], ux * w, [0, 0, bh / 2])
            rect([bx, by, bh], ux * w, uy * d)
        return PlaneWorld(
            centers=np.asarray(C, np.float64),
            us=np.asarray(U, np.float64),
            vs=np.asarray(V, np.float64),
        )

    @staticmethod
    def corridor(length=240.0, width=8.0, height=5.0, n_clutter=6,
                 clutter_span=20.0, seed=0) -> "PlaneWorld":
        """A long straight corridor along +x: floor, ceiling, two side
        walls, and a few clutter boxes only near the start (x <
        ``clutter_span``). Beyond the clutter the geometry is translation-
        degenerate along x — every visible plane normal is ⊥ x̂ — so LiDAR
        matching cannot observe forward motion and odometry must drift.
        This is the degenerate-geometry eval feed (SURVEY §7 hard-part 7)
        and the honest GPS-fusion demo: GPS factors are the only absolute
        x information (`add_gps_factor`, fast_lio_sam.cpp:177-260)."""
        rng = np.random.default_rng(seed)
        hw = width / 2.0
        C, U, V = [], [], []

        def rect(center, u, v):
            C.append(center)
            U.append(u)
            V.append(v)

        hx = length / 2.0
        cx = length / 2.0 - 10.0  # corridor from -10 to length-10
        # floor + ceiling
        rect([cx, 0, 0], [hx, 0, 0], [0, hw, 0])
        rect([cx, 0, height], [hx, 0, 0], [0, -hw, 0])
        # side walls (featureless, normals = ±ŷ)
        rect([cx, hw, height / 2], [-hx, 0, 0], [0, 0, height / 2])
        rect([cx, -hw, height / 2], [hx, 0, 0], [0, 0, height / 2])
        # far end cap (normals = -x̂) — beyond max_range for most of the run
        rect([length - 10.0, 0, height / 2], [0, hw, 0], [0, 0, height / 2])
        # clutter boxes near the start only
        for _ in range(n_clutter):
            bx = rng.uniform(0.0, clutter_span)
            by = rng.uniform(-hw * 0.7, hw * 0.7)
            w, d, bh = rng.uniform(0.4, 1.2, size=3)
            bh = min(bh + 0.3, height - 1)
            ux = np.array([1.0, 0.0, 0.0])
            uy = np.array([0.0, 1.0, 0.0])
            rect([bx + w, by, bh / 2], uy * d, [0, 0, bh / 2])
            rect([bx - w, by, bh / 2], -uy * d, [0, 0, bh / 2])
            rect([bx, by + d, bh / 2], -ux * w, [0, 0, bh / 2])
            rect([bx, by - d, bh / 2], ux * w, [0, 0, bh / 2])
            rect([bx, by, bh], ux * w, uy * d)
        return PlaneWorld(
            centers=np.asarray(C, np.float64),
            us=np.asarray(U, np.float64),
            vs=np.asarray(V, np.float64),
        )

    @staticmethod
    def city(a=60.0, b=60.0, street_w=12.0, wall_h=8.0, n_clutter=24,
             seed=0, rich=False) -> "PlaneWorld":
        """Urban canyon: a rectangular street circuit (centerline half-
        extents ``a`` × ``b``) between an inner city block and outer
        buildings. Three streets carry clutter (parked-car boxes) and gappy
        outer facades (loop-closure texture); the +x street is a featureless
        canyon — both walls flat and parallel — so it is translation-
        degenerate along y while mid-street (corners out of range). Pairs
        with :meth:`Trajectory.circuit` for the long-run KITTI-format eval
        (VERDICT r2 #6: multi-loop, corridor segment, yaw-rate spikes).

        ``rich=True`` removes the self-similarity: the +x street gets the
        same gappy discrete facades as the other three and clutter lands on
        all four streets — the feature-rich variant where loop ICP is well-
        conditioned everywhere (the oracle world for validating the
        reference-spec 35 m loop radius, VERDICT r4 #4b)."""
        rng = np.random.default_rng(seed)
        C, U, V = [], [], []

        def rect(center, u, v):
            C.append(center)
            U.append(u)
            V.append(v)

        def box(cx, cy, hw, hd, h):
            ux = np.array([1.0, 0.0, 0.0])
            uy = np.array([0.0, 1.0, 0.0])
            rect([cx + hw, cy, h / 2], uy * hd, [0, 0, h / 2])
            rect([cx - hw, cy, h / 2], -uy * hd, [0, 0, h / 2])
            rect([cx, cy + hd, h / 2], -ux * hw, [0, 0, h / 2])
            rect([cx, cy - hd, h / 2], ux * hw, [0, 0, h / 2])
            rect([cx, cy, h], ux * hw, uy * hd)

        g = a + street_w + 30.0
        rect([0, 0, 0], [g, 0, 0], [0, g, 0])  # ground
        hw = street_w / 2.0
        ia, ib = a - hw, b - hw  # inner block walls
        # inner block: 4 walls + roof
        box(0.0, 0.0, ia, ib, wall_h)
        oa, ob = a + hw, b + hw
        if not rich:
            # outer facade, +x street: one solid featureless wall (canyon)
            rect([oa, 0, wall_h / 2], [0, -ob, 0], [0, 0, wall_h / 2])
        # outer facades elsewhere: discrete buildings with gaps (texture)
        n_seg = 6
        for s_ in range(n_seg):
            frac0 = s_ / n_seg + 0.02
            frac1 = (s_ + 1) / n_seg - 0.06
            mid = (frac0 + frac1) / 2
            half = (frac1 - frac0) / 2
            h = float(rng.uniform(5.0, 12.0))
            # rich: per-segment lateral setback breaks the translational
            # self-similarity of a straight facade line — building fronts
            # at varying depths make every street position geometrically
            # unique, so loop ICP has a true global basin
            sb = float(rng.uniform(0.0, 3.0)) if rich else 0.0
            # -x street
            rect([-oa - sb, (mid * 2 - 1) * ob, h / 2],
                 [0, half * 2 * ob, 0], [0, 0, h / 2])
            # +y street
            rect([(mid * 2 - 1) * oa, ob + sb, h / 2],
                 [-half * 2 * oa, 0, 0], [0, 0, h / 2])
            # -y street
            rect([(mid * 2 - 1) * oa, -ob - sb, h / 2],
                 [half * 2 * oa, 0, 0], [0, 0, h / 2])
            if rich:  # +x street facades (rich variant only)
                h2 = float(rng.uniform(5.0, 12.0))
                sb2 = float(rng.uniform(0.0, 3.0))
                rect([oa + sb2, (mid * 2 - 1) * ob, h2 / 2],
                     [0, -half * 2 * ob, 0], [0, 0, h2 / 2])
        # clutter (parked cars) on the textured streets (all four if rich)
        for _ in range(n_clutter):
            street = rng.integers(0, 4 if rich else 3)
            along = rng.uniform(-0.8, 0.8)
            side = rng.choice([-1.0, 1.0])
            lat = side * (hw - 1.5)
            if street == 0:  # -x street
                cx, cy = -a - lat, along * ib
            elif street == 1:  # +y street
                cx, cy = along * ia, b + lat
            elif street == 2:  # -y street
                cx, cy = along * ia, -b - lat
            else:  # +x street (rich only)
                cx, cy = a + lat, along * ib
            box(cx, cy, float(rng.uniform(0.8, 1.2)),
                float(rng.uniform(1.8, 2.4)), float(rng.uniform(1.2, 1.8)))
        return PlaneWorld(
            centers=np.asarray(C, np.float64),
            us=np.asarray(U, np.float64),
            vs=np.asarray(V, np.float64),
        )

    def raycast(self, origins, dirs, max_range=100.0):
        """Batch ray cast. origins/dirs (N,3) -> (points (N,3), hit (N,)).

        Rays that share one origin (a time group of :func:`simulate_sequence`)
        are cast only against the rectangles that some ray of the group can
        reach (:meth:`_reachable`); every other rectangle gives every ray
        ``t = inf``, so the nearest hit, and each output bit, is that of the
        dense cast over all rectangles."""
        n = self.normals  # (K,3)
        c = self.centers
        us, vs = self.us, self.vs
        keep = self._reachable(origins, dirs)
        if keep is not None:
            n, c, us, vs = n[keep], c[keep], us[keep], vs[keep]
        if len(c) == 0:
            tmin = np.full(len(dirs), np.inf)
        else:
            # t per (ray, plane): n·(o + t d - c) = 0
            denom = dirs @ n.T  # (N,K)
            num = np.einsum("kj,nkj->nk", n, c[None] - origins[:, None])
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            t = np.where(np.abs(denom) > 1e-9, t, np.inf)
            t = np.where(t > 1e-6, t, np.inf)
            t_safe = np.where(np.isfinite(t), t, 0.0)
            hit_pts = origins[:, None] + t_safe[..., None] * dirs[:, None]  # (N,K,3)
            rel = hit_pts - c[None]
            ulen2 = np.sum(us * us, axis=-1)  # (K,)
            vlen2 = np.sum(vs * vs, axis=-1)
            uu = np.einsum("nkj,kj->nk", rel, us) / ulen2
            vv = np.einsum("nkj,kj->nk", rel, vs) / vlen2
            inside = (np.abs(uu) <= 1.0) & (np.abs(vv) <= 1.0)
            t = np.where(inside, t, np.inf)
            tmin = t.min(axis=1)
        hit = np.isfinite(tmin) & (tmin < max_range)
        pts = origins + np.where(hit, tmin, 0.0)[:, None] * dirs
        return pts, hit

    def _reachable(self, origins, dirs, margin=1e-3):
        """Indices of the rectangles that a ray of ``dirs`` from the shared
        origin may hit, or None (every rectangle) when the origins differ.

        A rectangle with perpendicular half-axes u, v lies in the ball of
        radius |u| + |v| around its centre c, so a ray from o that hits it
        leaves the direction w = c - o by at most asin((|u| + |v|) / |w|).
        The group's directions lie within an angle θ of their mean a, so a
        rectangle whose w leaves a by more than θ + that angle (+ ``margin``
        radians, far above the rounding of the dense test) is hit by no ray.
        Rectangles around the origin and skewed ones are always kept."""
        o = origins[0]
        if not np.array_equal(origins, np.broadcast_to(o, origins.shape)):
            return None
        s = dirs.sum(axis=0)
        s_norm = np.linalg.norm(s)
        if s_norm == 0.0:
            return None
        a = s / s_norm
        cos_dirs = (dirs @ a) / np.linalg.norm(dirs, axis=-1)
        theta = np.arccos(np.clip(cos_dirs.min(), -1.0, 1.0))
        w = self.centers - o
        dist = np.linalg.norm(w, axis=-1)
        ul = np.linalg.norm(self.us, axis=-1)
        vl = np.linalg.norm(self.vs, axis=-1)
        r = ul + vl
        perp = np.abs(np.sum(self.us * self.vs, axis=-1)) <= 1e-9 * ul * vl
        far = dist > r * 1.001 + 1e-6
        safe = np.maximum(dist, 1e-300)
        off_axis = np.arccos(np.clip((w @ a) / safe, -1.0, 1.0))
        half = np.arcsin(np.clip(r / safe, 0.0, 1.0))
        unreachable = perp & far & (off_axis > theta + half + margin)
        return np.flatnonzero(~unreachable)


@dataclass
class Trajectory:
    """Analytic trajectory t -> (R (3,3), p (3,)), with derivatives via
    float64 central differences."""

    pose_fn: Callable[[float], tuple]

    @staticmethod
    def circle(radius=10.0, period=40.0, z_amp=0.5, pitch_amp=0.05) -> "Trajectory":
        w = 2 * np.pi / period

        def pose(t):
            a = w * t
            p = np.array(
                [radius * np.cos(a), radius * np.sin(a), 1.5 + z_amp * np.sin(2 * a)]
            )
            yaw = a + np.pi / 2  # facing the tangent
            pitch = pitch_amp * np.sin(3 * a)
            cy, sy = np.cos(yaw), np.sin(yaw)
            cp, sp = np.cos(pitch), np.sin(pitch)
            Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
            Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            return Rz @ Ry, p

        return Trajectory(pose_fn=pose)

    @staticmethod
    def figure8(scale=10.0, period=60.0, z_amp=0.3) -> "Trajectory":
        """Lemniscate of Gerono: the path self-intersects at the origin
        twice per period, so a multi-lap sequence produces genuine loop
        closures with crossing headings (the adversarial PGO feed)."""
        w = 2 * np.pi / period

        def pose(t):
            a = w * t
            p = np.array(
                [
                    scale * np.sin(a),
                    0.5 * scale * np.sin(2 * a),
                    1.5 + z_amp * np.sin(3 * a),
                ]
            )
            # heading along the tangent
            dx = scale * w * np.cos(a)
            dy = scale * w * np.cos(2 * a)
            yaw = np.arctan2(dy, dx)
            cy, sy = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
            return Rz, p

        return Trajectory(pose_fn=pose)

    @staticmethod
    def circuit(a=60.0, b=60.0, corner_r=10.0, speed=8.0, z=1.7,
                z_amp=0.05, z_period=5.0, ramp_t=0.0,
                s_start=0.0) -> "Trajectory":
        """Arc-length-parametric rounded-rectangle street circuit (CCW),
        yaw along the tangent. Straights are constant-yaw; corners are
        yaw-rate spikes (v/r ≈ 0.8 rad/s at the defaults). Loops close
        every lap. Pairs with :meth:`PlaneWorld.city`.

        ``ramp_t > 0`` starts from rest and accelerates linearly to
        ``speed`` over that many seconds (C¹ arc length — real drives, and
        real KITTI sequences, start from rest; a zero-velocity filter init
        is only fair against a from-rest feed). ``s_start`` offsets the
        start position along the circuit (meters of arc length) — e.g. to
        begin on a textured street instead of inside the featureless
        +x canyon segment."""
        r = corner_r
        Lx, Ly = 2 * (a - r), 2 * (b - r)
        Q = np.pi * r / 2.0
        P = 2 * Lx + 2 * Ly + 4 * Q
        # segment starts (CCW from (a, -(b-r))): right straight, TR corner,
        # top straight, TL corner, left straight, BL corner, bottom, BR
        s0 = np.cumsum([0, Ly, Q, Lx, Q, Ly, Q, Lx])
        wz = 2 * np.pi / z_period

        def dist(t):
            if ramp_t <= 0.0:
                return speed * t
            if t < ramp_t:
                return 0.5 * speed * t * t / ramp_t
            return speed * (t - 0.5 * ramp_t)

        def pose(t):
            s = (s_start + dist(t)) % P
            if s < s0[1]:  # right street, heading +y
                x, y, yaw = a, -(b - r) + s, np.pi / 2
            elif s < s0[2]:
                u = (s - s0[1]) / r
                x = (a - r) + r * np.cos(u)
                y = (b - r) + r * np.sin(u)
                yaw = np.pi / 2 + u
            elif s < s0[3]:  # top street, heading -x
                x, y, yaw = (a - r) - (s - s0[2]), b, np.pi
            elif s < s0[4]:
                u = (s - s0[3]) / r
                x = -(a - r) - r * np.sin(u)
                y = (b - r) + r * np.cos(u)
                yaw = np.pi + u
            elif s < s0[5]:  # left street, heading -y
                x, y, yaw = -a, (b - r) - (s - s0[4]), -np.pi / 2
            elif s < s0[6]:
                u = (s - s0[5]) / r
                x = -(a - r) - r * np.cos(u)
                y = -(b - r) - r * np.sin(u)
                yaw = -np.pi / 2 + u
            elif s < s0[7]:  # bottom street, heading +x
                x, y, yaw = -(a - r) + (s - s0[6]), -b, 0.0
            else:
                u = (s - s0[7]) / r
                x = (a - r) + r * np.sin(u)
                y = -(b - r) - r * np.cos(u)
                yaw = u
            p = np.array([x, y, z + z_amp * np.sin(wz * t)])
            cy, sy = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
            return Rz, p

        return Trajectory(pose_fn=pose)

    @staticmethod
    def straight(speed=6.0, z=1.5, yaw_amp=0.03, yaw_period=4.0,
                 z_amp=0.05) -> "Trajectory":
        """Constant-speed straight line along +x with a gentle yaw/heave
        wiggle (keeps deskew + gyro paths non-trivial). Pairs with
        :meth:`PlaneWorld.corridor` for the degeneracy eval."""
        wy = 2 * np.pi / yaw_period

        def pose(t):
            p = np.array([speed * t, 0.0, z + z_amp * np.sin(wy * t)])
            yaw = yaw_amp * np.sin(wy * t)
            cy, sy = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
            return Rz, p

        return Trajectory(pose_fn=pose)

    def pose(self, t):
        return self.pose_fn(t)

    def velocity(self, t, eps=1e-4):
        _, p0 = self.pose_fn(t - eps)
        _, p1 = self.pose_fn(t + eps)
        return (p1 - p0) / (2 * eps)

    def acceleration(self, t, eps=1e-3):
        _, p0 = self.pose_fn(t - eps)
        _, pc = self.pose_fn(t)
        _, p1 = self.pose_fn(t + eps)
        return (p1 - 2 * pc + p0) / (eps * eps)

    def angular_velocity(self, t, eps=1e-4):
        """Body-frame angular velocity from R via central difference."""
        R0, _ = self.pose_fn(t - eps)
        R1, _ = self.pose_fn(t + eps)
        Rc, _ = self.pose_fn(t)
        dR = (R1 - R0) / (2 * eps)
        W = Rc.T @ dR  # skew(w_body)
        return np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]]) * 0.5


@dataclass
class SimConfig:
    scan_rate: float = 10.0  # Hz (reference `kitti.yaml: scan_rate: 10`)
    imu_rate: float = 200.0
    n_azimuth: int = 512
    n_elev: int = 16
    elev_fov: tuple = (-0.3, 0.15)  # radians
    max_range: float = 80.0
    gyro_noise: float = 0.002
    acc_noise: float = 0.02
    gyro_bias: tuple = (0.002, -0.001, 0.0015)
    acc_bias: tuple = (0.02, -0.01, 0.015)
    gravity: float = 9.81
    gps_rate: float = 1.0
    gps_noise: float = 0.5
    lidar_R: np.ndarray = field(default_factory=lambda: np.eye(3))
    lidar_t: np.ndarray = field(default_factory=lambda: np.zeros(3))
    seed: int = 0
    # quantize per-point capture times to this many groups per sweep (fewer
    # pose evaluations during generation; None = exact per-azimuth-column)
    time_groups: int | None = None
    # scan pattern: "spinning" (Velodyne/Ouster-like rings) or "livox"
    # (Avia-like non-repetitive rosette in a forward cone — stresses
    # irregular point density, BASELINE.md eval config #4)
    pattern: str = "spinning"
    livox_fov: float = 1.22  # ~70 deg full cone
    livox_n_points: int = 8192


def _ray_dirs_livox(cfg: SimConfig):
    """Non-repetitive rosette pattern in a forward (+x) cone, Avia-like:
    the beam sweeps a Lissajous-style rose whose frequencies are
    incommensurate, so consecutive sweeps never repeat."""
    n = cfg.livox_n_points
    i = np.arange(n)
    t_frac = i / n
    half = cfg.livox_fov / 2.0
    # incommensurate petal frequencies + golden-angle phase drift
    a1 = 2 * np.pi * 1817.0 * t_frac
    a2 = 2 * np.pi * 2017.0 * t_frac + 2.39996 * i / n
    u = half * np.cos(a1) * np.abs(np.sin(a2)) ** 0.5
    v = half * np.sin(a1) * np.abs(np.cos(a2)) ** 0.5
    d = np.stack(
        [np.cos(u) * np.cos(v), np.sin(u) * np.cos(v), np.sin(v)], axis=-1
    )
    return d, t_frac


def _ray_dirs(cfg: SimConfig):
    if cfg.pattern == "livox":
        return _ray_dirs_livox(cfg)
    az = np.linspace(0, 2 * np.pi, cfg.n_azimuth, endpoint=False)
    el = np.linspace(cfg.elev_fov[0], cfg.elev_fov[1], cfg.n_elev)
    azg, elg = np.meshgrid(az, el, indexing="ij")  # (A, E)
    d = np.stack(
        [
            np.cos(elg) * np.cos(azg),
            np.cos(elg) * np.sin(azg),
            np.sin(elg),
        ],
        axis=-1,
    ).reshape(-1, 3)
    # Sweep timing follows the real Velodyne convention — CLOCKWISE (viewed
    # from above) starting at -x — the same model `io/kitti.py`
    # `_azimuth_time_offsets` uses to reconstruct per-point times from
    # KITTI bins (which carry none). A synthetic written to KITTI format
    # and read back through that reconstruction must agree with it, or the
    # deskew runs time-reversed and odometry drifts backward (found via
    # the r3 KITTI long-run divergence).
    t_frac = ((np.pi - azg) % (2 * np.pi) / (2 * np.pi)).reshape(-1)
    return d, t_frac


def simulate_sequence(
    world: PlaneWorld, traj: Trajectory, cfg: SimConfig, n_scans: int, t0: float = 0.0
):
    """Generate a full sequence.

    Returns a dict with lists per scan:
      scans:      (pts_lidar (N,3) f32, t_offset (N,) f32, mask (N,))
      imu:        per-scan (stamps, gyro, acc) covering (t_prev, t_scan]
      gt:         ground-truth (R, p) at each scan end
      gps:        (t, xyz, noise_std) world-frame fixes
      stamps:     absolute scan-end times
    """
    rng = np.random.default_rng(cfg.seed)
    dirs, t_frac = _ray_dirs(cfg)
    scan_T = 1.0 / cfg.scan_rate
    imu_dt = 1.0 / cfg.imu_rate
    g_world = np.array([0.0, 0.0, -cfg.gravity])
    bg = np.asarray(cfg.gyro_bias)
    ba = np.asarray(cfg.acc_bias)

    scans, imu_batches, gt, stamps = [], [], [], []
    gps = []
    n_rays = dirs.shape[0]
    for k in range(n_scans):
        t_end = t0 + (k + 1) * scan_T
        t_start = t_end - scan_T
        # --- LiDAR: each azimuth column cast from its own-time pose ---
        frac = t_frac
        if cfg.time_groups is not None:
            frac = np.floor(t_frac * cfg.time_groups) / cfg.time_groups
        pt_times = t_start + frac * scan_T
        # group by unique azimuth time to limit pose evaluations
        pts = np.zeros((n_rays, 3))
        hits = np.zeros((n_rays,), bool)
        uniq_times, inv = np.unique(pt_times, return_inverse=True)
        for ui, tu in enumerate(uniq_times):
            sel = inv == ui
            R, p = traj.pose(tu)
            R_s = R @ cfg.lidar_R
            p_s = R @ cfg.lidar_t + p
            d_world = dirs[sel] @ R_s.T
            o = np.broadcast_to(p_s, d_world.shape)
            pw, h = world.raycast(o, d_world, cfg.max_range)
            # back to the sensor frame at capture time
            pts[sel] = (pw - p_s) @ R_s
            hits[sel] = h
        t_off = (pt_times - t_start).astype(np.float32)  # relative to prev scan end
        scans.append(
            (
                pts.astype(np.float32),
                t_off,
                hits,
            )
        )
        # --- IMU over (t_start, t_end] ---
        n_imu = int(round(scan_T / imu_dt))
        ts = t_start + np.arange(n_imu) * imu_dt
        gyro = np.stack([traj.angular_velocity(t) for t in ts])
        acc_w = np.stack([traj.acceleration(t) for t in ts])
        Rs = [traj.pose(t)[0] for t in ts]
        acc_b = np.stack([Rs[i].T @ (acc_w[i] - g_world) for i in range(n_imu)])
        gyro = gyro + bg + rng.normal(size=gyro.shape) * cfg.gyro_noise
        acc_b = acc_b + ba + rng.normal(size=acc_b.shape) * cfg.acc_noise
        imu_batches.append(
            (
                (ts - t_start).astype(np.float32),
                gyro.astype(np.float32),
                acc_b.astype(np.float32),
            )
        )
        R_end, p_end = traj.pose(t_end)
        gt.append((R_end, p_end))
        stamps.append(t_end)
        # --- GPS at gps_rate ---
        if cfg.gps_rate > 0:
            gps_period = 1.0 / cfg.gps_rate
            if int(t_end / gps_period) > int(t_start / gps_period):
                tg = np.floor(t_end / gps_period) * gps_period
                _, pg = traj.pose(tg)
                gps.append(
                    (
                        tg,
                        pg + rng.normal(size=3) * cfg.gps_noise,
                        np.full(3, cfg.gps_noise),
                    )
                )

    return {
        "scans": scans,
        "imu": imu_batches,
        "gt": gt,
        "stamps": np.asarray(stamps),
        "gps": gps,
        "scan_dt": scan_T,
    }
