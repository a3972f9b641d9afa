"""Synthetic Livox scan simulator (host-side numpy).

A ground-truthed stand-in for the reference's rosbag replays: a Mid-40
rosette scan pattern (~17° half-FoV around +X, 10 µs point spacing,
petal-shaped polar distance) raycast against a room of convex solids
from a smooth 6-DoF trajectory, every point cast from the pose at its
own timestamp (intra-frame motion blur).

The same generator as the JAX package's ``io/simulator.py``, so the two
packages see the same frames (to f32 round-off) from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


def quat_to_matrix_f32(q: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotations, in float32."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    one, two = np.float32(1), np.float32(2)
    m = np.stack([
        one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
        two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
        two * (xz - wy), two * (yz + wx), one - two * (xx + yy),
    ], axis=-1)
    return m.reshape(-1, 3, 3)


@dataclass
class RosettePattern:
    """Direction generator for a Mid-40-like non-repetitive rosette."""

    max_fov_deg: float = 16.0
    petal_hz: float = 100.0
    rot_hz: float = 13.7

    def directions(self, times: np.ndarray) -> np.ndarray:
        r_max = np.tan(np.deg2rad(self.max_fov_deg))
        r = r_max * np.abs(np.sin(np.pi * self.petal_hz * times))
        phi = 2 * np.pi * self.rot_hz * times
        d = np.stack([np.ones_like(r), r * np.cos(phi), r * np.sin(phi)], axis=-1)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)


@dataclass
class BoxScene:
    """Axis-aligned boxes; the room walls are six thin slabs (the JAX
    package's ``io/simulator.py:48-100``)."""
    boxes: np.ndarray         # (B, 2, 3): [:, 0] = lo corner, [:, 1] = hi corner
    reflectivity: np.ndarray  # (B,)

    @staticmethod
    def random_room(rng: np.random.Generator, half_extent: float = 12.0,
                    n_boxes: int = 14, n_pillars: int = 12) -> "BoxScene":
        """Room walls, random boxes, and full-height pillars inside the +X
        viewing frustum: the pillars give the creases the Livox corner
        detector fires on (reference ``livox_feature_extractor.hpp:443-452``)."""
        e = half_extent
        w = 0.5  # wall thickness
        walls = [
            [[e, -e - w, -e - w], [e + w, e + w, e + w]],     # +x
            [[-e - w, -e - w, -e - w], [-e, e + w, e + w]],   # -x
            [[-e - w, e, -e - w], [e + w, e + w, e + w]],     # +y
            [[-e - w, -e - w, -e - w], [e + w, -e, e + w]],   # -y
            [[-e - w, -e - w, e], [e + w, e + w, e + w]],     # +z (ceiling)
            [[-e - w, -e - w, -e - w], [e + w, e + w, -e]],   # -z (floor)
        ]
        boxes = [np.array(b, np.float64) for b in walls]
        for _ in range(n_boxes):
            c = rng.uniform(-0.7 * e, 0.7 * e, size=3)
            s = rng.uniform(0.4, 2.5, size=3)
            boxes.append(np.stack([c - s / 2, c + s / 2]))
        for _ in range(n_pillars):
            x = rng.uniform(0.3 * e, 0.9 * e)
            y = rng.uniform(-0.55 * e, 0.55 * e)
            sx, sy = rng.uniform(0.3, 0.9, size=2)
            boxes.append(np.array([[x - sx / 2, y - sy / 2, -e], [x + sx / 2, y + sy / 2, e]]))
        arr = np.stack(boxes)
        return BoxScene(arr, rng.uniform(0.5, 1.5, size=len(arr)))

    def raycast(self, origins: np.ndarray, dirs: np.ndarray):
        """First-hit distances along each ray (slab method): ``(t_hit (N,),
        box_idx (N,))``, ``t_hit`` inf where no box is hit."""
        o = origins[:, None, :]
        d = dirs[:, None, :]
        lo = self.boxes[None, :, 0, :]
        hi = self.boxes[None, :, 1, :]
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
        tmin = np.max(np.minimum(t1, t2), axis=-1)
        tmax = np.min(np.maximum(t1, t2), axis=-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t_enter = np.where(tmin > 0, tmin, tmax)     # inside a box: its exit
        t_enter = np.where(hit, t_enter, np.inf)
        box_idx = np.argmin(t_enter, axis=1)
        return t_enter[np.arange(len(origins)), box_idx], box_idx


@dataclass
class ConvexScene:
    """Convex solids, each the intersection of half-spaces ``n·x ≤ d``;
    padded planes have n = 0, d = 1.  Solids meeting at angles give the
    creases the Livox corner detector looks for."""

    normals: np.ndarray       # (B, P, 3)
    dists: np.ndarray         # (B, P)
    reflectivity: np.ndarray  # (B,)

    @staticmethod
    def from_parts(parts, refl):
        pmax = max(len(d) for _, d in parts)
        normals = np.zeros((len(parts), pmax, 3))
        dists = np.ones((len(parts), pmax))
        for i, (n, d) in enumerate(parts):
            normals[i, : len(d)] = n
            dists[i, : len(d)] = d
        return ConvexScene(normals, dists, np.asarray(refl, np.float64))

    @staticmethod
    def box_planes(lo, hi):
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        return np.vstack([np.eye(3), -np.eye(3)]), np.concatenate([hi, -lo])

    @staticmethod
    def wedge_planes(apex_xy, span_lo, span_hi, x_back, half_angle_deg,
                     azimuth_deg: float = 0.0, horizontal: bool = False):
        """Sharp triangular ridge with its apex edge through ``apex_xy``,
        vertical or (``horizontal``) along y, opening away from the
        sensor."""
        th = np.deg2rad(half_angle_deg)
        az = np.deg2rad(azimuth_deg)
        c, s = np.cos(az), np.sin(az)
        ax, aw = apex_xy
        if horizontal:
            R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
            lat = np.array([0.0, 0.0, 1.0])
            edge = np.array([0.0, 1.0, 0.0])
            apex = np.array([ax, 0.0, aw])
        else:
            R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            lat = np.array([0.0, 1.0, 0.0])
            edge = np.array([0.0, 0.0, 1.0])
            apex = np.array([ax, aw, 0.0])
        n1 = R @ (-np.sin(th) * np.array([1.0, 0, 0]) + np.cos(th) * lat)
        n2 = R @ (-np.sin(th) * np.array([1.0, 0, 0]) - np.cos(th) * lat)
        nb = R @ np.array([1.0, 0.0, 0.0])
        back = apex + R @ np.array([x_back, 0.0, 0.0])
        n = np.stack([n1, n2, nb, edge, -edge])
        d = np.array([n1 @ apex, n2 @ apex, nb @ back, span_hi, -span_lo])
        return n, d

    @staticmethod
    def random_room(rng: np.random.Generator, half_extent: float = 12.0,
                    half_extent_z: float = 2.5, n_boxes: int = 10,
                    n_pillars: int = 8, n_ridges: int = 20) -> "ConvexScene":
        """Walls, boxes, pillars in the frustum and sharp wall ridges."""
        e, ez, w = half_extent, half_extent_z, 0.5
        walls = [
            ([e, -e - w, -ez - w], [e + w, e + w, ez + w]),
            ([-e - w, -e - w, -ez - w], [-e, e + w, ez + w]),
            ([-e - w, e, -ez - w], [e + w, e + w, ez + w]),
            ([-e - w, -e - w, -ez - w], [e + w, -e, ez + w]),
            ([-e - w, -e - w, ez], [e + w, e + w, ez + w]),
            ([-e - w, -e - w, -ez - w], [e + w, e + w, -ez]),
        ]
        parts = [ConvexScene.box_planes(lo, hi) for lo, hi in walls]
        for _ in range(n_boxes):
            c = rng.uniform(-0.7 * e, 0.7 * e, size=3)
            c[2] = rng.uniform(-0.6 * ez, 0.6 * ez)
            s = rng.uniform(0.4, 2.0, size=3)
            parts.append(ConvexScene.box_planes(c - s / 2, c + s / 2))
        for _ in range(n_pillars):
            x = rng.uniform(0.3 * e, 0.9 * e)
            y = rng.uniform(-0.55 * e, 0.55 * e)
            sx, sy = rng.uniform(0.3, 0.9, size=2)
            parts.append(ConvexScene.box_planes(
                [x - sx / 2, y - sy / 2, -ez], [x + sx / 2, y + sy / 2, ez]))
        for i in range(n_ridges):
            x = rng.uniform(0.5 * e, 0.95 * e)
            y = rng.uniform(-0.6 * e, 0.6 * e)
            half_angle = rng.uniform(10.0, 20.0)
            azim = rng.uniform(-25.0, 25.0)
            depth = rng.uniform(1.0, 2.5)
            parts.append(ConvexScene.wedge_planes(
                (x, y), -ez, ez, depth, half_angle, azim,
                horizontal=bool(i % 2)))
        refl = rng.uniform(0.5, 1.5, size=len(parts))
        return ConvexScene.from_parts(parts, refl)

    @staticmethod
    def rotated_box_planes(rng, center, size):
        """Box at ``center`` with edge lengths ``size`` in a uniformly
        random orientation (QR of a Gaussian)."""
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        n = np.vstack([np.eye(3), -np.eye(3)]) @ Q.T
        half = np.asarray(size) / 2
        return n, np.concatenate([half, half]) + n @ np.asarray(center, np.float64)

    @staticmethod
    def rock_planes(rng, center, radius, n_faces=10):
        """A convex "rock": ``n_faces`` half-spaces with random normals at
        0.7-1.0 of ``radius`` from the centre, each face its own
        orientation."""
        n = rng.normal(size=(n_faces, 3))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        return n, radius * rng.uniform(0.7, 1.0, n_faces) + n @ np.asarray(center, np.float64)

    @staticmethod
    def random_rich_world(rng: np.random.Generator, half_extent: float = 14.0,
                          half_extent_z: float = 3.0, n_rot_boxes: int = 14,
                          n_rocks: int = 22, n_ridges: int = 10) -> "ConvexScene":
        """Walls, randomly rotated boxes, faceted rocks and ridges: enough
        distinct plane orientations a keyframe for the shipped 5 %
        nonzero-bin gate of the loop-closure descriptors.  Draws from
        ``rng`` in the JAX package's order, so one seed gives its world."""
        e, ez, w = half_extent, half_extent_z, 0.5
        walls = [
            ([e, -e - w, -ez - w], [e + w, e + w, ez + w]),
            ([-e - w, -e - w, -ez - w], [-e, e + w, ez + w]),
            ([-e - w, e, -ez - w], [e + w, e + w, ez + w]),
            ([-e - w, -e - w, -ez - w], [e + w, -e, ez + w]),
            ([-e - w, -e - w, ez], [e + w, e + w, ez + w]),
            ([-e - w, -e - w, -ez - w], [e + w, e + w, -ez]),
        ]
        parts = [ConvexScene.box_planes(lo, hi) for lo, hi in walls]

        def clear_center(radius):
            # a clearance bubble around the trajectory's region
            while True:
                c = rng.uniform(-0.85 * e, 0.85 * e, size=3)
                if np.linalg.norm(c[:2]) > radius + 3.5:
                    return c

        for _ in range(n_rot_boxes):
            c = clear_center(1.5)
            c[2] = rng.uniform(-0.5 * ez, 0.3 * ez)
            parts.append(ConvexScene.rotated_box_planes(rng, c, rng.uniform(0.8, 2.6, size=3)))
        for _ in range(n_rocks):
            c = clear_center(1.8)
            c[2] = rng.uniform(-0.7 * ez, 0.1 * ez)
            parts.append(ConvexScene.rock_planes(rng, c, rng.uniform(0.8, 1.8), n_faces=10))
        for i in range(n_ridges):
            x = rng.uniform(0.5 * e, 0.95 * e)
            y = rng.uniform(-0.6 * e, 0.6 * e)
            parts.append(ConvexScene.wedge_planes(
                (x, y), -ez, ez, rng.uniform(1.0, 2.5), rng.uniform(10.0, 20.0),
                rng.uniform(-25.0, 25.0), horizontal=bool(i % 2)))
        refl = rng.uniform(0.5, 1.5, size=len(parts))
        return ConvexScene.from_parts(parts, refl)

    def raycast(self, origins: np.ndarray, dirs: np.ndarray):
        """First-hit distances (N,) and object ids (N,); inf on a miss."""
        denom = np.einsum("nk,bpk->nbp", dirs, self.normals)
        num = self.dists[None, :, :] - np.einsum("nk,bpk->nbp", origins, self.normals)
        eps = 1e-12
        t = num / np.where(np.abs(denom) < eps, eps, denom)
        entering = denom < -eps
        exiting = denom > eps
        parallel_out = (np.abs(denom) <= eps) & (num < 0)
        tmin = np.max(np.where(entering, t, -np.inf), axis=-1)
        tmax = np.min(np.where(exiting, t, np.inf), axis=-1)
        hit = (tmax >= tmin) & (tmax > 0) & ~np.any(parallel_out, axis=-1)
        t_enter = np.where(tmin > 0, tmin, tmax)
        t_enter = np.where(hit, t_enter, np.inf)
        obj = np.argmin(t_enter, axis=1)
        return t_enter[np.arange(len(origins)), obj], obj


@dataclass
class Trajectory:
    """Smooth 6-DoF trajectory that holds still until ``ramp_t0`` and then
    ramps in (real captures start stationary while the seed map
    accumulates)."""

    lin_amp: np.ndarray = field(default_factory=lambda: np.array([2.0, 1.5, 0.3]))
    lin_hz: np.ndarray = field(default_factory=lambda: np.array([0.05, 0.04, 0.08]))
    yaw_amp: float = 0.6
    yaw_hz: float = 0.05
    pitch_amp: float = 0.12
    pitch_hz: float = 0.07
    ramp_t0: float = 1.0

    def _warp(self, t: np.ndarray) -> np.ndarray:
        u = np.maximum(np.asarray(t, np.float64) - self.ramp_t0, 0.0)
        return u * u / (u + 1.0)

    def position(self, t: np.ndarray) -> np.ndarray:
        t = self._warp(np.atleast_1d(np.asarray(t, np.float64)))
        return self.lin_amp[None, :] * np.sin(
            2 * np.pi * self.lin_hz[None, :] * t[:, None])

    def quaternion(self, t: np.ndarray) -> np.ndarray:
        """wxyz (N, 4): yaw about z, then pitch about y."""
        t = self._warp(np.atleast_1d(np.asarray(t, np.float64)))
        yaw = self.yaw_amp * np.sin(2 * np.pi * self.yaw_hz * t)
        pitch = self.pitch_amp * np.sin(2 * np.pi * self.pitch_hz * t + 1.0)
        cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
        cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
        return np.stack([cy * cp, -sy * sp, cy * sp, sy * cp], axis=-1)

    def pose(self, t):
        return self.quaternion(t), self.position(t)


@dataclass
class SimConfig:
    points_per_frame: int = 10000
    frame_period: float = 0.1
    point_dt: float = 1.0e-5
    noise_std: float = 0.005
    dropout_rate: float = 0.002   # x == 0 driver dropouts
    seed: int = 0


class LivoxSimulator:
    def __init__(self, cfg: SimConfig | None = None,
                 scene: ConvexScene | None = None,
                 traj: Trajectory | None = None,
                 pattern: RosettePattern | None = None):
        self.cfg = cfg or SimConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        self.scene = scene or ConvexScene.random_room(self.rng)
        self.traj = traj or Trajectory()
        self.pattern = pattern or RosettePattern()

    def frame(self, frame_idx: int) -> Tuple[np.ndarray, np.ndarray, float]:
        """One frame: (xyz (N, 3) float32 in the sensor frame at each
        point's own pose, intensity (N,) float32, t0)."""
        c = self.cfg
        t0 = frame_idx * c.frame_period
        times = t0 + np.arange(c.points_per_frame) * c.point_dt
        dirs_s = self.pattern.directions(times)
        q, p = self.traj.pose(times)
        R = quat_to_matrix_f32(q)
        dirs_w = np.einsum("nij,nj->ni", R, dirs_s)
        t_hit, obj = self.scene.raycast(p, dirs_w)
        hit = np.isfinite(t_hit)
        pts_w = p + dirs_w * np.where(hit, t_hit, 1.0)[:, None]
        pts_s = np.einsum("nji,nj->ni", R, pts_w - p)
        pts_s += self.rng.normal(scale=c.noise_std, size=pts_s.shape)
        refl = self.scene.reflectivity[obj]
        intensity = (refl * self.rng.uniform(0.8, 1.2, len(refl))).astype(np.float32)
        bad = (self.rng.uniform(size=len(pts_s)) < c.dropout_rate) | ~hit
        pts_s[bad] = 0.0
        intensity[bad] = 0.0
        return pts_s.astype(np.float32), intensity, float(t0)

    def gt_pose_at(self, t: float):
        """Ground-truth (q_wxyz, position) at time t."""
        q, p = self.traj.pose(np.array([t]))
        return q[0], p[0]
