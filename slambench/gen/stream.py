"""The synthetic Livox stream on the card: a PyTorch rewrite of the
program's host simulator (a Mid-40 rosette ray-cast against a room of
convex solids from a smooth 6-DoF trajectory, every point cast from the
pose at its own time), extended to several heads that share one body,
one pose and one published frame (a Mid-100's three).

The site (scene, trajectory, heads, rosette) belongs to a configuration
and is fixed; ``seed`` draws only the sensor's noise, its dropouts and
its intensities, so every seed asks the same work of the program.

    site = Site.from_dict(cfg_json["site"])
    frames = make_frames(site, seed, n_frames, capacity, device)
    frames.xyz  # (F, S, capacity, 3) float32, padded; S heads
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

F64 = torch.float64


# ---- the scene: convex solids, each the intersection of half-spaces -----

def _box_planes(lo, hi):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    return np.vstack([np.eye(3), -np.eye(3)]), np.concatenate([hi, -lo])


def _wedge_planes(apex_xy, span_lo, span_hi, x_back, half_angle_deg,
                  azimuth_deg: float, horizontal: bool):
    """A sharp triangular ridge with its apex edge through ``apex_xy``,
    vertical or (``horizontal``) along y, opening away from the sensor."""
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


def random_room(seed: int, half_extent: float = 12.0, half_extent_z: float = 2.5,
                n_boxes: int = 10, n_pillars: int = 8, n_ridges: int = 20):
    """Walls, boxes, pillars in the +X frustum and sharp wall ridges (the
    creases the Livox corner detector fires on), drawn from ``seed`` in
    the program's simulator's order: ``(normals (B, P, 3), dists (B, P),
    reflectivity (B,))``, padded planes n = 0, d = 1."""
    rng = np.random.default_rng(seed)
    e, ez, w = half_extent, half_extent_z, 0.5
    walls = [
        ([e, -e - w, -ez - w], [e + w, e + w, ez + w]),
        ([-e - w, -e - w, -ez - w], [-e, e + w, ez + w]),
        ([-e - w, e, -ez - w], [e + w, e + w, ez + w]),
        ([-e - w, -e - w, -ez - w], [e + w, -e, ez + w]),
        ([-e - w, -e - w, ez], [e + w, e + w, ez + w]),
        ([-e - w, -e - w, -ez - w], [e + w, e + w, -ez]),
    ]
    parts = [_box_planes(lo, hi) for lo, hi in walls]
    for _ in range(n_boxes):
        c = rng.uniform(-0.7 * e, 0.7 * e, size=3)
        c[2] = rng.uniform(-0.6 * ez, 0.6 * ez)
        s = rng.uniform(0.4, 2.0, size=3)
        parts.append(_box_planes(c - s / 2, c + s / 2))
    for _ in range(n_pillars):
        x = rng.uniform(0.3 * e, 0.9 * e)
        y = rng.uniform(-0.55 * e, 0.55 * e)
        sx, sy = rng.uniform(0.3, 0.9, size=2)
        parts.append(_box_planes([x - sx / 2, y - sy / 2, -ez], [x + sx / 2, y + sy / 2, ez]))
    for i in range(n_ridges):
        x = rng.uniform(0.5 * e, 0.95 * e)
        y = rng.uniform(-0.6 * e, 0.6 * e)
        half_angle = rng.uniform(10.0, 20.0)
        azim = rng.uniform(-25.0, 25.0)
        depth = rng.uniform(1.0, 2.5)
        parts.append(_wedge_planes((x, y), -ez, ez, depth, half_angle, azim,
                                   horizontal=bool(i % 2)))
    return _solids(parts, rng.uniform(0.5, 1.5, size=len(parts)))


def _rotated_box_planes(rng, center, size):
    """A box at ``center`` with edge lengths ``size`` in a uniformly
    random orientation (QR of a Gaussian)."""
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    n = np.vstack([np.eye(3), -np.eye(3)]) @ Q.T
    half = np.asarray(size) / 2
    return n, np.concatenate([half, half]) + n @ np.asarray(center, np.float64)


def _rock_planes(rng, center, radius, n_faces=10):
    """A convex rock: ``n_faces`` half-spaces with random normals at
    0.7-1.0 of ``radius`` from the centre."""
    n = rng.normal(size=(n_faces, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return n, radius * rng.uniform(0.7, 1.0, n_faces) + n @ np.asarray(center, np.float64)


def random_rich_world(seed: int, half_extent: float = 14.0, half_extent_z: float = 3.0,
                      n_rot_boxes: int = 14, n_rocks: int = 22, n_ridges: int = 10):
    """Walls, randomly rotated boxes, faceted rocks and ridges (many plane
    orientations), drawn from ``seed`` in the program's simulator's
    order; returned as `random_room` returns."""
    rng = np.random.default_rng(seed)
    e, ez, w = half_extent, half_extent_z, 0.5
    walls = [
        ([e, -e - w, -ez - w], [e + w, e + w, ez + w]),
        ([-e - w, -e - w, -ez - w], [-e, e + w, ez + w]),
        ([-e - w, e, -ez - w], [e + w, e + w, ez + w]),
        ([-e - w, -e - w, -ez - w], [e + w, -e, ez + w]),
        ([-e - w, -e - w, ez], [e + w, e + w, ez + w]),
        ([-e - w, -e - w, -ez - w], [e + w, e + w, -ez]),
    ]
    parts = [_box_planes(lo, hi) for lo, hi in walls]

    def clear_center(radius):
        while True:
            c = rng.uniform(-0.85 * e, 0.85 * e, size=3)
            if np.linalg.norm(c[:2]) > radius + 3.5:
                return c

    for _ in range(n_rot_boxes):
        c = clear_center(1.5)
        c[2] = rng.uniform(-0.5 * ez, 0.3 * ez)
        parts.append(_rotated_box_planes(rng, c, rng.uniform(0.8, 2.6, size=3)))
    for _ in range(n_rocks):
        c = clear_center(1.8)
        c[2] = rng.uniform(-0.7 * ez, 0.1 * ez)
        parts.append(_rock_planes(rng, c, rng.uniform(0.8, 1.8), n_faces=10))
    for i in range(n_ridges):
        x = rng.uniform(0.5 * e, 0.95 * e)
        y = rng.uniform(-0.6 * e, 0.6 * e)
        parts.append(_wedge_planes((x, y), -ez, ez, rng.uniform(1.0, 2.5),
                                   rng.uniform(10.0, 20.0), rng.uniform(-25.0, 25.0),
                                   horizontal=bool(i % 2)))
    return _solids(parts, rng.uniform(0.5, 1.5, size=len(parts)))


def _solids(parts, refl):
    pmax = max(len(d) for _, d in parts)
    normals = np.zeros((len(parts), pmax, 3))
    dists = np.ones((len(parts), pmax))
    for i, (n, d) in enumerate(parts):
        normals[i, :len(d)] = n
        dists[i, :len(d)] = d
    return normals, dists, np.asarray(refl, np.float64)


#: the scene makers a site names under ``scene.kind``
SCENES = {"room": random_room, "rich_world": random_rich_world}


class Scene(NamedTuple):
    normals: torch.Tensor       # (B, P, 3) float64
    dists: torch.Tensor         # (B, P)
    reflectivity: torch.Tensor  # (B,)


def raycast(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor):
    """First-hit distances (..., ) and solid ids of rays (..., 3); inf on
    a miss.  Slab test over each solid's half-spaces, in float64."""
    nrm = scene.normals.reshape(-1, 3)                    # (B*P, 3)
    nb, npl = scene.dists.shape
    denom = (dirs @ nrm.T).unflatten(-1, (nb, npl))       # (..., B, P)
    num = scene.dists - (origins @ nrm.T).unflatten(-1, (nb, npl))
    eps = 1e-12
    t = num / torch.where(denom.abs() < eps, torch.full_like(denom, eps), denom)
    inf = torch.full_like(t, math.inf)
    tmin = torch.where(denom < -eps, t, -inf).amax(-1)
    tmax = torch.where(denom > eps, t, inf).amin(-1)
    parallel_out = ((denom.abs() <= eps) & (num < 0)).any(-1)
    hit = (tmax >= tmin) & (tmax > 0) & ~parallel_out
    t_enter = torch.where(tmin > 0, tmin, tmax)
    t_enter = torch.where(hit, t_enter, torch.full_like(t_enter, math.inf))
    t_hit, obj = t_enter.min(-1)
    return t_hit, obj


# ---- the trajectory and the scan pattern --------------------------------

@dataclass(frozen=True)
class Trajectory:
    """A smooth 6-DoF trajectory that holds still until ``ramp_t0`` and
    then ramps in (a capture starts stationary while the seed map
    accumulates)."""
    lin_amp: Tuple[float, float, float] = (2.0, 1.5, 0.3)
    lin_hz: Tuple[float, float, float] = (0.05, 0.04, 0.08)
    yaw_amp: float = 0.6
    yaw_hz: float = 0.05
    pitch_amp: float = 0.12
    pitch_hz: float = 0.07
    ramp_t0: float = 1.0

    def _warp(self, t: torch.Tensor) -> torch.Tensor:
        u = torch.clamp(t - self.ramp_t0, min=0.0)
        return u * u / (u + 1.0)

    def position(self, t: torch.Tensor) -> torch.Tensor:
        """(..., 3) positions at float64 times (...)."""
        w = self._warp(t)[..., None]
        amp = torch.tensor(self.lin_amp, dtype=F64, device=t.device)
        hz = torch.tensor(self.lin_hz, dtype=F64, device=t.device)
        return amp * torch.sin(2 * math.pi * hz * w)

    def rotation(self, t: torch.Tensor) -> torch.Tensor:
        """(..., 3, 3) body-to-world rotations: yaw about z, then pitch
        about y."""
        w = self._warp(t)
        yaw = self.yaw_amp * torch.sin(2 * math.pi * self.yaw_hz * w)
        pitch = self.pitch_amp * torch.sin(2 * math.pi * self.pitch_hz * w + 1.0)
        cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
        zero = torch.zeros_like(yaw)
        return torch.stack([
            torch.stack([cy * cp, -sy, cy * sp], -1),
            torch.stack([sy * cp, cy, sy * sp], -1),
            torch.stack([-sp, zero, cp], -1)], -2)


@dataclass(frozen=True)
class Rosette:
    """A Mid-40's non-repetitive rosette about a head's +X axis."""
    max_fov_deg: float = 16.0
    petal_hz: float = 100.0
    rot_hz: float = 13.7

    def directions(self, t: torch.Tensor) -> torch.Tensor:
        r_max = math.tan(math.radians(self.max_fov_deg))
        r = r_max * torch.abs(torch.sin(math.pi * self.petal_hz * t))
        phi = 2 * math.pi * self.rot_hz * t
        d = torch.stack([torch.ones_like(r), r * torch.cos(phi), r * torch.sin(phi)], -1)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


@dataclass(frozen=True)
class Site:
    """What a configuration fixes: the scene, the trajectory, the heads'
    yaws about the body's z axis, and the scan timing."""
    scene: dict = field(default_factory=dict)   # "kind" (a `SCENES` key) and its maker's arguments
    trajectory: Trajectory = field(default_factory=Trajectory)
    rosette: Rosette = field(default_factory=Rosette)
    heads_yaw_deg: Tuple[float, ...] = (0.0,)
    points_per_head: int = 10000
    frame_period: float = 0.1
    point_dt: float = 1.0e-5
    noise_std: float = 0.005
    dropout_rate: float = 0.002

    @staticmethod
    def from_dict(d: dict) -> "Site":
        d = dict(d)
        traj = d.pop("trajectory", {})
        traj = Trajectory(**{k: tuple(v) if isinstance(v, list) else v for k, v in traj.items()})
        ros = Rosette(**d.pop("rosette", {}))
        heads = tuple(float(y) for y in d.pop("heads_yaw_deg", (0.0,)))
        return Site(trajectory=traj, rosette=ros, heads_yaw_deg=heads, **d)

    def build_scene(self, device) -> Scene:
        kw = dict(self.scene)
        n, dist, refl = SCENES[kw.pop("kind", "room")](**kw)
        return Scene(*(torch.as_tensor(a, dtype=F64, device=device) for a in (n, dist, refl)))


class Frames(NamedTuple):
    """A stream of padded raw frames on one device."""
    xyz: torch.Tensor      # (F, S, C, 3) float32, each head in the body frame
    inten: torch.Tensor    # (F, S, C) float32
    mask: torch.Tensor     # (F, S, C) bool: the first points_per_head slots
    t0: List[float]        # (F,) each frame's base time, seconds


def make_frames(site: Site, seed: int, n_frames: int, capacity: int, device,
                batch: int = 8) -> Frames:
    """``n_frames`` frames of every head, padded to ``capacity`` points,
    made on ``device`` ``batch`` frames at a time.  The noise (normal,
    ``noise_std``), the intensities (the solid's reflectivity times a
    uniform draw in [0.8, 1.2]) and the dropouts (x = 0 at
    ``dropout_rate``; also every ray that hits nothing) come from a
    generator on ``device`` seeded with ``seed``."""
    dev = torch.device(device)
    n_pts = site.points_per_head
    if n_pts > capacity:
        raise ValueError(f"{n_pts} points a head exceed the capacity {capacity}")
    n_heads = len(site.heads_yaw_deg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    scene = site.build_scene(dev)
    yaw = torch.tensor([math.radians(y) for y in site.heads_yaw_deg], dtype=F64, device=dev)
    head_rot = torch.zeros((n_heads, 3, 3), dtype=F64, device=dev)
    head_rot[:, 0, 0] = torch.cos(yaw)
    head_rot[:, 0, 1] = -torch.sin(yaw)
    head_rot[:, 1, 0] = torch.sin(yaw)
    head_rot[:, 1, 1] = torch.cos(yaw)
    head_rot[:, 2, 2] = 1.0
    xyz = torch.zeros((n_frames, n_heads, capacity, 3), dtype=torch.float32, device=dev)
    inten = torch.zeros((n_frames, n_heads, capacity), dtype=torch.float32, device=dev)
    mask = torch.zeros((n_frames, n_heads, capacity), dtype=torch.bool, device=dev)
    mask[:, :, :n_pts] = True
    offsets = torch.arange(n_pts, dtype=F64, device=dev) * site.point_dt
    for lo in range(0, n_frames, batch):
        hi = min(lo + batch, n_frames)
        t0 = torch.arange(lo, hi, dtype=F64, device=dev) * site.frame_period
        times = t0[:, None] + offsets                          # (B, N)
        d_head = site.rosette.directions(times)                # (B, N, 3) head frame
        d_body = torch.einsum("sij,bnj->bsni", head_rot, d_head)   # (B, S, N, 3)
        rot = site.trajectory.rotation(times)                  # (B, N, 3, 3)
        pos = site.trajectory.position(times)                  # (B, N, 3)
        d_world = torch.einsum("bnij,bsnj->bsni", rot, d_body)
        t_hit, obj = raycast(scene, pos[:, None].expand_as(d_world), d_world)
        hit = torch.isfinite(t_hit)
        pts = d_body * torch.where(hit, t_hit, torch.ones_like(t_hit))[..., None]
        pts = pts + torch.randn(pts.shape, generator=gen, dtype=F64, device=dev) * site.noise_std
        jitter = torch.rand(obj.shape, generator=gen, dtype=F64, device=dev) * 0.4 + 0.8
        refl = scene.reflectivity[obj] * jitter
        bad = (torch.rand(obj.shape, generator=gen, dtype=F64, device=dev)
               < site.dropout_rate) | ~hit
        pts = torch.where(bad[..., None], torch.zeros_like(pts), pts)
        refl = torch.where(bad, torch.zeros_like(refl), refl)
        xyz[lo:hi, :, :n_pts] = pts.to(torch.float32)
        inten[lo:hi, :, :n_pts] = refl.to(torch.float32)
    return Frames(xyz, inten, mask, [i * site.frame_period for i in range(n_frames)])


def ground_truth(site: Site, times) -> np.ndarray:
    """(n, 3) true body positions at the given times (seconds), float64."""
    t = torch.as_tensor(np.asarray(times, np.float64), dtype=F64)
    return site.trajectory.position(t).numpy()
