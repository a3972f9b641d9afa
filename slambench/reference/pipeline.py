"""The plain reference's dispatch: the front end and the source voxel
filter of a raw frame, one odometry step a piece, and the capacity
schedule's tiers and checks at the program's cadence (a check every 4
to 64 dispatch units, 4 again after a growth), a frozen copy of the
program's plain pipeline on the sequential path.

    ref = PlainOdometry(cfg, device)
    ref.process_raw(pts, inten, mask, base_time)     # a Mid-40 frame
    for piece in ref.head_frames(xyz, inten, mask, base_time):
        ref.process_feature_frame(piece)             # a Mid-100 frame
    rows = ref.rows()    # (n, 10): time, t_w, q_w, accepted, iterations
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .config import SlamConfig, reference_path
from .frontend import extract_frame, extract_multi_lidar
from .odometry import OdometryState, init_state, odometry_step
from .ops import FeatureFrame, voxel_downsample

#: fill-driven capacity fields and their floors (the JAX package's;
#: ``max_corner`` / ``max_surface`` hold raw per-piece candidates that
#: saturate on any dense stream, so they stay at the configured size)
SCALED_FIELDS = {
    "max_corner_ds": 128,
    "max_surface_ds": 256,
    "hist_corner_capacity": 64,
    "hist_surf_capacity": 128,
    "map_corner_capacity": 512,
    "map_surf_capacity": 1024,
}

#: frame-feature buffers: a fill equal to the capacity grows at once,
#: even below the watermark
SATURATION_FIELDS = ("max_corner_ds", "max_surface_ds",
                     "hist_corner_capacity", "hist_surf_capacity")

#: the capacity field of each entry of `measure_fills`' vector; the
#: history fills stand in for the ICP inputs' (same voxel leaf), which
#: the state does not keep
FILL_FIELDS = ("map_corner_capacity", "map_surf_capacity",
               "hist_corner_capacity", "hist_surf_capacity",
               "max_corner_ds", "max_surface_ds")


def _round64(n: int) -> int:
    return max(64, (n + 63) // 64 * 64)


def scaled_caps(cfg: SlamConfig, scale: int) -> SlamConfig:
    """``cfg`` with every scheduled capacity divided by ``scale`` (at
    least its floor, 64-aligned, never above the configured value)."""
    caps = cfg.capacity
    over = {}
    for f, floor in SCALED_FIELDS.items():
        full = getattr(caps, f)
        over[f] = min(full, max(floor, _round64(full // scale)))
    return cfg.replace(capacity=over)


def measure_fills(state: OdometryState) -> torch.Tensor:
    """The buffer fills in `FILL_FIELDS` order as one (6,) int32 tensor on
    the state's device: the matching buffers' valid rows, and the largest
    history slot's valid rows (twice: the ring and the ICP inputs)."""
    i32 = torch.int32
    hist_c = state.hist_corner_mask.sum(dim=1, dtype=i32).max()
    hist_s = state.hist_surf_mask.sum(dim=1, dtype=i32).max()
    return torch.stack([state.map_corners.mask.sum(dtype=i32),
                        state.map_surface.mask.sum(dtype=i32),
                        hist_c, hist_s, hist_c, hist_s])


def needs_growth(fills, cfg: SlamConfig, watermark: float) -> bool:
    """Whether a fill crossed the watermark of its capacity in ``cfg``, or
    a frame-feature buffer is full."""
    caps = cfg.capacity
    for f, fill in zip(FILL_FIELDS, np.asarray(fills)):
        cap = getattr(caps, f)
        if f in SATURATION_FIELDS and int(fill) >= cap:
            return True
        if int(fill) > watermark * cap:
            return True
    return False


def _fit(x, t, name: str):
    """``x`` re-padded to the shape of the template ``t``: the valid
    prefix kept, zeros (``False``) after it."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(**{f: _fit(getattr(x, f), getattr(t, f), f"{name}.{f}")
                          for f in x._fields})
    if not isinstance(x, torch.Tensor):
        return x
    if x.shape == t.shape:
        return x
    for have, want in zip(x.shape, t.shape):
        if want < have:
            raise ValueError(f"capacity schedule shrank {name} {tuple(x.shape)} -> "
                             f"{tuple(t.shape)}; the schedule is grow-only")
    out = torch.zeros(t.shape, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def resize_state(state: OdometryState, cfg: SlamConfig) -> OdometryState:
    """The state with every buffer re-padded to ``init_state(cfg)``'s
    shapes (grow-only: each keeps its valid prefix; a shrink raises
    ``ValueError``).  Fields whose shape does not change are the same
    tensors."""
    tpl = init_state(cfg, state.t_w.device)
    return _fit(state, tpl, "state")


class CapacityScheduler:
    """The schedule's host side for one pipeline."""

    def __init__(self, base_cfg: SlamConfig):
        caps = base_cfg.capacity
        self.base_cfg = base_cfg
        self.scale = max(1, int(caps.schedule_start_scale))
        self.watermark = float(caps.schedule_watermark)
        self.cfg = scaled_caps(base_cfg, self.scale)
        self.growths = 0

    def at_max(self) -> bool:
        return self.scale <= 1

    def set_scale(self, scale: int) -> None:
        """Jump to the tier ``scale`` (a restored checkpoint's)."""
        self.scale = max(1, int(scale))
        self.cfg = scaled_caps(self.base_cfg, self.scale)

    def maybe_grow(self, state: OdometryState) -> Tuple[OdometryState, SlamConfig, bool]:
        """Read the fills (one host transfer); while any crossed its
        watermark, halve the scale; re-pad the state once.  Returns
        ``(state, cfg, grew)``."""
        if self.at_max():
            return state, self.cfg, False
        fills = measure_fills(state).cpu().numpy()
        grew = False
        while self.scale > 1 and needs_growth(fills, self.cfg, self.watermark):
            self.set_scale(self.scale // 2)
            self.growths += 1
            grew = True
        if grew:
            state = resize_state(state, self.cfg)
        return state, self.cfg, grew


def source_downsample(frame: FeatureFrame, cfg: SlamConfig) -> FeatureFrame:
    """The front end's voxel filter before publishing: corner leaf =
    line resolution, surface leaf = half the plane resolution."""
    fe, caps = cfg.feature_extraction, cfg.capacity
    return frame._replace(
        corners=voxel_downsample(frame.corners, fe.mapping_line_resolution,
                                 capacity=caps.max_corner),
        surface=voxel_downsample(frame.surface, fe.mapping_plane_resolution / 2.0,
                                 capacity=caps.max_surface))


def piece_count(cfg: SlamConfig) -> int:
    """Pieces a raw frame splits into: motion deblur forces one."""
    if cfg.common.if_motion_deblur:
        return 1
    return max(1, cfg.common.piecewise_number)


def steps_per_frame(cfg: SlamConfig) -> int:
    """Odometry steps a raw frame runs (odometry mode 0: the first piece)."""
    return 1 if cfg.common.odom_mode == 0 else piece_count(cfg)


def extract_heads(xyz, inten, mask, base_time, cfg: SlamConfig) -> List[FeatureFrame]:
    """A multi-head raw frame's merged pieces, each through its source
    voxel filter at the merged capacities."""
    fe = cfg.feature_extraction
    frames = extract_multi_lidar(xyz, inten, mask, base_time, fe, cfg.capacity,
                                 piecewise_number=cfg.common.piecewise_number)
    return [fr._replace(
        corners=voxel_downsample(fr.corners, fe.mapping_line_resolution,
                                 capacity=fr.corners.capacity),
        surface=voxel_downsample(fr.surface, fe.mapping_plane_resolution / 2.0,
                                 capacity=fr.surface.capacity)) for fr in frames]


def trajectory_row(reg, frame: FeatureFrame) -> torch.Tensor:
    """(10,) device row (time_min, t_w, q_w, accepted, iterations)."""
    return torch.cat([frame.time_min.reshape(1), reg.t_w, reg.q_w,
                      reg.accepted.reshape(1).to(torch.float32),
                      torch.full((1,), float(reg.iterations), device=reg.t_w.device)])


class PlainOdometry:
    """The reference's pipeline over raw frames (module doc)."""

    def __init__(self, cfg: SlamConfig, device):
        reference_path(cfg)
        self.cfg = cfg
        on = cfg.capacity.auto_schedule and cfg.parallel.deterministic != 1
        self.scheduler = CapacityScheduler(cfg) if on else None
        self.cfg_active = cfg if self.scheduler is None else self.scheduler.cfg
        self._interval = 4
        self._countdown = 4
        self._units = 0
        #: (dispatch units run, scale) at each growth of the schedule
        self.ladder: List[Tuple[int, int]] = []
        self.state: OdometryState = init_state(self.cfg_active, torch.device(device))
        self._rows: List[torch.Tensor] = []

    def resume(self, state: OdometryState, scale: int) -> None:
        """Continue from ``state`` at the schedule's tier ``scale``, with
        no check of the fills (a caller that follows another pipeline
        step by step compares re-padded buffers by their valid prefix)."""
        self.state = state
        if self.scheduler is not None:
            self.scheduler.set_scale(scale)
            self.cfg_active = self.scheduler.cfg
            self._countdown = 1 << 30
        self._rows = []

    def _maybe_grow(self) -> None:
        self._units += 1
        if self.scheduler is None or self.scheduler.at_max():
            return
        self._countdown -= 1
        if self._countdown > 0:
            return
        self.state, self.cfg_active, grew = self.scheduler.maybe_grow(self.state)
        if grew:
            self.ladder.append((self._units, self.scheduler.scale))
            self._interval = 4
        else:
            self._interval = min(self._interval * 2, 64)
        self._countdown = self._interval

    def process_raw(self, pts, inten, mask, base_time) -> None:
        """One padded raw frame: its pieces that run, one step each, as
        one dispatch unit."""
        cfg = self.cfg_active
        fe = cfg.feature_extraction
        _, _, frames = extract_frame(pts, inten, mask, base_time, fe, cfg.capacity,
                                     piece_count(cfg))
        for frame in frames[:steps_per_frame(cfg)]:
            frame = source_downsample(frame, cfg)
            self.state, reg = odometry_step(self.state, frame, cfg)
            self._rows.append(trajectory_row(reg, frame))
        self._maybe_grow()

    def head_frames(self, xyz, inten, mask, base_time) -> List[FeatureFrame]:
        """A multi-head raw frame's pieces, at the configured capacities."""
        return extract_heads(xyz, inten, mask, base_time, self.cfg)

    def process_feature_frame(self, frame: FeatureFrame) -> None:
        """One odometry step on a finished piece, one dispatch unit."""
        self.state, reg = odometry_step(self.state, frame, self.cfg_active)
        self._rows.append(trajectory_row(reg, frame))
        self._maybe_grow()

    def rows(self) -> torch.Tensor:
        """Every registration's row so far, (n, 10) on the device."""
        return torch.stack(self._rows)
