"""The adaptive capacity schedule, the counterpart of
``loam_livox_tpu/runtime/capacity_schedule.py``.

The configured capacities are worst cases; on bounded scenes the buffers
fill to a few percent of them.  With ``capacity/auto_schedule`` 1 (the
default) the pipeline runs its six fill-driven buffers (`SCALED_FIELDS`)
at ``1/schedule_start_scale`` of their configured size, with per-field
floors, and doubles all six together when a check finds a fill above
``schedule_watermark`` of its current capacity, or a frame-feature
buffer full (`SATURATION_FIELDS`: a fill equal to the capacity means the
producing voxel filter already truncated).  Growth is monotonic and
stops at the configured capacities; `resize_state` pads the state's
buffers, so no point is dropped by a growth.

The tiers are behaviour, not only shapes: while a buffer is smaller
than its configured size, the voxel filters that write it keep only
their smallest voxel keys, as the JAX package's do.  So the port runs
the same tiers as the JAX package, checked at the same dispatch units:
the pipeline counts down 4 units (a raw frame, a chunk, a raced group,
or a `process_feature_frame` step) to each check, resets to 4 after a
growth and otherwise doubles the wait up to 64.

The schedule is off (`schedule_active`) where shapes are part of a
contract: ``auto_schedule`` 0, product mode, ``parallel/deterministic``
1, the ``grid`` engine (bucket tables sized statically) and cell
matching (``mapping/matching_mode`` 1, whose gathered buffer jumps in
fill the moment registration starts).  Callers of `odometry_step` pass
the capacities they want.

A check reads the six fills to the host in one transfer, counted under
the host-sync place ``schedule`` (`SYNCS`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.config import SlamConfig
from .odometry import OdometryState, init_state

#: host reads of the buffer fills since the last reset
SYNCS = {"schedule": 0}

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
    prefix kept, zeros (``False``) after it.  Host values (ints, floats,
    the generator) and absent maps (``None``) stay as they are."""
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
        SYNCS["schedule"] += 1
        fills = measure_fills(state).cpu().numpy()
        grew = False
        while self.scale > 1 and needs_growth(fills, self.cfg, self.watermark):
            self.set_scale(self.scale // 2)
            self.growths += 1
            grew = True
        if grew:
            state = resize_state(state, self.cfg)
        return state, self.cfg, grew


def schedule_active(cfg: SlamConfig, mesh) -> bool:
    """Whether the schedule drives a pipeline of ``cfg`` on ``mesh`` (off
    under the shape contracts of the module doc)."""
    if not cfg.capacity.auto_schedule:
        return False
    if mesh is not None or int(cfg.parallel.mesh_devices) > 1:
        return False
    if int(cfg.parallel.deterministic) == 1:
        return False
    if cfg.optimization.correspondence == "grid":
        return False
    if int(cfg.mapping.matching_mode) == 1:
        return False
    return True
