"""The plain reference's per-frame odometry and mapping in history
matching mode: the ICP input filter, the registration, the pose
policy, the history ring and the matching buffer's rebuild or append,
a frozen copy of the program's plain step (reference `Laser_mapping`,
``source/laser_mapping.hpp:1316-1660`` and ``:460-566``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import residuals as res
from . import se3
from .config import SlamConfig
from .icp import RegistrationResult, prepare_frame, refine_blur, register_on_host
from .ops import FeatureFrame, PointBatch, voxel_downsample


class OdometryState(NamedTuple):
    q_w: torch.Tensor               # (4,) world pose
    t_w: torch.Tensor               # (3,)
    frame_count: torch.Tensor       # () int32 frames processed
    hist_corner_xyz: torch.Tensor   # (W, Ch, 3) world-frame history ring
    hist_corner_mask: torch.Tensor  # (W, Ch)
    hist_surf_xyz: torch.Tensor     # (W, Cs, 3)
    hist_surf_mask: torch.Tensor    # (W, Cs)
    hist_ptr: torch.Tensor          # () int32 next ring slot
    hist_len: torch.Tensor          # () int32 valid ring entries
    last_his_q: torch.Tensor        # pose of the last admitted frame
    last_his_t: torch.Tensor
    last_q_incre: torch.Tensor      # last accepted increment
    last_t_incre: torch.Tensor
    map_corners: PointBatch         # matching buffer
    map_surface: PointBatch


def init_state(cfg: SlamConfig, device) -> OdometryState:
    caps = cfg.capacity
    w = caps.history_window
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return OdometryState(
        q_w=se3.quat_identity(device=device),
        t_w=torch.zeros(3, **f32),
        frame_count=torch.zeros((), **i32),
        hist_corner_xyz=torch.zeros((w, caps.hist_corner_capacity, 3), **f32),
        hist_corner_mask=torch.zeros((w, caps.hist_corner_capacity),
                                     dtype=torch.bool, device=device),
        hist_surf_xyz=torch.zeros((w, caps.hist_surf_capacity, 3), **f32),
        hist_surf_mask=torch.zeros((w, caps.hist_surf_capacity),
                                   dtype=torch.bool, device=device),
        hist_ptr=torch.zeros((), **i32),
        hist_len=torch.zeros((), **i32),
        last_his_q=se3.quat_identity(device=device),
        last_his_t=torch.zeros(3, **f32),
        last_q_incre=se3.quat_identity(device=device),
        last_t_incre=torch.zeros(3, **f32),
        map_corners=PointBatch.empty(caps.map_corner_capacity, device),
        map_surface=PointBatch.empty(caps.map_surf_capacity, device),
    )


def matching_sources(state: OdometryState) -> Tuple[PointBatch, PointBatch]:
    """The unfiltered corner and surface sources of the matching buffer:
    the history window, flattened."""
    def flat(xyz, mask):
        n = xyz.shape[0] * xyz.shape[1]
        return PointBatch(xyz=xyz.reshape(n, 3),
                          time=torch.zeros(n, device=xyz.device),
                          mask=mask.reshape(n))

    return (flat(state.hist_corner_xyz, state.hist_corner_mask),
            flat(state.hist_surf_xyz, state.hist_surf_mask))


def rebuild_matching_buffer(state: OdometryState, cfg: SlamConfig
                            ) -> Tuple[PointBatch, PointBatch]:
    """The matching sources voxel-filtered at the registration leaves
    (reference :517-537)."""
    fe, caps = cfg.feature_extraction, cfg.capacity
    raw_c, raw_s = matching_sources(state)
    corners = voxel_downsample(raw_c, fe.mapping_line_resolution,
                               capacity=caps.map_corner_capacity, with_time=False)
    surface = voxel_downsample(raw_s, fe.mapping_plane_resolution,
                               capacity=caps.map_surf_capacity, with_time=False)
    return corners, surface


def append_to_buffer(buf: PointBatch, pts: PointBatch) -> PointBatch:
    """Write ``pts`` (all its slots) at the end of the buffer's valid
    prefix, the start clipped to ``capacity − pts.capacity``."""
    c, p = buf.capacity, pts.capacity
    start = torch.clamp(buf.mask.sum(), 0, c - p)
    rows = start + torch.arange(p, device=buf.xyz.device)
    xyz = buf.xyz.clone()
    mask = buf.mask.clone()
    xyz[rows] = pts.xyz
    mask[rows] = pts.mask
    return PointBatch(xyz=xyz, time=buf.time, mask=mask)


def rebuild_interval(cfg: SlamConfig) -> int:
    """Frames between full rebuilds: the configured cadence, or with 0
    the staleness the profile tolerates (delay time over the 0.1 s scan
    period), at least 4 when appends keep the newest frame in the buffer."""
    caps = cfg.capacity
    interval = int(caps.matching_rebuild_interval)
    if interval == 0:
        interval = max(1, round(cfg.mapping.maximum_pointcloud_delay_time / 0.1))
        if append_mode(cfg):
            interval = max(interval, 4)
    return max(interval, 1)


def append_mode(cfg: SlamConfig) -> bool:
    """Appends between full rebuilds: on with ``matching_append_mode``,
    except under the ``grid`` engine (a grid has no append)."""
    return (bool(cfg.capacity.matching_append_mode)
            and cfg.optimization.correspondence != "grid")


def input_downsample(frame: FeatureFrame, cfg: SlamConfig):
    """ICP input voxel filter (reference :1368-1373)."""
    fe, caps = cfg.feature_extraction, cfg.capacity
    if cfg.mapping.input_downsample_mode:
        return (voxel_downsample(frame.corners, fe.mapping_line_resolution,
                                 capacity=caps.max_corner_ds),
                voxel_downsample(frame.surface, fe.mapping_plane_resolution,
                                 capacity=caps.max_surface_ds))
    return frame.corners, frame.surface


def odometry_step(state: OdometryState, frame: FeatureFrame, cfg: SlamConfig
                  ) -> Tuple[OdometryState, RegistrationResult]:
    """Register one feature frame (its ICP loop on the host), then update
    the history and the matching buffer."""
    corner_in, surf_in = input_downsample(frame, cfg)
    icp_pass, carry, finish = prepare_frame(
        corner_in, surf_in, state.map_corners, state.map_surface,
        state.q_w, state.t_w, frame.time_min, frame.time_max,
        state.frame_count >= cfg.mapping.init_accumulate_frames, cfg,
        q_incre_init=state.last_q_incre, t_incre_init=state.last_t_incre)
    reg = register_on_host(icp_pass, carry, finish, cfg.optimization.icp_maximum_iteration)
    return commit_frame(state, frame, corner_in, surf_in, reg, cfg)


def _select(cond: torch.Tensor, a: PointBatch, b: PointBatch) -> PointBatch:
    """``cond ? a : b`` field by field over two batches of one shape."""
    return PointBatch(*(torch.where(cond, x, y) for x, y in zip(a, b)))


class MatchingUpdate(NamedTuple):
    """A step's matching-buffer update: rebuild the buffer from its
    sources (the history window, or the cells near the new pose), append
    the step's world points, or neither (the JAX step's ``lax.cond``)."""
    rebuild: torch.Tensor             # () bool
    append: Optional[torch.Tensor]    # () bool, exclusive of rebuild; None without appends
    corners: PointBatch               # the step's world points, for an append
    surface: PointBatch


def update_matching(state: OdometryState, upd: MatchingUpdate, cfg: SlamConfig
                    ) -> OdometryState:
    """Apply ``upd`` to the state after its history write: each branch
    computed, one kept, with no host read."""
    fresh_c, fresh_s = rebuild_matching_buffer(state, cfg)
    keep_c, keep_s = state.map_corners, state.map_surface
    if upd.append is not None:
        app_c = append_to_buffer(state.map_corners, upd.corners)
        app_s = append_to_buffer(state.map_surface, upd.surface)
        keep_c, keep_s = _select(upd.append, app_c, keep_c), _select(upd.append, app_s, keep_s)
    return state._replace(map_corners=_select(upd.rebuild, fresh_c, keep_c),
                          map_surface=_select(upd.rebuild, fresh_s, keep_s))


def commit_frame(state: OdometryState, frame: FeatureFrame,
                 corner_in: PointBatch, surf_in: PointBatch,
                 reg: RegistrationResult, cfg: SlamConfig
                 ) -> Tuple[OdometryState, RegistrationResult]:
    """Pose policy, history ring and matching buffer after registration
    (reference :1413-1564)."""
    new, reg, upd = commit_history(state, frame, corner_in, surf_in, reg, cfg)
    return update_matching(new, upd, cfg), reg


def commit_history(state: OdometryState, frame: FeatureFrame,
                   corner_in: PointBatch, surf_in: PointBatch,
                   reg: RegistrationResult, cfg: SlamConfig
                   ) -> Tuple[OdometryState, RegistrationResult, MatchingUpdate]:
    """`commit_frame` up to the matching buffer: the new state (history
    ring and pose; the matching buffer as it was) and the
    `MatchingUpdate` that `update_matching` applies."""
    fe, caps, mp = cfg.feature_extraction, cfg.capacity, cfg.mapping
    deblur = bool(cfg.common.if_motion_deblur)
    q_base, t_base = state.q_w, state.t_w

    if mp.reject_recovery_mode == 1:
        rejected = reg.enabled & ~reg.accepted
        coast_q = se3.quat_normalize(se3.quat_multiply(state.q_w, state.last_q_incre))
        coast_t = se3.quat_rotate(state.q_w, state.last_t_incre) + state.t_w
        reg = reg._replace(q_w=torch.where(rejected, coast_q, reg.q_w),
                           t_w=torch.where(rejected, coast_t, reg.t_w))
    took = reg.accepted & reg.enabled
    last_q_incre = torch.where(took, reg.q_incre, state.last_q_incre)
    last_t_incre = torch.where(took, reg.t_incre, state.last_t_incre)

    # world transform with deblur (reference :1422-1437)
    def to_world(pts: PointBatch, leaf: float, cap: int) -> PointBatch:
        s = refine_blur(pts.time, frame.time_min, frame.time_max, deblur)
        xyz = res.transform_points_incre(reg.q_incre, reg.t_incre, pts.xyz, s,
                                         q_base, t_base, deblur)
        return voxel_downsample(pts._replace(xyz=xyz), leaf, capacity=cap)

    corner_w = to_world(corner_in, fe.mapping_line_resolution, caps.hist_corner_capacity)
    surf_w = to_world(surf_in, fe.mapping_plane_resolution, caps.hist_surf_capacity)

    # history admission (reference :1444-1463), on the device
    r_diff = se3.quat_angular_distance(reg.q_w, state.last_his_q) * 57.3
    t_diff = torch.linalg.vector_norm(reg.t_w - state.last_his_t)
    moved = ((t_diff > mp.history_add_t_step)
             | (r_diff > mp.history_add_angle_step * 57.3))
    window_open = state.hist_len < mp.maximum_histroy_buffer
    admit = reg.accepted & (moved | window_open)
    w = caps.history_window
    slot = state.hist_ptr.to(torch.int64).reshape(1)

    def write(ring, value):
        return torch.where(admit, ring.index_copy(0, slot, value[None]), ring)

    new = state._replace(
        q_w=reg.q_w, t_w=reg.t_w, frame_count=state.frame_count + 1,
        last_q_incre=last_q_incre, last_t_incre=last_t_incre,
        hist_corner_xyz=write(state.hist_corner_xyz, corner_w.xyz),
        hist_corner_mask=write(state.hist_corner_mask, corner_w.mask),
        hist_surf_xyz=write(state.hist_surf_xyz, surf_w.xyz),
        hist_surf_mask=write(state.hist_surf_mask, surf_w.mask),
        hist_ptr=torch.where(admit, (state.hist_ptr + 1) % w, state.hist_ptr),
        hist_len=torch.where(admit, torch.clamp(state.hist_len + 1, max=w), state.hist_len),
        last_his_q=torch.where(admit, reg.q_w, state.last_his_q),
        last_his_t=torch.where(admit, reg.t_w, state.last_his_t))
    # rebuild (admitted, on the cadence), append (admitted, off it) or
    # keep, decided on the device
    interval = rebuild_interval(cfg)
    do_rebuild = admit if interval == 1 else admit & (state.frame_count % interval == 0)
    do_append = (admit & ~do_rebuild) if append_mode(cfg) and interval > 1 else None
    return new, reg, MatchingUpdate(do_rebuild.reshape(()), None if do_append is None
                                    else do_append.reshape(()), corner_w, surf_w)
