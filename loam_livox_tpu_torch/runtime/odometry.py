"""Per-frame odometry and mapping (reference `Laser_mapping`:
``source/laser_mapping.hpp:1316-1660`` `process_new_scan` and
``:460-566`` `update_buff_for_matching`).

    state, reg = odometry_step(state, frame, cfg)

* ICP inputs are voxel-filtered: corners at the line resolution,
  surfaces at the plane resolution (reference :1368-1373);
* ICP runs after ``init_accumulate_frames`` (reference config :28-30);
* a rejected frame changes neither the pose nor the map (:1416-1420);
* registered features go to the world frame with per-point deblur and
  are voxel-filtered again before they enter the history ring
  (:1422-1437), gated on motion and the window size (:1444-1487), and,
  in cell matching mode, the corner and plane cell maps (:1491-1493);
* with loop closure on, the registered full cloud goes to the world
  frame with deblur and into the full-cloud cell map, whose cells that
  took at least 3 points form the keyframes (:1526-1530);
* the matching buffer (:460-566) is, in history mode
  (``mapping/matching_mode`` 0), the voxel-filtered history window; in
  cell mode (1), the voxel-filtered pools of the cells within the
  search ranges of the pose and inside its field of view.  It is
  rebuilt in full on every 4th frame and appended to in between.

The state carries only what the ported paths read or write out.  The
feature cell maps are kept where the JAX package keeps them
(``_need_cell_maps``, ``loam_livox_tpu/runtime/odometry.py:106-110``):
with cell matching, which reads them, or with loop closure, where the
plane map is what the command line's ``--save-map`` writes; elsewhere
they are ``None`` (the JAX package keeps 1-slot dummies).  The
full-cloud cell map ``cell_full`` and its touched-cell mask
``last_touched`` are ``None`` unless loop closure is on.  The bucket
grids over the matching buffer (``grid_corners`` / ``grid_surface``,
`ops.bucket_grid`) are built at init and at every full rebuild under
the ``grid`` correspondence engine, and are ``None`` under every other;
a grid has no append, so appends between rebuilds are off under
``grid`` (``loam_livox_tpu/runtime/odometry.py:393-396``).
The state carries the JAX package's threefry key (`ops.threefry`, a
(2,) uint32 device tensor, ``PRNGKey(0)`` at init): each step splits it
as the JAX step does (``loam_livox_tpu/runtime/odometry.py:243``) and
hands the registration the second half, from which residual
subsampling (``optimization/subsample_residuals``) draws the JAX
package's own uniforms.
The frame counter, ring pointer and ring length are int32 scalars on
the state's device, as is each cell map's frame index, as in the JAX
package.

History admission stays on the device, as the JAX step's ``jnp.where``
and ``lax.cond`` keep it (``loam_livox_tpu/runtime/odometry.py:325-453``):
the flag is a bool tensor; the ring write, pointers and last admitted
pose are selects; every cell map takes every frame, its points masked
by the flag (an all-False mask moves only the map's frame index, as
`map.cell_map.skip_frame` would); and the matching buffer's rebuild
and append are both computed and the one the flag and the cadence pick
is kept.  A step reads nothing on the host, in either matching mode, so
the frame program (`runtime.frame_program`) can capture it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core import se3
from ..core.config import SlamConfig, require_supported
from ..core.types import FeatureFrame, PointBatch
from ..map.cell_map import (CellMap, append_cloud, cells_in_fov, cells_in_radius,
                            empty_cell_map, gather_cell_points)
from ..ops.bucket_grid import BucketGrid, build_bucket_grid
from ..ops.threefry import prng_key, split
from ..ops.voxel import voxel_downsample
from ..registration import residuals as res
from ..registration.icp import (RegistrationResult, prepare_frame, refine_blur,
                                register_on_host)
from ..utils.logging import SPAN_ADD_FRAME, SPAN_BUILD_TREE, SPAN_SETUP, SPAN_UPDATE_BUFF, spans

#: host reads of the history-admission flag since the last reset: none
#: since the cell maps take masked insertions (the place stays in the
#: host-sync audit, where it reads 0)
SYNCS = {"admit": 0}


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
    cell_corners: CellMap | None    # feature cell maps (cell matching or loop closure)
    cell_planes: CellMap | None
    map_corners: PointBatch         # matching buffer
    map_surface: PointBatch
    rng: torch.Tensor               # (2,) uint32 threefry key (residual subsampling draws)
    cell_full: CellMap | None = None          # full-cloud cell map (loop closure)
    last_touched: torch.Tensor | None = None  # (C,) cells this frame gave >= 3 points
    grid_corners: BucketGrid | None = None    # bucket grids over the buffer (grid engine)
    grid_surface: BucketGrid | None = None


def build_grids(map_corners: PointBatch, map_surface: PointBatch, cfg: SlamConfig):
    """The bucket grids over the matching buffer under the ``grid``
    engine, else ``(None, None)``."""
    if cfg.optimization.correspondence != "grid":
        return None, None
    opt, caps = cfg.optimization, cfg.capacity
    return (build_bucket_grid(map_corners.xyz, map_corners.mask, opt.corner_bucket_size,
                              caps.corner_bucket_count, caps.corner_bucket_cap),
            build_bucket_grid(map_surface.xyz, map_surface.mask, opt.surf_bucket_size,
                              caps.surf_bucket_count, caps.surf_bucket_cap))


def init_state(cfg: SlamConfig, device) -> OdometryState:
    require_supported(cfg)
    caps = cfg.capacity
    w = caps.history_window
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)

    def cells(on: bool):
        if not on:
            return None
        return empty_cell_map(cfg.mapping.cell_resolution * 0.5, caps.cell_capacity,
                              caps.cell_point_capacity, device)

    loop = bool(cfg.loop_closure.if_enable_loop_closure)
    map_corners = PointBatch.empty(caps.map_corner_capacity, device)
    map_surface = PointBatch.empty(caps.map_surf_capacity, device)
    grid_corners, grid_surface = build_grids(map_corners, map_surface, cfg)
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
        cell_corners=cells(cfg.mapping.matching_mode == 1 or loop),
        cell_planes=cells(cfg.mapping.matching_mode == 1 or loop),
        map_corners=map_corners,
        map_surface=map_surface,
        rng=prng_key(0, device),
        cell_full=cells(loop),
        last_touched=(torch.zeros((caps.cell_capacity,), dtype=torch.bool, device=device)
                      if loop else None),
        grid_corners=grid_corners,
        grid_surface=grid_surface,
    )


def matching_sources(state: OdometryState, cfg: SlamConfig
                     ) -> Tuple[PointBatch, PointBatch]:
    """The unfiltered corner and surface sources of the matching buffer:
    the history window (matching mode 0), or the pools of the cells
    within ``maximum_search_range_*`` of the pose and inside its field
    of view (mode 1, reference :471-515)."""
    mp = cfg.mapping
    if mp.matching_mode == 1:
        def near(cells: CellMap, radius: float) -> PointBatch:
            sel = (cells_in_radius(cells, state.t_w, radius)
                   & cells_in_fov(cells, state.t_w, state.q_w, mp.maximum_in_fov_angle))
            return gather_cell_points(cells, sel)

        return (near(state.cell_corners, mp.maximum_search_range_corner),
                near(state.cell_planes, mp.maximum_search_range_surface))

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
    raw_c, raw_s = matching_sources(state, cfg)
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


def prepare_step(state: OdometryState, frame: FeatureFrame, cfg: SlamConfig):
    """A step up to its ICP loop: the input voxel filter, the state's key
    split (the first half the state's next key, the second the
    registration's) and the registration's pass, first carry and gates
    (`icp.prepare_frame`).  Returns ``(corner_in, surf_in, icp_pass,
    carry, finish, rng)``, ``rng`` the key the state commits."""
    with spans.device(SPAN_SETUP, state.t_w):
        corner_in, surf_in = input_downsample(frame, cfg)
        keys = split(state.rng)
        icp_pass, carry, finish = prepare_frame(
            corner_in, surf_in, state.map_corners, state.map_surface,
            state.q_w, state.t_w, frame.time_min, frame.time_max,
            state.frame_count >= cfg.mapping.init_accumulate_frames, cfg,
            q_incre_init=state.last_q_incre, t_incre_init=state.last_t_incre,
            rng=keys[1], grid_corners=state.grid_corners, grid_surface=state.grid_surface)
        return corner_in, surf_in, icp_pass, carry, finish, keys[0]


def odometry_step(state: OdometryState, frame: FeatureFrame, cfg: SlamConfig
                  ) -> Tuple[OdometryState, RegistrationResult]:
    """Register one feature frame (its ICP loop on the host), then update
    the history and the matching buffer."""
    corner_in, surf_in, icp_pass, carry, finish, rng = prepare_step(state, frame, cfg)
    reg = register_on_host(icp_pass, carry, finish, cfg.optimization.icp_maximum_iteration)
    return commit_frame(state._replace(rng=rng), frame, corner_in, surf_in, reg, cfg)


def _select(cond: torch.Tensor, a, b):
    """``cond ? a : b`` field by field over two batches or grids of one
    shape (host fields are equal and kept; ``None`` stays ``None``)."""
    if a is None:
        return None
    return type(a)(*(torch.where(cond, x, y) if isinstance(x, torch.Tensor) else x
                     for x, y in zip(a, b)))


class MatchingUpdate(NamedTuple):
    """A step's matching-buffer update: rebuild the buffer from its
    sources (the history window, or the cells near the new pose), append
    the step's world points, or neither (the JAX step's ``lax.cond``)."""
    rebuild: torch.Tensor             # () bool
    append: Optional[torch.Tensor]    # () bool, exclusive of rebuild; None without appends
    corners: PointBatch               # the step's world points, for an append
    surface: PointBatch


def rebuilt_matching(state: OdometryState, cfg: SlamConfig):
    """``(map_corners, map_surface, grid_corners, grid_surface)`` rebuilt
    from the state's matching sources (`matching_sources`): the history
    window, or the cell maps around the state's pose."""
    with spans.device(SPAN_BUILD_TREE, state.t_w):
        map_c, map_s = rebuild_matching_buffer(state, cfg)
        return (map_c, map_s) + tuple(build_grids(map_c, map_s, cfg))


def appended_matching(state: OdometryState, upd: MatchingUpdate):
    """``(map_corners, map_surface)`` with the step's points appended."""
    with spans.device(SPAN_UPDATE_BUFF, state.t_w):
        return (append_to_buffer(state.map_corners, upd.corners),
                append_to_buffer(state.map_surface, upd.surface))


def update_matching(state: OdometryState, upd: MatchingUpdate, cfg: SlamConfig
                    ) -> OdometryState:
    """Apply ``upd`` to the state after its history write: each branch
    computed, one kept, with no host read (the frame program runs only
    the branch taken, under a CUDA graph SWITCH node)."""
    fresh = rebuilt_matching(state, cfg)
    keep_c, keep_s = state.map_corners, state.map_surface
    if upd.append is not None:
        app_c, app_s = appended_matching(state, upd)
        keep_c, keep_s = _select(upd.append, app_c, keep_c), _select(upd.append, app_s, keep_s)
    return state._replace(map_corners=_select(upd.rebuild, fresh[0], keep_c),
                          map_surface=_select(upd.rebuild, fresh[1], keep_s),
                          grid_corners=_select(upd.rebuild, fresh[2], state.grid_corners),
                          grid_surface=_select(upd.rebuild, fresh[3], state.grid_surface))


def commit_frame(state: OdometryState, frame: FeatureFrame,
                 corner_in: PointBatch, surf_in: PointBatch,
                 reg: RegistrationResult, cfg: SlamConfig,
                 q_base=None, t_base=None
                 ) -> Tuple[OdometryState, RegistrationResult]:
    """Pose policy, history ring, cell maps and matching buffer after
    registration (reference :1413-1564).  ``q_base`` / ``t_base`` is the
    pose the registration's increment composes from: ``state.q_w`` /
    ``state.t_w`` (the default) in the sequential step, each lane's
    coasted start pose in the racing step.  Returns a new state; the input state's tensors
    are not modified."""
    new, reg, upd = commit_history(state, frame, corner_in, surf_in, reg, cfg, q_base, t_base)
    return update_matching(new, upd, cfg), reg


def commit_history(state: OdometryState, frame: FeatureFrame,
                   corner_in: PointBatch, surf_in: PointBatch,
                   reg: RegistrationResult, cfg: SlamConfig, q_base=None, t_base=None
                   ) -> Tuple[OdometryState, RegistrationResult, MatchingUpdate]:
    """`commit_frame` up to the matching buffer: the new state (history
    ring, cell maps and pose; the matching buffer as it was) and the
    `MatchingUpdate` that `update_matching` applies.  Reads nothing on
    the host."""
    with spans.device(SPAN_ADD_FRAME, state.t_w):
        return _commit_history(state, frame, corner_in, surf_in, reg, cfg, q_base, t_base)


def _commit_history(state: OdometryState, frame: FeatureFrame, corner_in: PointBatch,
                    surf_in: PointBatch, reg: RegistrationResult, cfg: SlamConfig,
                    q_base, t_base):
    fe, caps, mp = cfg.feature_extraction, cfg.capacity, cfg.mapping
    deblur = bool(cfg.common.if_motion_deblur)
    if q_base is None:
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
    # cell-map insertion (reference :1491-1493) with the frame's points
    # masked by admission, before the rebuild, so that a rebuild sees
    # this frame's cells; a frame not admitted moves only the maps'
    # frame index (the JAX step, loam_livox_tpu/runtime/odometry.py:358-380)
    revisit, max_new = cfg.common.threshold_cell_revisit, caps.cell_max_new_per_frame

    def insert(cells: CellMap, pts: PointBatch):
        return append_cloud(cells, pts._replace(mask=pts.mask & admit), revisit, max_new)

    if state.cell_corners is not None:
        new = new._replace(cell_corners=insert(state.cell_corners, corner_w)[0],
                           cell_planes=insert(state.cell_planes, surf_w)[0])
    # the full-cloud cell map of loop closure (reference :1526-1530): the
    # registered full cloud in the world frame with deblur
    if state.cell_full is not None:
        s = refine_blur(frame.full.time, frame.time_min, frame.time_max, deblur)
        full_w = frame.full._replace(xyz=res.transform_points_incre(
            reg.q_incre, reg.t_incre, frame.full.xyz, s, q_base, t_base, deblur))
        cell_full, touched = insert(state.cell_full, full_w)
        new = new._replace(cell_full=cell_full, last_touched=touched)

    # rebuild (admitted, on the cadence), append (admitted, off it) or
    # keep, decided on the device
    interval = rebuild_interval(cfg)
    do_rebuild = admit if interval == 1 else admit & (state.frame_count % interval == 0)
    do_append = (admit & ~do_rebuild) if append_mode(cfg) and interval > 1 else None
    return new, reg, MatchingUpdate(do_rebuild.reshape(()), None if do_append is None
                                    else do_append.reshape(()), corner_w, surf_w)
