"""The configuration tree as the plain reference reads it: the same
dataclasses, field names and defaults as the program's, frozen here so
that a later change to the program's defaults cannot move the yardstick.

`reference_path` raises on a configuration the plain reference does not
compute: it follows the Livox front end (one head or several), history
matching, the exact k-NN search, sequential dispatch on one device,
loop closure and residual subsampling off.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class CommonConfig:
    lidar_type: str = "livox"
    maximum_parallel_thread: int = 1
    odom_mode: int = 1
    # 1 = one registration per frame with per-point slerp deblur (the
    # default); 0 = the shipped profiles' `piecewise_number` windows.
    if_motion_deblur: int = 1
    if_save_to_pcd_files: int = 0
    if_update_mean_and_cov_incrementally: int = 1
    threshold_cell_revisit: int = 2000
    piecewise_number: int = 3
    # inverted like the reference: 1 = silent, 0 = echo diagnostics
    if_verbose_screen_printf: int = 1


@dataclass(frozen=True)
class FeatureExtractionConfig:
    scan_line: int = 64
    mapping_line_resolution: float = 0.1
    mapping_plane_resolution: float = 0.4
    livox_min_sigma: float = 7e-4
    livox_min_dis: float = 0.1
    corner_curvature: float = 0.1
    surface_curvature: float = 0.005
    minimum_view_angle: float = 5.0
    minimum_range: float = 0.1
    max_fov_deg: float = 17.0
    time_internal_pts: float = 1.0e-5
    split_min_gap: int = 50
    corner_max_depth: float = 30.0
    surface_max_depth: float = 1000.0


@dataclass(frozen=True)
class OptimizationConfig:
    minimum_icp_R_diff: float = 0.01
    minimum_icp_T_diff: float = 0.01
    maximum_residual_blocks: int = 200
    max_allow_final_cost: float = 2.0
    icp_maximum_iteration: int = 15
    prerun_iterations: int = 2
    inlier_dis: float = 0.02
    inlier_ratio: float = 0.80
    huber_delta: float = 0.1
    line_search_num: int = 5
    plane_search_num: int = 5
    maximum_dis_line_for_match: float = 2.0    # squared-distance gate
    maximum_dis_plane_for_match: float = 50.0  # squared-distance gate
    max_allow_incre_R: float = 200.0 / 50.0
    max_allow_incre_T: float = 100.0 / 50.0
    lm_init_lambda: float = 1e-4
    # 0 = identity increment seed; 1 = last accepted increment
    increment_init: int = 0
    full_iterations: int = 5
    subsample_residuals: int = 0
    # "auto" and "pallas" both select the hand-written kNN kernel here;
    # "dense" and "grid" are other engines of the JAX package.
    correspondence: str = "auto"
    # Dense-engine selection knobs of the JAX package.  The port's
    # search is exact, so both are accepted and have no effect.
    knn_exact: int = -1
    knn_precision: str = "high"
    # The port always uses the closed-form deblur Jacobian, which agrees
    # with the JAX package's forward-mode path to f32 round-off.
    deblur_analytic_jacobian: int = 0
    corner_bucket_size: float = 1.5
    surf_bucket_size: float = 1.0


@dataclass(frozen=True)
class MappingConfig:
    matching_mode: int = 0
    input_downsample_mode: int = 1
    init_accumulate_frames: int = 50
    maximum_mapping_buffer: int = 20000000
    maximum_histroy_buffer: int = 400
    maximum_in_fov_angle: float = 45.0
    maximum_pointcloud_delay_time: float = 0.1
    maximum_search_range_corner: float = 100.0
    maximum_search_range_surface: float = 100.0
    surround_pointcloud_resolution: float = 0.30
    max_allow_incre_R: float = 20.0
    max_allow_incre_T: float = 0.3
    max_allow_final_cost: float = 2.0
    history_add_t_step: float = 0.0
    history_add_angle_step: float = 0.0
    # 0 = a rejected frame keeps the previous pose; 1 = coast on the
    # last accepted increment
    reject_recovery_mode: int = 0
    cell_resolution: float = 1.0


@dataclass(frozen=True)
class LoopClosureConfig:
    if_enable_loop_closure: int = 0
    if_dump_keyframe_data: int = 0
    scans_of_each_keyframe: int = 300
    scans_between_two_keyframe: int = 100
    minimum_keyframe_differen: int = 200
    minimum_similarity_linear: float = 0.65
    minimum_similarity_planar: float = 0.94
    map_alignment_resolution: float = 0.1
    maximum_keyframe_in_waiting_list: int = 10
    map_alignment_maximum_icp_iteration: int = 5
    map_alignment_inlier_threshold: float = 0.20
    map_alignment_if_dump_matching_result: int = 0
    if_loop_service_async: int = 1
    scene_alignment_maximum_residual_block: int = 3000
    avail_ratio_plane: float = 0.05
    avail_ratio_line: float = 0.03


@dataclass(frozen=True)
class ParallelConfig:
    mesh_devices: int = 1
    # Layout-deterministic numerics matter only on a device mesh; on one
    # device they are accepted and have no effect.
    deterministic: int = -1
    det_solver: int = -1
    frame_batch: int = 1
    dispatch_chunk: int = 1
    batch_motion_guard_t: float = 0.08


@dataclass(frozen=True)
class CapacityConfig:
    """Buffer sizes.  The port allocates every buffer at these sizes and
    truncates at them exactly as the JAX package does."""
    max_raw_points: int = 16384
    max_splits: int = 512
    max_corner: int = 1024
    max_surface: int = 4096
    max_corner_ds: int = 512
    max_surface_ds: int = 2048
    map_corner_capacity: int = 16384
    map_surf_capacity: int = 65536
    cell_capacity: int = 8192
    cell_point_capacity: int = 32
    cell_max_new_per_frame: int = 512
    corner_bucket_count: int = 8192
    corner_bucket_cap: int = 32
    surf_bucket_count: int = 16384
    surf_bucket_cap: int = 16
    knn_query_tile: int = 1024
    history_window: int = 64
    hist_corner_capacity: int = 512
    hist_surf_capacity: int = 2048
    # The adaptive capacity schedule (runtime/capacity_schedule.py): the
    # pipeline starts max_*_ds, hist_*_capacity and map_*_capacity at
    # 1/schedule_start_scale and doubles them whenever a measured fill
    # crosses schedule_watermark, up to the values above.  Until then
    # the voxel filters that fill those buffers truncate to the tier.
    auto_schedule: int = 1
    schedule_watermark: float = 0.7
    schedule_start_scale: int = 16
    # matching-buffer full-rebuild cadence: 0 = auto (4 with appends)
    matching_rebuild_interval: int = 0
    # append each admitted frame between full rebuilds
    matching_append_mode: int = 1


@dataclass(frozen=True)
class SlamConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    feature_extraction: FeatureExtractionConfig = field(default_factory=FeatureExtractionConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop_closure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **sections) -> "SlamConfig":
        """Copy with whole sections (a dataclass) or fields (a dict)
        replaced: ``cfg.replace(optimization={'icp_maximum_iteration': 10})``."""
        updates: Dict[str, Any] = {}
        for name, val in sections.items():
            cur = getattr(self, name)
            updates[name] = (dataclasses.replace(cur, **val)
                             if isinstance(val, dict) else val)
        return dataclasses.replace(self, **updates)


def reference_path(cfg: SlamConfig) -> None:
    """Raise ``ValueError`` where ``cfg`` leaves the reference's path."""
    c, o, m, p = cfg.common, cfg.optimization, cfg.mapping, cfg.parallel
    why = []
    if c.lidar_type != "livox":
        why.append(f"common/lidar_type={c.lidar_type!r}")
    if m.matching_mode != 0:
        why.append(f"mapping/matching_mode={m.matching_mode}")
    if o.correspondence not in ("auto", "pallas"):
        why.append(f"optimization/correspondence={o.correspondence!r}")
    if o.subsample_residuals:
        why.append("optimization/subsample_residuals")
    if cfg.loop_closure.if_enable_loop_closure:
        why.append("loop_closure/if_enable_loop_closure")
    if p.frame_batch > 1 or p.dispatch_chunk > 1 or p.mesh_devices > 1:
        why.append("parallel dispatch")
    if why:
        raise ValueError("the plain reference does not compute " + ", ".join(why))
