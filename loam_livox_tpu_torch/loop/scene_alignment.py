"""Map-to-map scene alignment for loop-closure verification (reference
`Scene_alignment`, ``source/scene_alignment.hpp:220-391``), the
counterpart of ``loam_livox_tpu/loop/scene_alignment.py``.

Registers keyframe B's feature cells onto keyframe A's with the
odometry's scan-to-map ICP (`registration.icp.register_frame`, whose
correspondence search is the ``knn_fused`` kernel on the card) in the
reference's relaxed loop-closure settings (``init()`` /
``find_tranfrom_of_two_mappings``):

* plane residuals only (``ICP_LINE = 0``, :233): the line frame is
  blanked, the line map stays for the map-size gate;
* coarse to fine: leaves ×8, ×4, ×1 of ``map_alignment_resolution``
  (:313-330), twice the ICP iterations at the finest (:325-328);
* inlier distance 0.2 m, residual cap 3000, degeneracy gates off
  (:238-244);
* a break when a scale's score is over twice the accept threshold
  (:352-353): one host read a scale.

Returns the transform taking keyframe-B coordinates into keyframe A's
frame and the inlier-threshold score the loop gate compares with
``map_alignment_inlier_threshold`` (reference laser_mapping.hpp:1054).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import accounting, se3
from ..core.config import SlamConfig
from ..core.types import PointBatch
from ..map.cell_map import CellMap, cell_features, gather_cell_points
from ..ops.voxel import voxel_downsample
from ..registration.icp import register_frame

#: host reads of a scale's score (the coarse-to-fine break) outside the
#: loop service's own tally
SYNCS = {"align_exit": 0}


class AlignmentResult(NamedTuple):
    q: torch.Tensor                 # B → A rotation (wxyz)
    t: torch.Tensor                 # B → A translation
    inlier_threshold: torch.Tensor  # the accept score (lower is better)
    scales_run: int


def extract_cells_of_type(m: CellMap, member: torch.Tensor, ftype: int,
                          incremental: bool = True) -> PointBatch:
    """Pools of the member cells classified as ``ftype`` (reference
    `extract_specify_points`, cell_map_keyframe.hpp:974-988)."""
    feats = cell_features(m, incremental=incremental)
    return gather_cell_points(m, member & m.valid() & (feats.feature_type == ftype))


def _loop_cfg(base: SlamConfig, icp_iterations: int) -> SlamConfig:
    """The registration settings of scene alignment (reference
    scene_alignment.hpp:233-244, 296-300)."""
    return base.replace(
        optimization={
            "icp_maximum_iteration": icp_iterations,
            "inlier_dis": 0.2,
            "maximum_residual_blocks":
                base.loop_closure.scene_alignment_maximum_residual_block,
            "subsample_residuals": 0,
            "max_allow_final_cost": 1e9,     # m_max_final_cost = 20000
            "max_allow_incre_R": 1e9,        # max_angular_rate 360*57.3
            "max_allow_incre_T": 1e6,        # max_speed 1000
            "full_iterations": 8,
        },
        common={"if_motion_deblur": 0},
    )


def align_keyframes(src_line: PointBatch, src_plane: PointBatch,
                    tgt_line: PointBatch, tgt_plane: PointBatch,
                    center_a: torch.Tensor, center_b: torch.Tensor,
                    cfg: SlamConfig, work_capacity: int = 8192,
                    init_t=None) -> AlignmentResult:
    """Align keyframe B (``tgt_*``) onto keyframe A (``src_*``).

    ``init_t`` is the starting translation; None takes the reference's
    centre difference (scene_alignment.hpp:303-306).  The loop service
    passes zeros: both keyframes lie in the same drifted world frame, and
    the centre difference, dominated by the keyframes' different
    coverage, seeds the plane-only ICP into wrong basins (the JAX
    package's forensics, its ``align_keyframes`` docstring).

    ``work_capacity`` bounds each voxel-filtered batch (past it the
    filter keeps the smallest voxel keys)."""
    lc = cfg.loop_closure
    dev = src_plane.xyz.device
    q = se3.quat_identity(device=dev)
    t = ((center_a - center_b).to(torch.float32) if init_t is None
         else torch.as_tensor(init_t, dtype=torch.float32, device=dev))
    inlier = torch.full((), 1e9, device=dev)
    t_min = torch.zeros((), device=dev)
    t_max = torch.ones((), device=dev)

    scales_run = 0
    for scale in (8, 4, 1):
        iters = lc.map_alignment_maximum_icp_iteration * (2 if scale == 1 else 1)
        leaf = max(lc.map_alignment_resolution * scale, lc.map_alignment_resolution)
        map_line = voxel_downsample(src_line, leaf, capacity=work_capacity)
        map_plane = voxel_downsample(src_plane, leaf, capacity=work_capacity)
        frm_line = voxel_downsample(tgt_line, leaf, capacity=work_capacity)
        frm_plane = voxel_downsample(tgt_plane, leaf, capacity=work_capacity)
        frm_line = frm_line._replace(mask=torch.zeros_like(frm_line.mask))

        reg = register_frame(frm_line, frm_plane, map_line, map_plane, q, t,
                             t_min, t_max, True, _loop_cfg(cfg, iters))
        q, t, inlier = reg.q_w, reg.t_w, reg.inlier_threshold
        scales_run += 1
        accounting.count(SYNCS, "align_exit")
        if float(inlier) > 2.0 * lc.map_alignment_inlier_threshold:
            break  # reference :352-353
    return AlignmentResult(q=q, t=t, inlier_threshold=inlier, scales_run=scales_run)
