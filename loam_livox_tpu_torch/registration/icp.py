"""Scan-to-map ICP (reference `Point_cloud_registration`,
``source/point_cloud_registration.hpp:163-583``).

    while active and iter < icp_maximum_iteration:
        transform the features by the current increment (+ per-point deblur)
        5-NN correspondences in the corner and surface maps (ops.knn_fused)
        line / plane targets and validity gates
        two-phase robust LM solve of the increment
        convergence test
    degeneracy gate → accept, or roll back to the previous pose

Kept from the reference on purpose: the convergence test compares a
radian angle with ``57.3 * minimum_icp_R_diff`` (:521), and the gate
cost is normalised to the reference's residual-block budget, since this
solver uses every residual.

The outer loop exits early, so the host reads the ``active`` flag once
per iteration: at most ``icp_maximum_iteration`` device syncs a frame
(`SYNCS` counts them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.config import SlamConfig
from ..core.types import PointBatch
from ..ops.knn_fused import build_ref_operand, knn_fused
from . import residuals as res
from .gauss_newton import solve_two_phase

# Map-size gates (reference point_cloud_registration.hpp:29-30)
CORNER_MIN_MAP_NUM = 0
SURFACE_MIN_MAP_NUM = 50

#: host reads of the early-exit flag since the last reset
SYNCS = {"icp_exit": 0}


class RegistrationResult(NamedTuple):
    q_w: torch.Tensor            # accepted world pose (rolled back if rejected)
    t_w: torch.Tensor
    q_incre: torch.Tensor
    t_incre: torch.Tensor
    accepted: torch.Tensor       # bool: degeneracy gate (reference :561-573)
    enabled: torch.Tensor        # bool: whether ICP ran
    final_cost: torch.Tensor
    gate_cost: torch.Tensor
    inlier_threshold: torch.Tensor
    angular_diff_deg: torch.Tensor
    t_diff: torch.Tensor
    n_blocks: torch.Tensor
    iterations: int


def refine_blur(time, tmin, tmax, deblur: bool):
    """Per-point interpolation fraction s ∈ [0, 1]; non-finite clamps to
    1, deblur off gives 1 (reference :128-141)."""
    if not deblur:
        return torch.ones_like(time)
    s = (time - tmin) / torch.clamp(tmax - tmin, min=1e-12)
    s = torch.where(torch.isfinite(s), s, torch.ones_like(s))
    return torch.clamp(s, 0.0, 1.0)


def register_frame(frame_corners: PointBatch, frame_surface: PointBatch,
                   map_corners: PointBatch, map_surface: PointBatch,
                   q_last, t_last, time_min, time_max, enabled: bool,
                   cfg: SlamConfig, q_incre_init=None,
                   t_incre_init=None) -> RegistrationResult:
    """Register one feature frame against the matching buffer.  With
    ``enabled`` false (init window) the frame keeps the previous pose."""
    opt = cfg.optimization
    dev = q_last.device
    deblur = bool(cfg.common.if_motion_deblur)
    s_corner = refine_blur(frame_corners.time, time_min, time_max, deblur)
    s_surf = refine_blur(frame_surface.time, time_min, time_max, deblur)

    map_ok = ((map_corners.mask.sum() > CORNER_MIN_MAP_NUM)
              & (map_surface.mask.sum() > SURFACE_MIN_MAP_NUM))
    run = map_ok & enabled

    if opt.increment_init == 1 and q_incre_init is not None:
        q_incre, t_incre = q_incre_init, t_incre_init
    else:
        q_incre = se3.quat_identity(device=dev)
        t_incre = torch.zeros(3, device=dev)
    zero = torch.zeros((), device=dev)
    final_cost = inlier_threshold = zero
    n_blocks = torch.zeros((), dtype=torch.int32, device=dev)
    iterations = 0

    if enabled:
        # The matching buffer is fixed over the ICP loop: build the
        # kernel's reference operands once.  The query sets are voxel
        # filter outputs (valid prefixes), so their counts bound the
        # query tiles; the radii are the correspondence gates.
        ref_c = build_ref_operand(map_corners.xyz, map_corners.mask)
        ref_s = build_ref_operand(map_surface.xyz, map_surface.mask)
        n_qc = frame_corners.mask.sum(dtype=torch.int32)
        n_qs = frame_surface.mask.sum(dtype=torch.int32)
        radius_c = float(opt.maximum_dis_line_for_match) ** 0.5
        radius_s = float(opt.maximum_dis_plane_for_match) ** 0.5
        q_last_opt, t_last_opt = q_incre, t_incre
        active = run
        while iterations < opt.icp_maximum_iteration:
            SYNCS["icp_exit"] += 1
            if not bool(active):
                break
            qc = res.transform_points_incre(q_incre, t_incre, frame_corners.xyz,
                                            s_corner, q_last, t_last, deblur)
            qs = res.transform_points_incre(q_incre, t_incre, frame_surface.xyz,
                                            s_surf, q_last, t_last, deblur)
            cd, ci = knn_fused(qc, map_corners.xyz, map_corners.mask,
                               k=opt.line_search_num, ref_op=ref_c,
                               query_count=n_qc, max_radius=radius_c)
            sd, si = knn_fused(qs, map_surface.xyz, map_surface.mask,
                               k=opt.plane_search_num, ref_op=ref_s,
                               query_count=n_qs, max_radius=radius_s)
            line_tgt = res.build_line_targets(cd, ci, map_corners.xyz,
                                              frame_corners.mask,
                                              opt.maximum_dis_line_for_match)
            plane_tgt = res.build_plane_targets(sd, si, map_surface.xyz,
                                                frame_surface.mask,
                                                opt.maximum_dis_plane_for_match)
            base_mask = torch.cat([line_tgt.valid, plane_tgt.valid])

            def fj_with_mask(mask, line_tgt=line_tgt, plane_tgt=plane_tgt):
                def fj(q, t):
                    rl = res.line_residuals(q, t, frame_corners.xyz, s_corner,
                                            line_tgt, q_last, t_last, deblur)
                    rp = res.plane_residuals(q, t, frame_surface.xyz, s_surf,
                                             plane_tgt, q_last, t_last, deblur)
                    if deblur:
                        jc = res.point_world_jacobian_deblur(
                            q, t, frame_corners.xyz, s_corner, q_last)
                        js = res.point_world_jacobian_deblur(
                            q, t, frame_surface.xyz, s_surf, q_last)
                    else:
                        jc = res.point_world_jacobian(q, t, frame_corners.xyz, q_last)
                        js = res.point_world_jacobian(q, t, frame_surface.xyz, q_last)
                    J = torch.cat([res.line_jacobian(jc, line_tgt),
                                   res.plane_jacobian(js, plane_tgt)])
                    return torch.cat([rl, rp]), J, mask
                return fj

            q_new, t_new, info = solve_two_phase(fj_with_mask, base_mask,
                                                 q_incre, t_incre, opt)
            ang = se3.quat_angular_distance(q_last_opt, q_new)
            converged = ((ang < 57.3 * opt.minimum_icp_R_diff)
                         & (torch.linalg.vector_norm(t_last_opt - t_new)
                            < opt.minimum_icp_T_diff))
            q_incre, t_incre = q_new, t_new
            q_last_opt, t_last_opt = q_new, t_new
            active = ~converged
            final_cost, inlier_threshold = info.final_cost, info.inlier_threshold
            n_blocks = info.n_blocks
            iterations += 1

    q_w = se3.quat_multiply(q_last, q_incre)
    t_w = se3.quat_rotate(q_last, t_incre) + t_last
    angular_diff = se3.quat_angular_distance(q_w, q_last) * 57.3
    t_diff = torch.linalg.vector_norm(t_w - t_last)
    budget = float(max(opt.maximum_residual_blocks, 1))
    nb = torch.clamp(n_blocks.to(torch.float32), min=1.0)
    gate_cost = final_cost * torch.clamp(budget / nb, max=1.0)
    reject = run & ((angular_diff > opt.max_allow_incre_R)
                    | (gate_cost > opt.max_allow_final_cost))
    accepted = ~reject
    keep_w = run & accepted
    ident_q = se3.quat_identity(device=dev)
    zero_t = torch.zeros(3, device=dev)
    return RegistrationResult(
        q_w=torch.where(keep_w, q_w, q_last),
        t_w=torch.where(keep_w, t_w, t_last),
        q_incre=torch.where(keep_w, q_incre, ident_q),
        t_incre=torch.where(keep_w, t_incre, zero_t),
        accepted=accepted,
        enabled=run,
        final_cost=final_cost,
        gate_cost=gate_cost,
        # a registration that never ran reads as a rejection downstream
        inlier_threshold=torch.where(run, inlier_threshold,
                                     torch.full((), 1e9, device=dev)),
        angular_diff_deg=angular_diff,
        t_diff=t_diff,
        n_blocks=n_blocks,
        iterations=iterations,
    )
