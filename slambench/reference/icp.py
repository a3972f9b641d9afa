"""The plain reference's scan-to-map ICP: a frozen copy of the program's
plain registration (the lane-batched pass, its carry and its gates,
the loop on the host), with the correspondences from the exact plain
k-NN search of `ops.knn` in place of the program's kernel.  Residual
subsampling is off on the reference's path, so the carry holds no key.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import residuals as res
from . import se3
from .config import SlamConfig
from .gauss_newton import solve_two_phase
from .ops import PointBatch, knn

# Map-size gates (reference point_cloud_registration.hpp:29-30)
CORNER_MIN_MAP_NUM = 0
SURFACE_MIN_MAP_NUM = 50

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
    iterations: int | torch.Tensor   # one lane: a host int; lanes: (L,) int32


def refine_blur(time, tmin, tmax, deblur: bool):
    """Per-point interpolation fraction s ∈ [0, 1]; non-finite clamps to
    1, deblur off gives 1 (reference :128-141)."""
    if not deblur:
        return torch.ones_like(time)
    s = (time - tmin) / torch.clamp(tmax - tmin, min=1e-12)
    s = torch.where(torch.isfinite(s), s, torch.ones_like(s))
    return torch.clamp(s, 0.0, 1.0)


def _searcher(ref: PointBatch, k: int, radius: float):
    """``search(queries, counts)`` over one matching buffer: the exact
    plain k-NN (`ops.knn`), lane by lane."""
    return lambda q, counts: knn(q, ref.xyz, ref.mask, k, counts, radius)


class ICPCarry(NamedTuple):
    """What one ICP pass hands the next, every field a tensor with the
    lane axis (``loops`` a scalar): the loop state of the JAX package's
    ``lax.while_loop`` (``loam_livox_tpu/registration/icp.py:287-319``),
    so that a pass is a function of tensors alone, run by the host loop."""
    q_incre: torch.Tensor           # (L, 4) current increment
    t_incre: torch.Tensor           # (L, 3)
    final_cost: torch.Tensor        # (L,)
    inlier_threshold: torch.Tensor  # (L,)
    n_blocks: torch.Tensor          # (L,) int32
    iterations: torch.Tensor        # (L,) int32 passes each lane ran
    active: torch.Tensor            # (L,) bool: not converged, not frozen
    loops: torch.Tensor             # () int32 passes the loop made


def _enabled_lanes(enabled, n_lanes: int, dev) -> torch.Tensor | None:
    """``enabled`` (host bools, bool tensors) as an (L,) bool tensor, or
    None where host flags enable every lane."""
    if isinstance(enabled, torch.Tensor):
        return enabled.reshape(n_lanes).to(device=dev, dtype=torch.bool)
    if all(isinstance(e, (bool, np.bool_)) for e in enabled):
        return None if all(enabled) else torch.tensor([bool(e) for e in enabled], device=dev)
    return torch.stack([torch.as_tensor(e, device=dev).reshape(()) for e in enabled])


def _none_enabled(enabled) -> bool:
    """Whether host flags enable no lane (known without a device read)."""
    return (not isinstance(enabled, torch.Tensor)
            and all(isinstance(e, (bool, np.bool_)) and not e for e in enabled))


def prepare_registration(frame_corners: PointBatch, frame_surface: PointBatch,
                         map_corners: PointBatch, map_surface: PointBatch,
                         q_last, t_last, time_min, time_max, enabled,
                         cfg: SlamConfig, q_incre_init=None, t_incre_init=None):
    """The program's lane-batched registration up to its loop, searched
    by the exact plain k-NN: ``(icp_pass, carry, finish)``."""
    opt = cfg.optimization
    dev = q_last.device
    n_lanes = q_last.shape[0]
    deblur = bool(cfg.common.if_motion_deblur)
    s_corner = refine_blur(frame_corners.time, time_min[:, None], time_max[:, None], deblur)
    s_surf = refine_blur(frame_surface.time, time_min[:, None], time_max[:, None], deblur)

    map_ok = ((map_corners.mask.sum() > CORNER_MIN_MAP_NUM)
              & (map_surface.mask.sum() > SURFACE_MIN_MAP_NUM))
    en = _enabled_lanes(enabled, n_lanes, dev)
    run = map_ok.expand(n_lanes) if en is None else map_ok & en

    if opt.increment_init == 1 and q_incre_init is not None:
        q_incre, t_incre = q_incre_init, t_incre_init
    else:
        q_incre = se3.quat_identity(device=dev).expand(n_lanes, 4)
        t_incre = torch.zeros((n_lanes, 3), device=dev)
    zeros_f = torch.zeros(n_lanes, device=dev)
    zeros_i = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    carry = ICPCarry(q_incre=q_incre, t_incre=t_incre, final_cost=zeros_f,
                     inlier_threshold=zeros_f, n_blocks=zeros_i, iterations=zeros_i,
                     active=run, loops=torch.zeros((), dtype=torch.int32, device=dev))

    search_c = search_s = None
    if not _none_enabled(enabled):
        search_c = _searcher(map_corners, opt.line_search_num,
                             float(opt.maximum_dis_line_for_match) ** 0.5)
        search_s = _searcher(map_surface, opt.plane_search_num,
                             float(opt.maximum_dis_plane_for_match) ** 0.5)
    n_qc = frame_corners.mask.sum(dim=-1, dtype=torch.int32)
    n_qs = frame_surface.mask.sum(dim=-1, dtype=torch.int32)
    no_queries = torch.zeros((), dtype=torch.int32, device=dev)

    def icp_pass(c: ICPCarry) -> ICPCarry:
        active = c.active
        qc = res.transform_points_incre(c.q_incre, c.t_incre, frame_corners.xyz,
                                        s_corner, q_last, t_last, deblur)
        qs = res.transform_points_incre(c.q_incre, c.t_incre, frame_surface.xyz,
                                        s_surf, q_last, t_last, deblur)
        # a frozen lane's results are discarded: give it no queries
        cd, ci = search_c(qc, torch.where(active, n_qc, no_queries))
        sd, si = search_s(qs, torch.where(active, n_qs, no_queries))
        line_tgt = res.build_line_targets(cd, ci, map_corners.xyz, frame_corners.mask,
                                          opt.maximum_dis_line_for_match)
        plane_tgt = res.build_plane_targets(sd, si, map_surface.xyz, frame_surface.mask,
                                            opt.maximum_dis_plane_for_match)
        base_mask = torch.cat([line_tgt.valid, plane_tgt.valid], dim=-1)
        def fj_with_mask(mask):
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
                               res.plane_jacobian(js, plane_tgt)], dim=-3)
                return torch.cat([rl, rp], dim=-2), J, mask
            return fj

        q_new, t_new, info = solve_two_phase(fj_with_mask, base_mask,
                                             c.q_incre, c.t_incre, opt)
        # the increment is also the last optimum the test compares with
        ang = se3.quat_angular_distance(c.q_incre, q_new)
        converged = ((ang < 57.3 * opt.minimum_icp_R_diff)
                     & (torch.linalg.vector_norm(c.t_incre - t_new, dim=-1)
                        < opt.minimum_icp_T_diff))
        step = active[:, None]
        return ICPCarry(
            q_incre=torch.where(step, q_new, c.q_incre),
            t_incre=torch.where(step, t_new, c.t_incre),
            final_cost=torch.where(active, info.final_cost, c.final_cost),
            inlier_threshold=torch.where(active, info.inlier_threshold, c.inlier_threshold),
            n_blocks=torch.where(active, info.n_blocks, c.n_blocks),
            iterations=c.iterations + active.to(torch.int32),
            active=active & ~converged,
            loops=c.loops + 1)

    def finish(c: ICPCarry) -> RegistrationResult:
        q_w = se3.quat_multiply(q_last, c.q_incre)
        t_w = se3.quat_rotate(q_last, c.t_incre) + t_last
        angular_diff = se3.quat_angular_distance(q_w, q_last) * 57.3
        t_diff = torch.linalg.vector_norm(t_w - t_last, dim=-1)
        budget = float(max(opt.maximum_residual_blocks, 1))
        nb = torch.clamp(c.n_blocks.to(torch.float32), min=1.0)
        gate_cost = c.final_cost * torch.clamp(budget / nb, max=1.0)
        reject = run & ((angular_diff > opt.max_allow_incre_R)
                        | (gate_cost > opt.max_allow_final_cost))
        accepted = ~reject
        keep_w = (run & accepted)[:, None]
        ident_q = se3.quat_identity(device=dev)
        zero_t = torch.zeros(3, device=dev)
        return RegistrationResult(
            q_w=torch.where(keep_w, q_w, q_last),
            t_w=torch.where(keep_w, t_w, t_last),
            q_incre=torch.where(keep_w, c.q_incre, ident_q),
            t_incre=torch.where(keep_w, c.t_incre, zero_t),
            accepted=accepted,
            enabled=run,
            final_cost=c.final_cost,
            gate_cost=gate_cost,
            # a registration that never ran reads as a rejection downstream
            inlier_threshold=torch.where(run, c.inlier_threshold,
                                         torch.full((), 1e9, device=dev)),
            angular_diff_deg=angular_diff,
            t_diff=t_diff,
            n_blocks=c.n_blocks,
            iterations=c.iterations,
        )

    return icp_pass, carry, finish


def run_host_loop(icp_pass, carry: ICPCarry, max_loops: int) -> Tuple[ICPCarry, int]:
    """The ICP loop on the host: passes while any lane is active, at most
    ``max_loops``; one host read of ``active`` before each pass.
    Returns the carry and the passes made."""
    loops = 0
    while loops < max_loops:
        if not bool(carry.active.any()):
            break
        carry = icp_pass(carry)
        loops += 1
    return carry, loops


def lane(result: RegistrationResult, k: int) -> RegistrationResult:
    """Lane ``k`` of a lane-batched result."""
    return RegistrationResult(*(x[k] for x in result))


def prepare_frame(frame_corners: PointBatch, frame_surface: PointBatch,
                  map_corners: PointBatch, map_surface: PointBatch,
                  q_last, t_last, time_min, time_max, enabled, cfg: SlamConfig,
                  q_incre_init=None, t_incre_init=None):
    """The one-lane `prepare_registration` (``enabled`` a host bool or a
    bool scalar tensor): ``finish`` returns
    lane 0, ``iterations`` a device scalar."""
    def one(x):
        return None if x is None else x[None]

    def batch(b: PointBatch) -> PointBatch:
        return PointBatch(*(x[None] for x in b))

    icp_pass, carry, finish = prepare_registration(
        batch(frame_corners), batch(frame_surface), map_corners, map_surface,
        one(q_last), one(t_last), one(time_min), one(time_max),
        enabled.reshape(1) if isinstance(enabled, torch.Tensor) else [enabled], cfg,
        q_incre_init=one(q_incre_init), t_incre_init=one(t_incre_init))
    return icp_pass, carry, lambda c: lane(finish(c), 0)


def register_on_host(icp_pass, carry: ICPCarry, finish, max_loops: int,
                     skip: bool = False) -> RegistrationResult:
    """One lane of `prepare_frame` run to its end: the loop on the host
    (`run_host_loop`; none with ``skip``, when host flags enable no
    lane), then the gates, ``iterations`` the passes made (a host int:
    one lane runs exactly as many iterations as the loop made passes)."""
    loops = 0
    if not skip:
        carry, loops = run_host_loop(icp_pass, carry, max_loops)
    return finish(carry)._replace(iterations=loops)
