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

`prepare_registration` registers L frames at once against one matching
buffer (the racing path, `runtime.batched.prepare_group`; the
counterpart of ``jax.vmap(register_frame)`` in
``loam_livox_tpu/runtime/batched.py:76-85``): every tensor gains a
leading lane axis, the kNN kernel takes all lanes in one launch, and
the 6×6 solves are batched.  As under ``vmap``, the loop runs until
every lane has converged, and a lane that has converged (or never ran)
is frozen: its increment, cost and block count stop changing.
`register_frame` is the one-lane case.

The correspondence engine follows ``optimization/correspondence``:
``auto`` and ``pallas`` search with the hand-written kernel
(`ops.knn_fused`); ``grid`` with the bucket grids over the matching
buffer (`ops.bucket_grid`), when the state carries them; ``dense`` (and
``grid`` without grids) with `ops.knn.knn_dense`, which ranks as the JAX
package's dense engine does.  Under a product mesh
(`parallel.mesh.active_mesh`) the kernel's search runs sharded over the
ranks (`parallel.sharded.knn_sharded`), bit for bit the same result;
a buffer past the kernel's largest operand is searched in row blocks,
merged the same way (`_searcher`).

The outer loop is the JAX package's ``lax.while_loop``: a pass is a
function of a carry of tensors (`prepare_registration` returns the pass,
the first carry and the gates after the loop), and passes run while
any lane is active, at most ``icp_maximum_iteration``.  The plain
program runs them under a host loop (`run_host_loop`) that reads
``active`` before each pass (at most ``icp_maximum_iteration`` + 1
device syncs a registration, `SYNCS`
counts them; none when host flags enable no lane).  The frame program
(`runtime.frame_program`) runs the same pass as the body of a CUDA graph
WHILE node, whose condition kernel reads ``active`` on the card.

The carry holds the registration's threefry key (`ops.threefry`), and
every pass splits it as the JAX loop does
(``loam_livox_tpu/registration/icp.py:235-237``), drawing residual
subsampling's keep mask (``optimization/subsample_residuals``, the
reference's residual-block cap) from the second half: the JAX package's
own numbers, and a pure function of the carry, so that a replayed WHILE
body draws anew each pass.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import accounting, se3
from ..core.config import SlamConfig
from ..core.types import PointBatch, to_device
from ..ops.bucket_grid import BucketGrid, grid_knn
from ..ops.knn import knn_dense
from ..ops.knn_fused import build_ref_operand, knn_fused, max_ref_rows
from ..ops.masked import random_keep_mask
from ..ops.threefry import split
from ..parallel import mesh
from ..utils.logging import SPAN_PASS, SPAN_QUERY, spans
from . import residuals as res
from .gauss_newton import solve_two_phase

# Map-size gates (reference point_cloud_registration.hpp:29-30)
CORNER_MIN_MAP_NUM = 0
SURFACE_MIN_MAP_NUM = 50

#: host reads of the early-exit flag since the last reset (the loop
#: service's registrations count into its own tally, `core.accounting`)
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
    iterations: int | torch.Tensor   # one lane: a host int; lanes: (L,) int32


def refine_blur(time, tmin, tmax, deblur: bool):
    """Per-point interpolation fraction s ∈ [0, 1]; non-finite clamps to
    1, deblur off gives 1 (reference :128-141)."""
    if not deblur:
        return torch.ones_like(time)
    s = (time - tmin) / torch.clamp(tmax - tmin, min=1e-12)
    s = torch.where(torch.isfinite(s), s, torch.ones_like(s))
    return torch.clamp(s, 0.0, 1.0)


def resolve_correspondence_engine(opt, grids: bool) -> str:
    """``pallas`` (the kernel) for ``auto`` and ``pallas``; ``grid`` when
    asked and the grids are there; else ``dense`` (as the JAX search
    block falls through, ``loam_livox_tpu/registration/icp.py:178-210``)."""
    if opt.correspondence in ("auto", "pallas"):
        return "pallas"
    return "grid" if opt.correspondence == "grid" and grids else "dense"


def _searcher(engine: str, ref: PointBatch, grid: BucketGrid | None, k: int,
              radius: float, query_tile: int, max_rows: int | None = None):
    """``search(queries, counts)`` over one matching buffer: its kernel
    operand (or the rank's shard of it) is built once a registration.  A
    buffer past ``max_rows`` rows (default: the kernel's largest operand
    on the card, `ops.knn_fused.max_ref_rows`; no limit on the CPU) is
    searched in row blocks of at most ``max_rows``, one operand and one
    kernel launch a block, their candidates merged by (distance, index)
    as `parallel.sharded.knn_sharded` merges its ranks': bit for bit the
    search of the whole buffer."""
    if engine == "grid":
        return lambda q, counts: grid_knn(q, grid, k=k)
    if engine == "dense":
        return lambda q, counts: knn_dense(q, ref.xyz, ref.mask, k=k, query_tile=query_tile)
    group = mesh.active_mesh()
    if group is not None and ref.capacity % group.size == 0:
        # the layout shards the buffer's point axis when it divides
        from ..parallel.sharded import knn_sharded, shard_rows

        rows = shard_rows(ref.capacity, group)
        ref_op = build_ref_operand(ref.xyz[rows], ref.mask[rows])
        return lambda q, counts: knn_sharded(q, ref.xyz, ref.mask, group, k=k,
                                             query_count=counts, max_radius=radius,
                                             ref_op=ref_op)
    if max_rows is None and ref.xyz.device.type == "cuda":
        max_rows = max_ref_rows(k)
    if max_rows is None or ref.capacity <= max_rows:
        ref_op = build_ref_operand(ref.xyz, ref.mask)
        return lambda q, counts: knn_fused(q, ref.xyz, ref.mask, k=k, ref_op=ref_op,
                                           query_count=counts, max_radius=radius)
    from ..ops.knn import finish
    from ..parallel.sharded import merge_candidates

    blocks = [slice(lo, min(lo + max_rows, ref.capacity))
              for lo in range(0, ref.capacity, max_rows)]
    ops = [build_ref_operand(ref.xyz[b], ref.mask[b]) for b in blocks]

    def search(q, counts):
        parts = [knn_fused(q, ref.xyz[b], ref.mask[b], k=k, ref_op=op, query_count=counts,
                           max_radius=radius) for b, op in zip(blocks, ops)]
        d, i = merge_candidates(torch.cat([d for d, _ in parts], dim=-1),
                                torch.cat([i + b.start for b, (_, i) in zip(blocks, parts)],
                                          dim=-1), k)
        return finish(d, i, None)
    return search


class ICPCarry(NamedTuple):
    """What one ICP pass hands the next, every field a tensor with the
    lane axis (``loops`` a scalar): the loop state of the JAX package's
    ``lax.while_loop`` (``loam_livox_tpu/registration/icp.py:287-319``),
    so that a pass is a function of tensors alone, run by the host loop
    or captured as the body of a CUDA graph WHILE node
    (`runtime.frame_program`)."""
    q_incre: torch.Tensor           # (L, 4) current increment
    t_incre: torch.Tensor           # (L, 3)
    final_cost: torch.Tensor        # (L,)
    inlier_threshold: torch.Tensor  # (L,)
    n_blocks: torch.Tensor          # (L,) int32
    iterations: torch.Tensor        # (L,) int32 passes each lane ran
    active: torch.Tensor            # (L,) bool: not converged, not frozen
    loops: torch.Tensor             # () int32 passes the loop made
    key: Optional[torch.Tensor] = None  # (L, 2) uint32 threefry key, split every pass


def _enabled_lanes(enabled, n_lanes: int, dev) -> torch.Tensor | None:
    """``enabled`` (host bools, bool tensors) as an (L,) bool tensor, or
    None where host flags enable every lane."""
    if isinstance(enabled, torch.Tensor):
        return enabled.reshape(n_lanes).to(device=dev, dtype=torch.bool)
    if all(isinstance(e, (bool, np.bool_)) for e in enabled):
        return None if all(enabled) else to_device(np.asarray([bool(e) for e in enabled]), dev)
    return torch.stack([torch.as_tensor(e, device=dev).reshape(()) for e in enabled])


def _none_enabled(enabled) -> bool:
    """Whether host flags enable no lane (known without a device read)."""
    return (not isinstance(enabled, torch.Tensor)
            and all(isinstance(e, (bool, np.bool_)) and not e for e in enabled))


def prepare_registration(frame_corners: PointBatch, frame_surface: PointBatch,
                         map_corners: PointBatch, map_surface: PointBatch,
                         q_last, t_last, time_min, time_max, enabled,
                         cfg: SlamConfig, q_incre_init=None, t_incre_init=None,
                         rng: torch.Tensor | None = None,
                         grid_corners: BucketGrid | None = None,
                         grid_surface: BucketGrid | None = None):
    """A lane-batched registration of L feature frames (every tensor with
    a leading lane axis: frames (L, N, ...), start poses (L, 4) / (L, 3),
    times (L,)) against one matching buffer, up to its loop.  ``enabled``
    holds one flag a lane (host bools, or bool tensors: an (L,) tensor
    or a list of scalars); a lane that is not enabled (init window)
    keeps its start pose.  ``rng`` is an (L, 2) uint32 threefry key a
    lane (`ops.threefry`), which the carry holds and every pass splits,
    as the JAX loop does (``loam_livox_tpu/registration/icp.py:235``),
    drawing residual subsampling's uniforms from the second half when
    that is on; without one (the loop service's scene alignment, which
    never subsamples) the carry holds none.  The bucket grids over the buffer
    serve the ``grid`` engine.  Returns
    ``(icp_pass, carry, finish)``, the pass ``ICPCarry -> ICPCarry``,
    the carry before the first pass and ``finish(carry) ->
    RegistrationResult``, the gates after the last.  Neither reads a
    device value on the host, so all three can be captured into a CUDA
    graph; the loop around them decides how many passes run (at most
    ``icp_maximum_iteration``, while any lane is active)."""
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
    if rng is None and opt.subsample_residuals > 0:
        raise ValueError("residual subsampling draws from a key: pass rng")
    carry = ICPCarry(q_incre=q_incre, t_incre=t_incre, final_cost=zeros_f,
                     inlier_threshold=zeros_f, n_blocks=zeros_i, iterations=zeros_i,
                     active=run, loops=torch.zeros((), dtype=torch.int32, device=dev),
                     key=None if rng is None else rng.reshape(n_lanes, 2))

    # The matching buffer is fixed over the ICP loop: build the kernel's
    # reference operands once.  The query sets are voxel filter outputs
    # (valid prefixes), so their counts bound the query tiles; the radii
    # are the correspondence gates.
    engine = resolve_correspondence_engine(
        opt, grid_corners is not None and grid_surface is not None)
    tile = cfg.capacity.knn_query_tile
    search_c = search_s = None
    if not _none_enabled(enabled):
        search_c = _searcher(engine, map_corners, grid_corners, opt.line_search_num,
                             float(opt.maximum_dis_line_for_match) ** 0.5, tile)
        search_s = _searcher(engine, map_surface, grid_surface, opt.plane_search_num,
                             float(opt.maximum_dis_plane_for_match) ** 0.5, tile)
    n_qc = frame_corners.mask.sum(dim=-1, dtype=torch.int32)
    n_qs = frame_surface.mask.sum(dim=-1, dtype=torch.int32)
    no_queries = torch.zeros((), dtype=torch.int32, device=dev)

    def icp_pass(c: ICPCarry) -> ICPCarry:
        with spans.device(SPAN_PASS, c.q_incre):
            return one_pass(c)

    def one_pass(c: ICPCarry) -> ICPCarry:
        active = c.active
        qc = res.transform_points_incre(c.q_incre, c.t_incre, frame_corners.xyz,
                                        s_corner, q_last, t_last, deblur)
        qs = res.transform_points_incre(c.q_incre, c.t_incre, frame_surface.xyz,
                                        s_surf, q_last, t_last, deblur)
        # a frozen lane's results are discarded: give it no queries
        with spans.device(SPAN_QUERY, qc):
            cd, ci = search_c(qc, torch.where(active, n_qc, no_queries))
        with spans.device(SPAN_QUERY, qs):
            sd, si = search_s(qs, torch.where(active, n_qs, no_queries))
        line_tgt = res.build_line_targets(cd, ci, map_corners.xyz, frame_corners.mask,
                                          opt.maximum_dis_line_for_match)
        plane_tgt = res.build_plane_targets(sd, si, map_surface.xyz, frame_surface.mask,
                                            opt.maximum_dis_plane_for_match)
        base_mask = torch.cat([line_tgt.valid, plane_tgt.valid], dim=-1)
        key = None
        if c.key is not None:
            keys = split(c.key)
            key = keys[:, 0]
            if opt.subsample_residuals > 0:
                base_mask = random_keep_mask(base_mask, opt.subsample_residuals, keys[:, 1])

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
            loops=c.loops + 1,
            key=key)

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
    ``max_loops``; one host read of ``active`` before each pass (`SYNCS`).
    Returns the carry and the passes made."""
    loops = 0
    while loops < max_loops:
        accounting.count(SYNCS, "icp_exit")
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
                  q_incre_init=None, t_incre_init=None,
                  rng: torch.Tensor | None = None,
                  grid_corners: BucketGrid | None = None,
                  grid_surface: BucketGrid | None = None):
    """The one-lane `prepare_registration` (``enabled`` a host bool or a
    bool scalar tensor; ``rng`` a (2,) key or None): ``finish`` returns
    lane 0, ``iterations`` a device scalar."""
    def one(x):
        return None if x is None else x[None]

    def batch(b: PointBatch) -> PointBatch:
        return PointBatch(*(x[None] for x in b))

    icp_pass, carry, finish = prepare_registration(
        batch(frame_corners), batch(frame_surface), map_corners, map_surface,
        one(q_last), one(t_last), one(time_min), one(time_max),
        enabled.reshape(1) if isinstance(enabled, torch.Tensor) else [enabled], cfg,
        q_incre_init=one(q_incre_init), t_incre_init=one(t_incre_init), rng=rng,
        grid_corners=grid_corners, grid_surface=grid_surface)
    return icp_pass, carry, lambda c: lane(finish(c), 0)


def register_frame(frame_corners: PointBatch, frame_surface: PointBatch,
                   map_corners: PointBatch, map_surface: PointBatch,
                   q_last, t_last, time_min, time_max, enabled,
                   cfg: SlamConfig, q_incre_init=None,
                   t_incre_init=None, rng: torch.Tensor | None = None,
                   grid_corners: BucketGrid | None = None,
                   grid_surface: BucketGrid | None = None) -> RegistrationResult:
    """Register one feature frame against the matching buffer: the
    one-lane case of `register_frames`, with ``iterations`` a host int.
    With ``enabled`` false (init window) the frame keeps the previous
    pose."""
    icp_pass, carry, finish = prepare_frame(
        frame_corners, frame_surface, map_corners, map_surface, q_last, t_last,
        time_min, time_max, enabled, cfg, q_incre_init, t_incre_init, rng,
        grid_corners, grid_surface)
    return register_on_host(icp_pass, carry, finish, cfg.optimization.icp_maximum_iteration,
                            skip=_none_enabled([enabled]))


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
