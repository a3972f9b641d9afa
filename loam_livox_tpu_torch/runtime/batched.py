"""Racing registration: the reference's worker pool
(``common/maximum_parallel_thread``, reference
``laser_mapping.hpp:1737-1742``) as one lane-batched registration, the
counterpart of ``loam_livox_tpu/runtime/batched.py``.

L = G·P piece frames (G raw frames, P pieces each, lane k·P + q = frame
k, piece q) register against the shared matching buffer, each from a
constant-velocity coast of the state's pose (lane k starts k steps
ahead, the staleness of the reference's racing workers), then commit in
time order.  One lane-batched registration does the registration: every
lane's kNN in one kernel launch per search, the solves batched.  The
input voxel filter and the commits loop over the lanes on the host.

The step is split as the sequential one is (`odometry.prepare_step`,
`odometry.commit_history`): `prepare_group` up to the ICP loop,
`commit_lane` a lane's commit up to its matching-buffer update.  The
plain program (`odometry_step_batched`) runs the loop on the host and
applies each update by selecting; the frame program
(`runtime.frame_program`) captures the same functions into one CUDA
graph a group, the loop as a WHILE node and each update as a SWITCH node.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch

from ..core import se3
from ..core.config import SlamConfig
from ..core.types import FeatureFrame, PointBatch
from ..ops.threefry import split
from ..utils.logging import SPAN_SETUP, spans
from ..registration.icp import (ICPCarry, RegistrationResult, lane, prepare_registration,
                                run_host_loop)
from .odometry import (MatchingUpdate, OdometryState, commit_history, input_downsample,
                       update_matching)


def stack_batches(batches: List[PointBatch]) -> PointBatch:
    return PointBatch(*(torch.stack(parts) for parts in zip(*batches)))


class Group(NamedTuple):
    """A racing group up to its ICP loop (`prepare_group`)."""
    q_inits: List[torch.Tensor]     # each lane's coasted start pose
    t_inits: List[torch.Tensor]
    enabled: torch.Tensor           # (L,) bool: the lane's step is past the init window
    inputs: list                    # each lane's (corner_in, surf_in) input filters
    icp_pass: Callable[[ICPCarry], ICPCarry]
    carry: ICPCarry                 # before the first pass
    finish: Callable[[ICPCarry], RegistrationResult]
    rng: torch.Tensor               # the state's next key (lane 0 commits it)


def prepare_group(state: OdometryState, frames: List[FeatureFrame], cfg: SlamConfig) -> Group:
    """The lanes' coasted start poses, their enabled flags (device bools
    from ``state.frame_count + k``), input filters, the state's key split
    into its next key and one key a lane (``loam_livox_tpu/runtime/
    batched.py:70-71``), and the lane-batched registration's pass, first
    carry and gates (`registration.icp.prepare_registration`).  Reads
    nothing on the host."""
    with spans.device(SPAN_SETUP, state.t_w):
        return _prepare_group(state, frames, cfg)


def _prepare_group(state: OdometryState, frames: List[FeatureFrame], cfg: SlamConfig) -> Group:
    n_lanes = len(frames)
    # worker start poses: constant-velocity coast of the entry pose
    q_inits, t_inits = [], []
    qk, tk = state.q_w, state.t_w
    for _ in range(n_lanes):
        q_inits.append(qk)
        t_inits.append(tk)
        tk = se3.quat_rotate(qk, state.last_t_incre) + tk
        qk = se3.quat_normalize(se3.quat_multiply(qk, state.last_q_incre))
    enabled = torch.stack([state.frame_count + k >= cfg.mapping.init_accumulate_frames
                           for k in range(n_lanes)])
    inputs = [input_downsample(f, cfg) for f in frames]
    keys = split(state.rng)
    icp_pass, carry, finish = prepare_registration(
        stack_batches([c for c, _ in inputs]), stack_batches([s for _, s in inputs]),
        state.map_corners, state.map_surface, torch.stack(q_inits), torch.stack(t_inits),
        torch.stack([f.time_min for f in frames]), torch.stack([f.time_max for f in frames]),
        enabled, cfg, rng=split(keys[1], n_lanes), grid_corners=state.grid_corners,
        grid_surface=state.grid_surface)
    return Group(q_inits, t_inits, enabled, inputs, icp_pass, carry, finish, keys[0])


def commit_lane(state: OdometryState, k: int, frame: FeatureFrame, group: Group,
                regs: RegistrationResult, cfg: SlamConfig
                ) -> Tuple[OdometryState, RegistrationResult, MatchingUpdate]:
    """Lane ``k``'s commit onto ``state`` (the state after lanes 0..k-1;
    lane 0 also commits the group's next key): a rejected lane frozen at
    the committed pose, then
    `odometry.commit_history` from the lane's coasted start.  Returns the
    new state (its matching buffer as it was; its cell maps with the
    lane's masked insertions), the lane's result and the
    `MatchingUpdate` to apply."""
    reg = lane(regs, k)
    if k == 0:
        state = state._replace(rng=group.rng)
    # a rejected lane freezes at the last committed pose, not at its
    # coasted start (committing the coast would integrate it open-loop)
    rejected = (reg.enabled & ~reg.accepted)[None]
    reg = reg._replace(q_w=torch.where(rejected, state.q_w, reg.q_w),
                       t_w=torch.where(rejected, state.t_w, reg.t_w))
    return commit_history(state, frame, *group.inputs[k], reg, cfg,
                          q_base=group.q_inits[k], t_base=group.t_inits[k])


def odometry_step_batched(state: OdometryState, frames: List[FeatureFrame],
                          cfg: SlamConfig
                          ) -> Tuple[OdometryState, List[RegistrationResult], int]:
    """Register ``frames`` (time order) in one lane-batched solve against
    the current matching buffer, then commit them in order.  Returns the
    state, one result per lane (``iterations`` a device scalar) and the
    registration's loop passes."""
    group = prepare_group(state, frames, cfg)
    carry, loops = run_host_loop(group.icp_pass, group.carry,
                                 cfg.optimization.icp_maximum_iteration)
    regs = group.finish(carry)
    out = []
    touched = None
    for k, frame in enumerate(frames):
        state, reg, upd = commit_lane(state, k, frame, group, regs, cfg)
        state = update_matching(state, upd, cfg)
        if state.last_touched is not None:
            touched = (state.last_touched if touched is None
                       else touched | state.last_touched)
        out.append(reg)
    # the loop service takes one entry a group: every lane's touched cells
    # (the JAX package's touched_any), not only the last commit's
    return state._replace(last_touched=touched), out, loops
