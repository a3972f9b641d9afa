"""Racing registration: the reference's worker pool
(``common/maximum_parallel_thread``, reference
``laser_mapping.hpp:1737-1742``) as one lane-batched registration, the
counterpart of ``loam_livox_tpu/runtime/batched.py``.

L = G·P piece frames (G raw frames, P pieces each, lane k·P + q = frame
k, piece q) register against the shared matching buffer, each from a
constant-velocity coast of the state's pose (lane k starts k steps
ahead, the staleness of the reference's racing workers), then commit in
time order.  One `registration.icp.register_frames` call does the
registration: every lane's kNN in one kernel launch per search, the
solves batched.  The input voxel filter and the commits loop over the
lanes on the host.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..core import se3
from ..core.config import SlamConfig
from ..core.types import FeatureFrame, PointBatch
from ..registration.icp import RegistrationResult, lane, register_frames
from .odometry import OdometryState, commit_frame, input_downsample


def stack_batches(batches: List[PointBatch]) -> PointBatch:
    return PointBatch(*(torch.stack(parts) for parts in zip(*batches)))


def odometry_step_batched(state: OdometryState, frames: List[FeatureFrame],
                          cfg: SlamConfig
                          ) -> Tuple[OdometryState, List[RegistrationResult], int]:
    """Register ``frames`` (time order) in one lane-batched solve against
    the current matching buffer, then commit them in order.  Returns the
    state, one result per lane (``iterations`` a device scalar) and the
    registration's loop passes."""
    n_lanes = len(frames)
    # worker start poses: constant-velocity coast of the entry pose
    q_inits, t_inits = [], []
    qk, tk = state.q_w, state.t_w
    for _ in range(n_lanes):
        q_inits.append(qk)
        t_inits.append(tk)
        tk = se3.quat_rotate(qk, state.last_t_incre) + tk
        qk = se3.quat_normalize(se3.quat_multiply(qk, state.last_q_incre))
    enabled = [state.frame_count + k >= cfg.mapping.init_accumulate_frames
               for k in range(n_lanes)]

    inputs = [input_downsample(f, cfg) for f in frames]
    regs, loops = register_frames(
        stack_batches([c for c, _ in inputs]), stack_batches([s for _, s in inputs]),
        state.map_corners, state.map_surface, torch.stack(q_inits), torch.stack(t_inits),
        torch.stack([f.time_min for f in frames]), torch.stack([f.time_max for f in frames]),
        enabled, cfg, rng=state.rng, grid_corners=state.grid_corners,
        grid_surface=state.grid_surface)

    out = []
    touched = None
    for k, frame in enumerate(frames):
        reg = lane(regs, k)
        # a rejected lane freezes at the last committed pose, not at its
        # coasted start (committing the coast would integrate it open-loop)
        rejected = (reg.enabled & ~reg.accepted)[None]
        reg = reg._replace(q_w=torch.where(rejected, state.q_w, reg.q_w),
                           t_w=torch.where(rejected, state.t_w, reg.t_w))
        state, reg = commit_frame(state, frame, *inputs[k], reg, cfg,
                                  q_base=q_inits[k], t_base=t_inits[k])
        if state.last_touched is not None:
            touched = (state.last_touched if touched is None
                       else touched | state.last_touched)
        out.append(reg)
    # the loop service takes one entry a group: every lane's touched cells
    # (the JAX package's touched_any), not only the last commit's
    return state._replace(last_touched=touched), out, loops
