"""Scan-to-map registration with the frame's residual set split over
the ranks (the counterpart of
``loam_livox_tpu/parallel/sharded_registration.py``): each rank holds a
share of the frame's surface points, searches the whole matching
buffer for them, builds its Huber-weighted share of JᵀJ and Jᵀr, and
the 6×6 system crosses the group as one sum
(`parallel.sharded.normal_system_psum`: 43 floats an iteration).  The
update is solved on every rank.

The single-device `registration.icp.register_frame` stays the path of
the pipeline; this is the scale-out primitive for very dense frames.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import se3
from ..core.types import PointBatch
from ..ops.knn_fused import knn_fused
from ..registration import residuals as res
from .mesh import Mesh
from .sharded import normal_system_psum


def sharded_gn_iteration(frame_surface: PointBatch, map_surface: PointBatch,
                         q_incre, t_incre, q_last, t_last, mesh: Mesh,
                         huber_delta: float = 0.1, max_dis_sq: float = 50.0, k: int = 5,
                         deterministic: Optional[bool] = None):
    """One point-to-plane Gauss-Newton iteration; the frame's point axis
    splits over the ranks, the buffer is whole on every rank.  Returns
    ``(q_new, t_new, cost)``, the same on every rank."""
    def residual_jac(ids):
        fx, fm = frame_surface.xyz[ids], frame_surface.mask[ids]
        ones = torch.ones(fx.shape[0], device=fx.device)
        pw = res.transform_points_incre(q_incre, t_incre, fx, ones, q_last, t_last, False)
        sd, si = knn_fused(pw, map_surface.xyz, map_surface.mask, k=k)
        tgt = res.build_plane_targets(sd, si, map_surface.xyz, fm, max_dis_sq)
        r = res.plane_residuals(q_incre, t_incre, fx, ones, tgt, q_last, t_last, False)
        J = res.plane_jacobian(res.point_world_jacobian(q_incre, t_incre, fx, q_last), tgt)
        s = (r * r).sum(dim=-1)
        w = torch.where(tgt.valid, res.huber_weight(s, huber_delta), torch.zeros_like(s))
        return r, J, w

    ids = torch.arange(frame_surface.capacity, device=frame_surface.xyz.device)
    H, g, cost = normal_system_psum(residual_jac, ids, mesh, deterministic=deterministic)
    eye = torch.eye(6, device=H.device)
    damped = H + 1e-4 * torch.diag(torch.diag(H)) + 1e-8 * eye
    dd = torch.linalg.solve(damped, -g)
    q_new = se3.quat_normalize(se3.quat_multiply(se3.quat_exp(dd[:3]), q_incre))
    return q_new, t_incre + dd[3:], cost


def sharded_registration(frame_surface: PointBatch, map_surface: PointBatch,
                         q_last, t_last, mesh: Mesh, iterations: int = 5,
                         deterministic: Optional[bool] = None):
    """A fixed number of sharded point-to-plane iterations from the
    identity increment: ``(q, t, costs (iterations,))``."""
    dev = q_last.device
    q, t = se3.quat_identity(device=dev), torch.zeros(3, device=dev)
    costs = []
    for _ in range(iterations):
        q, t, c = sharded_gn_iteration(frame_surface, map_surface, q, t, q_last, t_last,
                                       mesh, deterministic=deterministic)
        costs.append(c)
    return q, t, torch.stack(costs)
