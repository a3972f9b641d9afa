"""Point-to-line and point-to-plane ICP residuals with motion deblur,
and their closed-form Jacobians.

Batched versions of the reference's Ceres cost functors
(``source/ceres_icp.hpp``): the line residual is the rejection of
(p_w − a) from the line direction (:80-148, 237-301), the plane residual
its projection onto the cross-product normal, which is deliberately not
re-normalised, so a degenerate neighbour triple quietly contributes
nothing (:151-233, 305-380).  With deblur each point moves by
slerp(I, q_incre, s), s·t_incre for its normalised time s
(:54-59, 116-121, 197-202).

Targets follow ``point_cloud_registration.hpp:249-332`` (lines through
the two nearest map points, degenerate below 0.1 mm, gate on the k-th
squared distance) and ``:351-424`` (planes through neighbours
[0, k/2, k−1]).

Every function also takes a leading lane axis: points (L, N, 3) with
one pose per lane, (L, 4) and (L, 3), as the racing path registers L
frames at once (`registration.icp.prepare_registration`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..utils.logging import SPAN_TARGETS, spans


class LineTargets(NamedTuple):
    a: torch.Tensor        # (..., N, 3) line anchor
    unit_ab: torch.Tensor  # (..., N, 3) unit direction
    valid: torch.Tensor    # (..., N) bool


class PlaneTargets(NamedTuple):
    a: torch.Tensor        # (..., N, 3) plane anchor
    normal: torch.Tensor   # (..., N, 3) cross-product normal, not re-normalised
    valid: torch.Tensor    # (..., N) bool


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def build_line_targets(sq_dists, idx, map_xyz, query_mask,
                       max_dis_sq: float) -> LineTargets:
    with spans.device(SPAN_TARGETS, map_xyz):
        a = map_xyz[idx[..., 0].long()]
        b = map_xyz[idx[..., 1].long()]
        ab = b - a
        norm = _norm(ab)
        valid = query_mask & (sq_dists[..., -1] < max_dis_sq) & (norm[..., 0] >= 1e-4)
        return LineTargets(a=a, unit_ab=ab / torch.clamp(norm, min=1e-12), valid=valid)


def build_plane_targets(sq_dists, idx, map_xyz, query_mask,
                        max_dis_sq: float) -> PlaneTargets:
    with spans.device(SPAN_TARGETS, map_xyz):
        k = idx.shape[-1]
        a = map_xyz[idx[..., 0].long()]
        b = map_xyz[idx[..., k // 2].long()]
        c = map_xyz[idx[..., k - 1].long()]
        uab = (b - a) / torch.clamp(_norm(b - a), min=1e-12)
        uac = (c - a) / torch.clamp(_norm(c - a), min=1e-12)
        n = torch.linalg.cross(uab, uac, dim=-1)
        valid = query_mask & (sq_dists[..., -1] < max_dis_sq)
        return PlaneTargets(a=a, normal=n, valid=valid)


def transform_points_incre(q_incre, t_incre, pts, s, q_last, t_last,
                           deblur: bool) -> torch.Tensor:
    """p_w = q_last ⊗ (interp(q_incre, s) · p + t_incre · s) + t_last;
    with deblur off the whole increment applies to every point."""
    if deblur:
        q_s = se3.quat_slerp_identity(q_incre[..., None, :], s[..., None])
        t_s = t_incre[..., None, :] * s[..., None]
    else:
        q_s, t_s = q_incre[..., None, :], t_incre[..., None, :]
    local = se3.quat_rotate(q_s, pts) + t_s
    return se3.quat_rotate(q_last[..., None, :], local) + t_last[..., None, :]


def _dot3(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def line_residuals(q_incre, t_incre, pts, s, tgt: LineTargets, q_last,
                   t_last, deblur: bool) -> torch.Tensor:
    pw = transform_points_incre(q_incre, t_incre, pts, s, q_last, t_last, deblur)
    ac = pw - tgt.a
    return ac - _dot3(ac, tgt.unit_ab) * tgt.unit_ab


def plane_residuals(q_incre, t_incre, pts, s, tgt: PlaneTargets, q_last,
                    t_last, deblur: bool) -> torch.Tensor:
    pw = transform_points_incre(q_incre, t_incre, pts, s, q_last, t_last, deblur)
    return _dot3(pw - tgt.a, tgt.normal) * tgt.normal


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def point_world_jacobian(q_incre, t_incre, pts, q_last) -> torch.Tensor:
    """∂p_w/∂[δr, δt] (..., N, 3, 6) of the no-deblur transform
    p_w = R_last (Exp(δr) R_incre p + t_incre + δt) + t_last at δ = 0."""
    v = se3.quat_rotate(q_incre[..., None, :], pts)
    r_last = se3.quat_to_matrix(q_last)
    j_rot = -torch.einsum("...ij,...njk->...nik", r_last, _skew(v))
    j_tr = r_last[..., None, :, :].expand(j_rot.shape)
    return torch.cat([j_rot, j_tr], dim=-1)


def _f1(u):
    """(1 − cos u) / u², Taylor-guarded."""
    small = torch.abs(u) < 1e-3
    us = torch.where(small, torch.ones_like(u), u)
    return torch.where(small, 0.5 - u * u / 24.0, (1.0 - torch.cos(us)) / (us * us))


def _f2(u):
    """(u − sin u) / u³, Taylor-guarded."""
    small = torch.abs(u) < 1e-3
    us = torch.where(small, torch.ones_like(u), u)
    return torch.where(small, 1.0 / 6.0 - u * u / 120.0,
                       (us - torch.sin(us)) / (us ** 3))


def point_world_jacobian_deblur(q_incre, t_incre, pts, s, q_last) -> torch.Tensor:
    """Exact ∂p_w/∂[δr, δt] (..., N, 3, 6) of the deblur transform
    p_w = R_last (Exp(s·Log(Exp(δr) R_incre)) p + s(t_incre + δt)) + t_last
    at δ = 0:

        ∂p_w/∂δr = −s · R_last [R_incre^s p]× · M(s),   ∂p_w/∂δt = s · R_last,
        M(s) = J_l(sφ) J_l(φ)⁻¹ = I + c₁K + c₂K²,  K = [φ]×,  φ = Log(q_incre),

    with c₁ = a₁ − ½ − θ²(a₁b₂ − a₂/2), c₂ = a₂ + b₂ − a₁/2 − θ²a₂b₂,
    a₁ = s f₁(sθ), a₂ = s² f₂(sθ), b₂ = 1/θ² − (1 + cos θ)/(2θ sin θ).
    It equals forward-mode autodiff of the transform to f32 round-off."""
    q_s = se3.quat_slerp_identity(q_incre[..., None, :], s[..., None])
    v = se3.quat_rotate(q_s, pts)
    r_last = se3.quat_to_matrix(q_last)
    phi = se3.quat_log(q_incre)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)   # (..., 1): one per lane
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = _skew(phi)[..., None, :, :]
    K2 = K @ K
    small = theta < 1e-3
    ts = torch.where(small, torch.ones_like(theta), theta)
    b2 = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     1.0 / (ts * ts) - (1.0 + torch.cos(ts)) / (2.0 * ts * torch.sin(ts)))
    u = s * theta
    a1 = s * _f1(u)
    a2 = s * s * _f2(u)
    c1 = a1 - 0.5 - theta2 * (a1 * b2 - 0.5 * a2)
    c2 = a2 + b2 - 0.5 * a1 - theta2 * a2 * b2
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    M = eye + c1[..., None, None] * K + c2[..., None, None] * K2
    j_rot = (-torch.einsum("...ij,...njk,...nkl->...nil", r_last, _skew(v), M)
             * s[..., None, None])
    j_tr = r_last[..., None, :, :] * s[..., None, None]
    return torch.cat([j_rot, j_tr], dim=-1)


def line_jacobian(pw_jac, tgt: LineTargets) -> torch.Tensor:
    """(I − u uᵀ) ∂p_w/∂δ."""
    u = tgt.unit_ab
    return pw_jac - torch.einsum("...ni,...nj,...njk->...nik", u, u, pw_jac)


def plane_jacobian(pw_jac, tgt: PlaneTargets) -> torch.Tensor:
    """n nᵀ ∂p_w/∂δ."""
    n = tgt.normal
    return torch.einsum("...ni,...nj,...njk->...nik", n, n, pw_jac)


def huber_rho(s, delta: float):
    """Ceres HuberLoss on squared norms: s for s ≤ δ², else 2δ√s − δ²."""
    d2 = delta * delta
    return torch.where(s <= d2, s, 2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-20)) - d2)


def huber_weight(s, delta: float):
    """IRLS weight ρ'(s) = min(1, δ/√s)."""
    d2 = delta * delta
    return torch.where(s <= d2, torch.ones_like(s),
                       delta / torch.sqrt(torch.clamp(s, min=1e-20)))
