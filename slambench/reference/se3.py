"""SE(3) and quaternion math on tensors.

Quaternions are ``(w, x, y, z)`` (Hamilton) with shape ``(..., 4)``; a
pose is ``(q, t)`` acting as ``x_w = R(q) x + t`` and poses compose as
``q_a ⊗ q_b, R(q_a) t_b + t_a`` (reference
``source/point_cloud_registration.hpp:514-515``).  Small-angle branches
use Taylor forms so the maps are finite at the identity.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    # built on the device: a host-built tensor, or writing a Python
    # scalar into one, is a blocking copy
    return torch.eye(1, 4, dtype=dtype, device=device).reshape(4)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for (..., 4) tensors."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4), broadcasting."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) quaternion with w >= 0
    (Shepperd's method, branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx0 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy0 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz0 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)[..., None]
    q = torch.where(best == 0, qw0,
                    torch.where(best == 1, qx0, torch.where(best == 2, qy0, qz0)))
    q = quat_normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) rotation vector (..., 3) -> unit quaternion (..., 4)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    half = 0.5 * theta
    small = theta_sq < 1e-8
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (..., 3), shortest arc."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                        angle / torch.clamp(vn, min=_EPS))
    return scale * v


def quat_slerp_identity(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """slerp(I, q, s) = Exp(s · Log(q)); q (4,), s (N,) -> (N, 4)
    (reference ``source/ceres_icp.hpp:54``)."""
    if s.dim() and s.shape[-1] != 1:
        s = s[..., None]
    return quat_exp(s * quat_log(q))


def quat_angular_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two unit quaternions (Eigen's
    ``angularDistance``)."""
    d = quat_multiply(quat_conjugate(a), b)
    vn = torch.linalg.vector_norm(d[..., 1:4], dim=-1)
    return 2.0 * torch.atan2(vn, torch.abs(d[..., 0]))


def pose_compose(q_a, t_a, q_b, t_b):
    """(q_a, t_a) ∘ (q_b, t_b): first apply b, then a."""
    return quat_multiply(q_a, q_b), quat_rotate(q_a, t_b) + t_a


def pose_inverse(q, t):
    qi = quat_conjugate(q)
    return qi, -quat_rotate(qi, t)


def pose_transform(q, t, pts):
    return quat_rotate(q, pts) + t


def pose_relative(q_a, t_a, q_b, t_b):
    """T_a⁻¹ ∘ T_b."""
    qi, ti = pose_inverse(q_a, t_a)
    return pose_compose(qi, ti, q_b, t_b)


def rodrigues_matrix(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """R = I + sin θ [ω]ₓ + (1 − cos θ) [ω]ₓ² for a unit axis."""
    wx, wy, wz = axis.unbind(-1)
    zeros = torch.zeros_like(wx)
    hat = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros],
                      dim=-1).reshape(axis.shape[:-1] + (3, 3))
    hat2 = hat @ hat
    th = theta[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + torch.sin(th) * hat + (1.0 - torch.cos(th)) * hat2


def quat_to_axis_angle(q: torch.Tensor):
    """Unit quaternion -> (unit axis, angle); axis (1, 0, 0) at identity."""
    phi = quat_log(q)
    theta = torch.linalg.vector_norm(phi, dim=-1)
    axis = phi / torch.clamp(theta[..., None], min=_EPS)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    axis = torch.where(theta[..., None] < 1e-9, x_axis, axis)
    return axis, theta
