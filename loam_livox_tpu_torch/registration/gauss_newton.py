"""Levenberg–Marquardt on SE(3), the stand-in for the reference's Ceres
solve (``source/point_cloud_registration.hpp:460-508``).

Residuals and their closed-form 3×6 Jacobians over the whole batch are
reduced to a Huber-weighted 6×6 normal system, Jacobi-scaled and solved
in float32.  The rotation update is left-multiplicative
(q ← Exp(δ) ⊗ q, Ceres' quaternion manifold); the translation is
clipped to ±``max_allow_incre_T`` (Ceres' parameter bounds, :143-151).
The two-phase schedule is a short prerun, an inlier-quantile prune, and
the full solve.

Accept/reject decisions stay on the device (``torch.where``), so the
solver never waits for the host.  Every tensor may carry a leading lane
axis (residuals (L, N, 3), poses (L, 4) / (L, 3)): L independent
solves batched into the same launches, each with its own damping,
accept steps and prune threshold.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..core import se3
from ..core.config import OptimizationConfig
from ..ops.masked import masked_quantile_l1
from ..utils.logging import SPAN_POSE_OPT, spans
from .residuals import huber_rho, huber_weight

# fj(q, t) -> (residuals (..., N, 3), jacobian (..., N, 3, 6), block_mask (..., N))
ResidualJacFn = Callable[[torch.Tensor, torch.Tensor],
                         Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class SolveInfo(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    inlier_threshold: torch.Tensor
    n_blocks: torch.Tensor


def _sq_norm(r):
    return (r * r).sum(dim=-1)


def _cost(r, mask, delta: float):
    """Ceres-style cost: 0.5 Σ ρ(‖r_block‖²) over valid blocks."""
    terms = torch.where(mask, huber_rho(_sq_norm(r), delta), torch.zeros((), device=r.device))
    return 0.5 * terms.sum(dim=-1)


def system_from_rJ(r0, J, mask, delta: float):
    """Huber-weighted JᵀJ (..., 6, 6) and Jᵀr (..., 6)."""
    w = torch.where(mask, huber_weight(_sq_norm(r0), delta),
                    torch.zeros((), device=r0.device))
    sw = torch.sqrt(w)
    rw = r0 * sw[..., None]
    Jw = J * sw[..., None, None]
    H = torch.einsum("...nij,...nik->...jk", Jw, Jw)
    g = torch.einsum("...nij,...ni->...j", Jw, rw)
    return H, g


def solve_damped(H, g, lam):
    """Jacobi-scaled damped solve of (H + λ·diag(H) + 1e-8·I) δ = −g.

    ``solve_ex`` without error checks: a singular system yields
    non-finite values (as ``jnp.linalg.solve`` does) instead of raising,
    and the check would be a device sync."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damped = H + lam[..., None, None] * torch.diag_embed(diag) + 1e-8 * eye
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(damped, dim1=-2, dim2=-1), min=1e-12))
    Hs = damped * d[..., :, None] * d[..., None, :]
    y, _ = torch.linalg.solve_ex(Hs, (-g * d)[..., None], check_errors=False)
    return y[..., 0] * d


def _pick(take, a, b):
    """``take ? a : b`` per lane: ``take`` has the lane shape of ``a``."""
    return torch.where(take.reshape(take.shape + (1,) * (a.dim() - take.dim())), a, b)


class LMState(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    H: torch.Tensor
    g: torch.Tensor
    r: torch.Tensor
    J: torch.Tensor


def lm_solve(fj: ResidualJacFn, q0, t0, iterations: int,
             opt: OptimizationConfig, init_sys=None) -> LMState:
    """Fixed-iteration LM with accept/reject damping (×0.3 / ×5).  The
    state carries the system at the current point, so an accepted trial
    point's system is reused for the next step.  ``init_sys`` =
    (H, g, cost, r, J) already evaluated at (q0, t0)."""
    delta = opt.huber_delta
    tmax = opt.max_allow_incre_T
    if init_sys is None:
        r0, J0, m0 = fj(q0, t0)
        H0, g0 = system_from_rJ(r0, J0, m0, delta)
        c0 = _cost(r0, m0, delta)
    else:
        H0, g0, c0, r0, J0 = init_sys
    st = LMState(q=q0, t=t0,
                 lam=torch.full(q0.shape[:-1], opt.lm_init_lambda, dtype=torch.float32,
                                device=q0.device),
                 cost=c0, H=H0, g=g0, r=r0, J=J0)
    for _ in range(iterations):
        dd = solve_damped(st.H, st.g, st.lam)
        q_new = se3.quat_normalize(se3.quat_multiply(se3.quat_exp(dd[..., :3]), st.q))
        t_new = torch.clamp(st.t + dd[..., 3:], -tmax, tmax)
        r_new, J_new, m_new = fj(q_new, t_new)
        H_new, g_new = system_from_rJ(r_new, J_new, m_new, delta)
        c_new = _cost(r_new, m_new, delta)
        acc = c_new < st.cost
        st = LMState(
            q=_pick(acc, q_new, st.q),
            t=_pick(acc, t_new, st.t),
            lam=torch.where(acc, st.lam * 0.3, st.lam * 5.0),
            cost=torch.minimum(c_new, st.cost),
            H=_pick(acc, H_new, st.H),
            g=_pick(acc, g_new, st.g),
            r=_pick(acc, r_new, st.r),
            J=_pick(acc, J_new, st.J),
        )
    return st


def solve_two_phase(fj_with_mask: Callable[[torch.Tensor], ResidualJacFn],
                    base_mask, q0, t0, opt: OptimizationConfig):
    """Prerun → prune → full solve.  ``fj_with_mask(m)`` returns a
    residual function whose block mask is ``m``; ``base_mask`` already
    holds every validity gate.  Returns (q, t, SolveInfo); the inlier
    threshold is scaled by final/initial cost (reference :559)."""
    with spans.device(SPAN_POSE_OPT, q0):
        return _solve_two_phase(fj_with_mask, base_mask, q0, t0, opt)


def _solve_two_phase(fj_with_mask, base_mask, q0, t0, opt: OptimizationConfig):
    pre = lm_solve(fj_with_mask(base_mask), q0, t0, opt.prerun_iterations, opt)
    # Prune on loss-corrected L1 residuals: threshold = max(inlier_dis,
    # inlier_ratio quantile) (reference :484-499).  The prerun's final
    # (r, J) is re-reduced under the pruned mask, not re-evaluated.
    r = pre.r
    rc = r * torch.sqrt(huber_weight(_sq_norm(r), opt.huber_delta))[..., None]
    l1 = torch.abs(rc).sum(dim=-1)
    thr = torch.clamp(masked_quantile_l1(l1, base_mask, opt.inlier_ratio),
                      min=opt.inlier_dis)
    keep = base_mask & (l1 <= thr[..., None])
    initial_cost = _cost(r, keep, opt.huber_delta)
    H_i, g_i = system_from_rJ(r, pre.J, keep, opt.huber_delta)
    full = lm_solve(fj_with_mask(keep), pre.q, pre.t, opt.full_iterations, opt,
                    init_sys=(H_i, g_i, initial_cost, r, pre.J))
    info = SolveInfo(
        initial_cost=initial_cost,
        final_cost=full.cost,
        inlier_threshold=thr * full.cost / torch.clamp(initial_cost, min=1e-12),
        n_blocks=keep.sum(dim=-1, dtype=torch.int32),
    )
    return full.q, full.t, info
