"""Livox solid-state LiDAR feature extraction on tensors.

The behaviour of the reference front end (`Livox_laser`,
``source/livox_feature_extractor.hpp``) over one padded raw frame:

* defect flags: zero, NaN, too near, low reflectivity, FoV edge
  (reference ``:82-92, 343-358, 474-526``);
* rosette petal splitting at turning points of the polar distance with
  a 50-sample debounce (reference ``:529-573``);
* curvature, view angle, and corner/surface labels with the small-FoV
  outlier rejection (reference ``:361-455``);
* per-point timestamps at 10 µs spacing (reference ``:145, 481``);
* feature selection into corner / surface / full clouds
  (reference `get_features`, ``:219-272``).

Everything stays on the device: the debounce, a greedy pass over at
most ``max_splits`` turning-point candidates (the JAX package's
``lax.scan``), runs as the hand-written kernel of `ops.debounce` on the
card, and the petal count is a tensor, so a frame reads nothing on the
host and the frame program (`runtime.frame_program`) can capture it.
The frame's base time may be a Python float or a scalar tensor (the
frame program's input buffer), so that no time is fixed at capture.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.config import CapacityConfig, FeatureExtractionConfig
from ..core.types import FeatureFrame, PointBatch
from ..ops.debounce import debounce
from ..ops.masked import compact
from ..utils.logging import SPAN_FRONT_END, spans

# E_point_type bitmask (reference :82-92)
PT_NORMAL = 0
PT_000 = 1 << 0
PT_TOO_NEAR = 1 << 1
PT_REFLECTIVITY_LOW = 1 << 2
PT_REFLECTIVITY_HIGH = 1 << 3
PT_CIRCLE_EDGE = 1 << 4
PT_NAN = 1 << 5

# E_feature_type (reference :94-103)
LABEL_UNLABELED = 0
LABEL_CORNER = 1 << 0
LABEL_SURFACE = 1 << 1
LABEL_NEAR_NAN = 1 << 2
LABEL_NEAR_ZERO = 1 << 3

_RAD2DEG = 57.3  # the reference's conversion constant, kept verbatim

class PtInfo(NamedTuple):
    """Per-point analysis record (reference `Pt_infos`, :118-133)."""
    pt_type: torch.Tensor        # (N,) int32 bitmask
    label: torch.Tensor          # (N,) int32 bitmask
    depth_sq2: torch.Tensor      # (N,)
    polar_dis_sq2: torch.Tensor  # (N,) zero-x points carry the previous one
    pt_2d: torch.Tensor          # (N, 2) projection onto the x = 1 plane
    curvature: torch.Tensor      # (N,)
    view_angle: torch.Tensor     # (N,) degrees
    sigma: torch.Tensor          # (N,) reflectivity density
    time: torch.Tensor           # (N,) absolute seconds
    scan_angle: torch.Tensor     # (N,) petal scan angle, degrees + 180
    in_mask: torch.Tensor        # (N,) bool: real input slots


def _forward_fill(values: torch.Tensor, valid: torch.Tensor, fallback: float):
    """values[i] := values[j] for the last j <= i with valid[j], else
    ``fallback``."""
    n = values.shape[0]
    idx = torch.where(valid, torch.arange(n, device=values.device),
                      torch.full((n,), -1, device=values.device))
    last = torch.cummax(idx, dim=0).values
    filled = values[torch.clamp(last, min=0)]
    has = last >= 0
    if values.dim() > 1:
        has = has[:, None]
    return torch.where(has, filled, torch.full_like(filled, fallback))


def _shift(a: torch.Tensor, s: int) -> torch.Tensor:
    """a[i + s] with zero fill."""
    if s == 0:
        return a
    out = torch.zeros_like(a)
    if s > 0:
        out[:-s] = a[s:]
    else:
        out[-s:] = a[:s]
    return out


def _dilate_mask_asymmetric(flag: torch.Tensor) -> torch.Tensor:
    """Flag j if j or any of j-1, j+1, j+2 is flagged: offsets {-2, -1, +1}
    of each source (reference `add_mask_of_point`, :328-340)."""
    return flag | _shift(flag, 1) | _shift(flag, 2) | _shift(flag, -1)


def extract_point_info(xyz: torch.Tensor, raw_intensity: torch.Tensor,
                       in_mask: torch.Tensor, base_time,
                       fe: FeatureExtractionConfig, caps: CapacityConfig):
    """Per-point analysis of one padded raw frame (``base_time`` a float
    or a scalar tensor).  Returns ``(PtInfo, n_petals)``, ``n_petals`` an
    int64 scalar tensor; 0 rejects the frame (fewer than 3 petals,
    reference :572-573)."""
    dev = xyz.device
    n = xyz.shape[0]
    idxs = torch.arange(n, device=dev)
    zero = torch.zeros((), device=dev)
    finite = torch.isfinite(xyz).all(dim=-1)
    is_nan = in_mask & ~finite
    xs, ys, zs = (torch.where(finite, xyz[:, c], zero) for c in range(3))
    is_zero = in_mask & finite & (xs == 0.0)
    proj_ok = in_mask & finite & (xs != 0.0)

    depth_sq2 = xs * xs + ys * ys + zs * zs
    safe_x = torch.where(xs == 0.0, torch.ones((), device=dev), xs)
    u = torch.where(proj_ok, ys / safe_x, zero)
    v = torch.where(proj_ok, zs / safe_x, zero)
    polar_raw = u * u + v * v
    pt_2d = _forward_fill(torch.stack([u, v], dim=-1), proj_ok, 0.01)
    polar = _forward_fill(polar_raw, proj_ok, 0.0001)

    pt_type = torch.zeros(n, dtype=torch.int32, device=dev)
    pt_type = pt_type | torch.where(is_nan, PT_NAN, 0).to(torch.int32)
    pt_type = pt_type | torch.where(is_zero, PT_000, 0).to(torch.int32)
    too_near = proj_ok & (depth_sq2 < fe.livox_min_dis ** 2)
    pt_type = pt_type | torch.where(too_near, PT_TOO_NEAR, 0).to(torch.int32)
    sigma = torch.where(proj_ok, raw_intensity / torch.clamp(polar, min=1e-12), zero)
    low_refl = proj_ok & (sigma < fe.livox_min_sigma)
    pt_type = pt_type | torch.where(low_refl, PT_REFLECTIVITY_LOW, 0).to(torch.int32)
    # a host float, computed in float32 on the CPU as before
    max_edge = float(torch.tan(torch.tensor(fe.max_fov_deg / _RAD2DEG,
                                            dtype=torch.float32)) ** 2)
    edge = _dilate_mask_asymmetric(proj_ok & (polar > max_edge)) & in_mask
    pt_type = pt_type | torch.where(edge, PT_CIRCLE_EDGE, 0).to(torch.int32)

    # ---- petal split (reference :529-573) ------------------------------
    dis_incre = polar - torch.cat([polar[:1], polar[:-1]])
    direction = torch.where(idxs == 0, 0, torch.sign(dis_incre)).to(torch.int32)
    prev_dir = _shift(direction, -1)
    cand_ok = in_mask & ~is_nan & ~is_zero & (idxs >= 1)
    edge_cand = cand_ok & (direction == -1) & (prev_dir == 1)   # local max
    zero_cand = cand_ok & (direction == 1) & (prev_dir == -1)   # local min
    n_valid_t = in_mask.sum()

    # The first max_splits candidates in index order, compacted by
    # cumsum (padding n), then the debounce on the device.
    ns = caps.max_splits
    cand = edge_cand | zero_cand
    slot = torch.cumsum(cand.to(torch.int64), 0) - 1
    keep = cand & (slot < ns)
    cand_idx = torch.full((ns + 1,), n, dtype=torch.int64, device=dev)
    cand_idx[torch.where(keep, slot, torch.full_like(slot, ns))] = \
        torch.where(keep, idxs, torch.full_like(idxs, n))
    cand_idx = cand_idx[:ns]
    cand_is_edge = edge_cand[torch.clamp(cand_idx, max=n - 1)] & (cand_idx < n)
    splits, n_accepted = debounce(cand_idx, cand_is_edge, n, n_valid_t, fe.split_min_gap)
    n_splits = n_accepted + 1            # includes the terminator
    n_petals = torch.where(n_splits < 6, 0, n_splits - 1)

    # ---- per-segment scan angle (reference :575-604) --------------------
    count_less = torch.searchsorted(torch.clamp(splits, 0, n), idxs)
    seg_of_pt = torch.minimum(torch.clamp(count_less - 1, min=0),
                              torch.clamp(n_splits - 2, min=0))
    seg_end = splits[torch.clamp(torch.arange(ns, device=dev) + 1, max=ns - 1)]
    internal = seg_end - splits
    far = polar[torch.clamp(seg_end, 0, n - 1)] > 10000.0
    frac = torch.where(far, 0.20, 0.80).to(torch.float32)
    rep = seg_end - (internal.to(torch.float32) * frac).to(torch.int64)
    rep = torch.clamp(rep, 0, n - 1)
    seg_angle = torch.atan2(pt_2d[rep, 1], pt_2d[rep, 0]) * _RAD2DEG + 180.0
    scan_angle = torch.where(n_petals > 0, seg_angle[seg_of_pt], torch.zeros_like(polar))

    # ---- curvature, view angle, labels (reference :361-455) -------------
    xyz_f = torch.stack([xs, ys, zs], dim=-1)
    p_m2, p_m1 = _shift(xyz_f, -2), _shift(xyz_f, -1)
    p_p1, p_p2 = _shift(xyz_f, 1), _shift(xyz_f, 2)
    t_m2, t_m1 = _shift(pt_type, -2), _shift(pt_type, -1)
    t_p1, t_p2 = _shift(pt_type, 1), _shift(pt_type, 2)
    bad1 = ((t_m1 | t_p1) & (PT_000 | PT_NAN)) != 0
    bad2 = ((t_m2 | t_p2) & (PT_000 | PT_NAN)) != 0
    self_bad = (pt_type & (PT_000 | PT_NAN)) != 0
    interior = (idxs >= 2) & (idxs < n_valid_t - 2) & in_mask
    can_label = interior & ~self_bad & ~bad1 & ~bad2

    near_zero = interior & ~self_bad & (((t_m1 | t_p1) & PT_000) != 0)
    near_nan = interior & ~self_bad & (((t_m1 | t_p1) & PT_NAN) != 0) & ~near_zero
    label = (torch.where(near_zero, LABEL_NEAR_ZERO, 0)
             | torch.where(near_nan, LABEL_NEAR_NAN, 0)).to(torch.int32)

    acc = p_m2 + p_m1 + p_p1 + p_p2 - 4.0 * xyz_f
    curvature = torch.where(can_label, (acc * acc).sum(dim=-1), zero)
    chord = p_p2 - p_m2
    dot = (xyz_f * chord).sum(dim=-1)
    na = torch.sqrt(torch.clamp(depth_sq2, min=1e-12))
    nb = torch.linalg.vector_norm(chord, dim=-1)
    cosang = torch.abs(dot) / torch.clamp(na * nb, min=1e-12)
    view_angle = torch.where(
        can_label & (na > 1e-6) & (nb > 1e-6),
        torch.arccos(torch.clamp(cosang, -1.0, 1.0)) * _RAD2DEG, zero)

    d_m2, d_p2 = _shift(depth_sq2, -2), _shift(depth_sq2, 2)
    angle_ok = view_angle > fe.minimum_view_angle
    is_surface = can_label & angle_ok & (curvature < fe.surface_curvature)
    local_min = (depth_sq2 <= d_m2) & (depth_sq2 <= d_p2)
    no_jump = ((torch.abs(depth_sq2 - d_m2) < 0.1 * depth_sq2)
               | (torch.abs(depth_sq2 - d_p2) < 0.1 * depth_sq2))
    is_corner = (can_label & angle_ok & (curvature > fe.corner_curvature)
                 & local_min & no_jump)
    label = label | torch.where(is_surface, LABEL_SURFACE, 0).to(torch.int32)
    label = label | torch.where(is_corner, LABEL_CORNER, 0).to(torch.int32)

    if isinstance(base_time, torch.Tensor):
        t0 = base_time.to(device=dev, dtype=torch.float32).reshape(())
    else:
        t0 = torch.full((), base_time, dtype=torch.float32, device=dev)
    time = t0 + idxs.to(torch.float32) * fe.time_internal_pts

    info = PtInfo(pt_type=pt_type, label=label, depth_sq2=depth_sq2,
                  polar_dis_sq2=polar, pt_2d=pt_2d, curvature=curvature,
                  view_angle=view_angle, sigma=sigma, time=time,
                  scan_angle=scan_angle, in_mask=in_mask)
    return info, n_petals


def select_features(xyz: torch.Tensor, info: PtInfo, n_petals,
                    min_frac: float, max_frac: float,
                    fe: FeatureExtractionConfig) -> FeatureFrame:
    """Corner / surface / full clouds of the index-fraction window
    [min_frac, max_frac] (reference `get_features`, :219-272), at the
    raw capacity; the source voxel filter reduces them."""
    dev = xyz.device
    n = xyz.shape[0]
    idxs = torch.arange(n, device=dev).to(torch.float32)
    n_valid = info.in_mask.sum().to(torch.float32)
    in_window = (idxs >= min_frac * n_valid) & (idxs <= max_frac * n_valid)
    ok = info.in_mask & in_window & (n_petals > 0)

    not_critical = (info.pt_type & (PT_000 | PT_NAN | PT_TOO_NEAR)) == 0
    corner_sel = (ok & not_critical & ((info.label & LABEL_CORNER) != 0)
                  & (info.pt_type == PT_NORMAL)
                  & (info.depth_sq2 < fe.corner_max_depth ** 2))
    surf_sel = (ok & not_critical & ((info.label & LABEL_SURFACE) != 0)
                & (info.depth_sq2 < fe.surface_max_depth ** 2))
    # The full cloud keeps in-window points except NaNs and dropouts.
    full_sel = ok & ((info.pt_type & (PT_000 | PT_NAN)) == 0)

    def gather(sel):
        m, px, pt = compact(sel, xyz, info.time)
        return PointBatch(xyz=torch.where(m[:, None], px, torch.zeros((), device=dev)),
                          time=pt, mask=m)

    t = torch.where(full_sel, info.time, torch.full_like(info.time, math.inf))
    tmin = t.amin()
    tmax = torch.where(full_sel, info.time, torch.full_like(info.time, -math.inf)).amax()
    zero = torch.zeros((), device=dev)
    tmin = torch.where(torch.isfinite(tmin), tmin, zero)
    tmax = torch.where(torch.isfinite(tmax), tmax, zero)
    return FeatureFrame(corners=gather(corner_sel), surface=gather(surf_sel),
                        full=gather(full_sel), time_min=tmin, time_max=tmax)


def extract_frame(xyz: torch.Tensor, raw_intensity: torch.Tensor,
                  in_mask: torch.Tensor, base_time,
                  fe: FeatureExtractionConfig, caps: CapacityConfig,
                  piecewise_number: int = 1):
    """Front end for one raw frame, split into ``piecewise_number``
    index-fraction windows [p/P, (p+1)/P] (reference
    laser_feature_extractor.hpp:305-335).  The bounds are fractions of
    the valid count with both ends inclusive, so adjacent pieces share a
    boundary index.  Returns ``(PtInfo, n_petals, [FeatureFrame] * P)``."""
    with spans.device(SPAN_FRONT_END, xyz):
        info, n_petals = extract_point_info(xyz, raw_intensity, in_mask,
                                            base_time, fe, caps)
        return info, n_petals, [
            select_features(xyz, info, n_petals, p / piecewise_number,
                            (p + 1) / piecewise_number, fe)
            for p in range(piecewise_number)]
