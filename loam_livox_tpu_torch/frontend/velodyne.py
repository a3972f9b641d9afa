"""Classic LOAM feature extraction for mechanical (Velodyne) LiDARs
(`lidar_type velodyne`, reference
``source/laser_feature_extractor.hpp:393-720``), the counterpart of
``loam_livox_tpu/frontend/velodyne.py``.

1. NaN and close-range removal (:211-240);
2. the ring of each point from its vertical angle, VLP-16 and HDL-64
   formulas (:432-459);
3. each point's time in the sweep from its azimuth, with the half-turn
   flag as a running OR (:402-500), in the ``time`` channel;
4. points regrouped by (ring, index) (:509-520);
5. curvature over ±5 neighbours inside each ring's [start+5, end−6]
   window (:522-535);
6. occlusion (the far side of a depth jump, 6 points) and parallel-beam
   rejection (:538-601);
7. per ring × 6 sectors, greedy picks of at most 20 sharp points
   (curvature > 0.5), each pick suppressing up to ±5 neighbours until a
   gap above 0.05 m² (:645-760).  The picks are sequential: a Python
   loop of 20 steps of tensor ops over all sectors at once, with no
   host read.

Corners are the sharp points (full raw capacity; the pipeline's source
filter cuts them to ``max_corner``); the surface is every other
in-sector point, voxel-filtered here at half the plane leaf.  The
reference's 5 flat picks a sector select nothing that reaches these
clouds (the JAX package computes and drops them), so they do not run.
Nothing here reads a device value on the host, and no shape depends on
the data, so the frame program captures it.
"""
from __future__ import annotations

import math

import torch

from ..core.config import FeatureExtractionConfig
from ..core.types import FeatureFrame, PointBatch
from ..ops.masked import compact
from ..ops.voxel import voxel_downsample
from ..utils.logging import SPAN_FRONT_END, spans
from .livox import _shift

SHARP_POINT_THRESHOLD = 0.05   # reference :640
SECTORS_PER_SCAN = 6
MAX_SHARP_PER_SECTOR = 20
SUPPRESS_GAP_SQ = 0.05         # reference :688, 699
SCAN_PERIOD = 0.1              # s, a sweep (reference :68)


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` through a device divisor: CUDA would multiply by a host
    scalar's reciprocal, which rounds differently from the CPU."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """Σ v² over the last axis of 3, in the order x, y, z."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _scan_id(xyz: torch.Tensor, mask: torch.Tensor, n_lines: int):
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    angle = _div(torch.atan2(z, torch.sqrt(x * x + y * y)) * 180.0, math.pi)
    if n_lines == 16:
        sid = torch.floor((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
        ok = (sid >= 0) & (sid <= 15)
    elif n_lines == 64:
        sid_hi = torch.floor((2.0 - angle) * 3.0 + 0.5).to(torch.int32)
        sid_lo = 32 + torch.floor((-8.83 - angle) * 2.0 + 0.5).to(torch.int32)
        sid = torch.where(angle >= -8.83, sid_hi, sid_lo)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:
        raise ValueError(f"unsupported scan_line count {n_lines}: the ring "
                         "formulas exist for 16 and 64 lines")
    return torch.clamp(sid, 0, n_lines - 1), mask & ok


def _relative_time(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sweep fraction in [0, 1] from the azimuth (reference :402-500).
    The reference's ``halfPassed`` flag is sequential; here it is the
    running OR of the unwrapped angle having passed π, the same for a
    single sweep."""
    pi = math.pi
    ori = -torch.atan2(xyz[:, 1], xyz[:, 0])
    m8 = mask.to(torch.uint8)
    first = torch.argmax(m8).reshape(1)                       # first valid point
    last = (xyz.shape[0] - 1 - torch.argmax(torch.flip(m8, (0,)))).reshape(1)
    start = ori.index_select(0, first)[0]
    end = ori.index_select(0, last)[0] + 2 * pi
    end = torch.where(end - start > 3 * pi, end - 2 * pi,
                      torch.where(end - start < pi, end + 2 * pi, end))
    pre = torch.where(ori < start - pi / 2, ori + 2 * pi, ori)
    pre = torch.where(pre > start + 3 * pi / 2, pre - 2 * pi, pre)
    half = torch.cumsum((mask & (pre - start > pi)).to(torch.int32), 0) > 0
    post = ori + 2 * pi
    post = torch.where(post < end - 3 * pi / 2, post + 2 * pi, post)
    post = torch.where(post > end + pi / 2, post - 2 * pi, post)
    o = torch.where(half, post, pre)
    rel = (o - start) / torch.clamp(end - start, min=1e-6)
    return torch.clamp(rel, 0.0, 1.0)


def _suppress(sel: torch.Tensor, base: torch.Tensor, close: torch.Tensor) -> torch.Tensor:
    """``base`` with the selected slots and up to 5 neighbours each way
    marked, stopping at the first gap above the threshold (reference
    :682-712); ``close[:, l]`` says the gap before slot l is small."""
    out = base | sel
    no = torch.zeros_like(sel[:, :1])
    run = sel
    for _ in range(5):                                       # forward
        run = torch.cat([no, run[:, :-1] & close[:, 1:]], dim=1)
        out = out | run
    run = sel
    for _ in range(5):                                       # backward
        run = torch.cat([run[:, 1:] & close[:, 1:], no], dim=1)
        out = out | run
    return out


def _pick_sharp(avail: torch.Tensor, wcurv: torch.Tensor, close: torch.Tensor):
    """Greedy picks in every sector window at once: the largest available
    curvature above the threshold, then its neighbourhood is
    suppressed."""
    slots = torch.arange(wcurv.shape[1], device=wcurv.device)[None, :]
    chosen = torch.zeros_like(avail)
    for _ in range(MAX_SHARP_PER_SECTOR):
        best = torch.argmax(torch.where(avail, wcurv, torch.full_like(wcurv, -math.inf)),
                            dim=1)[:, None]
        ok = ((torch.gather(wcurv, 1, best)[:, 0] > SHARP_POINT_THRESHOLD * 10)
              & torch.gather(avail, 1, best)[:, 0])
        onehot = (slots == best) & ok[:, None]
        avail = ~_suppress(onehot, ~avail, close)
        chosen = chosen | onehot
    return chosen


def _scatter_any(n: int, idx: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """(n,) bool: out[idx[j]] |= flag[j]."""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=idx.device)
    return out.index_fill_(0, torch.where(flag, idx, torch.full_like(idx, n)), True)[:n]


def extract_velodyne_features(xyz: torch.Tensor, in_mask: torch.Tensor,
                              base_time: float | torch.Tensor, fe: FeatureExtractionConfig,
                              minimum_range: float = 0.1) -> FeatureFrame:
    """Corner, surface and full clouds of one padded sweep (module doc),
    each at the sweep's capacity.  ``base_time`` is a float or a scalar
    tensor (the frame program's float64 device scalar), converted to
    float32 on the device, so both give the same bits."""
    with spans.device(SPAN_FRONT_END, xyz):
        return _extract_velodyne_features(xyz, in_mask, base_time, fe, minimum_range)


def _extract_velodyne_features(xyz: torch.Tensor, in_mask: torch.Tensor,
                               base_time: float | torch.Tensor, fe: FeatureExtractionConfig,
                               minimum_range: float) -> FeatureFrame:
    dev = xyz.device
    n = xyz.shape[0]
    n_lines = fe.scan_line
    zero = torch.zeros((), device=dev)
    finite = torch.isfinite(xyz).all(dim=-1)
    xs = torch.where(finite[:, None], xyz, zero)
    mask = in_mask & finite & (_sq_norm(xs) >= minimum_range ** 2)

    sid, mask = _scan_id(xs, mask, n_lines)
    rel = _relative_time(xs, mask)
    if isinstance(base_time, torch.Tensor):
        t0 = base_time.to(device=dev, dtype=torch.float32).reshape(())
    else:
        t0 = torch.full((), base_time, dtype=torch.float32, device=dev)
    time = t0 + SCAN_PERIOD * rel

    # regroup by (ring, index)
    idxs = torch.arange(n, device=dev)
    ring = torch.where(mask, sid, torch.full_like(sid, n_lines)).to(torch.int64)
    order = torch.argsort(ring * n + idxs)
    p = xs[order]
    m = mask[order]
    s = ring[order]
    t = time[order]

    # ring start / end in the regrouped layout, +5 / −6 margins (:513-517)
    ring_ids = torch.arange(n_lines, device=dev)
    counts = ((s[None, :] == ring_ids[:, None]) & m[None, :]).sum(dim=1)
    starts = torch.cumsum(counts, 0) - counts
    sp_ring = starts + 5
    ep_ring = starts + counts - 6

    # curvature over ±5 (:522-535)
    acc = -10.0 * p
    for off in range(1, 6):
        acc = acc + _shift(p, off) + _shift(p, -off)
    curv = _sq_norm(acc)
    in_window = (idxs[None, :] >= sp_ring[:, None]) & (idxs[None, :] <= ep_ring[:, None])
    curv = torch.where(in_window.any(dim=0) & m, curv, zero)

    # occlusion and parallel-beam rejection (:538-601)
    depth = torch.sqrt(torch.clamp(_sq_norm(p), min=1e-12))
    nxt = _shift(p, 1)
    d_nxt = _shift(depth, 1)
    big = curv > 0.1
    gap_a = torch.sqrt(_sq_norm(nxt - p * (d_nxt / torch.clamp(depth, min=1e-9))[:, None])) \
        / torch.clamp(d_nxt, min=1e-9)
    gap_b = torch.sqrt(_sq_norm(nxt * (depth / torch.clamp(d_nxt, min=1e-9))[:, None] - p)) \
        / torch.clamp(depth, min=1e-9)
    occ_a = big & (depth > d_nxt) & (gap_a < 0.1)        # masks i-5..i
    occ_b = big & (depth <= d_nxt) & (gap_b < 0.1)       # masks i+1..i+6
    occluded = torch.zeros_like(m)
    for off in range(0, 6):
        occluded = occluded | _shift(occ_a, off)
    for off in range(1, 7):
        occluded = occluded | _shift(occ_b, -off)
    diff2 = _sq_norm(p - _shift(p, -1))
    dis = _sq_norm(p)
    parallel = (curv > 0.0002 * dis) & (diff2 > 0.0002 * dis)
    picked = ~m | occluded | parallel

    # ring × sector windows (:645-760)
    n_sec = n_lines * SECTORS_PER_SCAN
    width = max(8, -(-n // n_sec) + 16)                  # padded window length
    j = torch.arange(SECTORS_PER_SCAN, device=dev)
    sp = torch.div(sp_ring[:, None] * (SECTORS_PER_SCAN - j[None, :])
                   + ep_ring[:, None] * j[None, :], SECTORS_PER_SCAN,
                   rounding_mode="floor").reshape(n_sec)
    ep = (torch.div(sp_ring[:, None] * (SECTORS_PER_SCAN - 1 - j[None, :])
                    + ep_ring[:, None] * (j[None, :] + 1), SECTORS_PER_SCAN,
                    rounding_mode="floor") - 1).reshape(n_sec)
    win = sp[:, None] + torch.arange(width, device=dev)[None, :]
    win_ok = (win <= ep[:, None]) & (ep[:, None] >= sp[:, None])
    win_c = torch.clamp(win, 0, n - 1)
    wcurv = torch.where(win_ok, curv[win_c], zero)
    wpicked = torch.where(win_ok, picked[win_c], torch.ones_like(win_ok))
    close = _sq_norm(p[win_c] - _shift(p, -1)[win_c]) <= SUPPRESS_GAP_SQ   # |p_i − p_{i−1}|²

    sharp = _pick_sharp(win_ok & ~wpicked, wcurv, close)

    flat_idx = win_c.reshape(-1)
    corner_sel = _scatter_any(n, flat_idx, sharp.reshape(-1))
    in_sector = _scatter_any(n, flat_idx, win_ok.reshape(-1))
    surf_sel = in_sector & ~corner_sel & m         # label <= 0 (:761-768)

    def gather(sel):
        mm, px, pt = compact(sel, p, t)
        return PointBatch(xyz=torch.where(mm[:, None], px, zero), time=pt, mask=mm)

    surface = voxel_downsample(gather(surf_sel), fe.mapping_plane_resolution / 2.0)
    tmin = torch.where(m, t, torch.full_like(t, math.inf)).amin()
    tmax = torch.where(m, t, torch.full_like(t, -math.inf)).amax()
    tmin = torch.where(torch.isfinite(tmin), tmin, zero)
    tmax = torch.where(torch.isfinite(tmax), tmax, zero)
    return FeatureFrame(corners=gather(corner_sel), surface=surface,
                        full=PointBatch(xyz=torch.where(m[:, None], p, zero), time=t, mask=m),
                        time_min=tmin, time_max=tmax)
