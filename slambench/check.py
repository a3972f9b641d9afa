"""Whether the timed path's outputs are correct: the program's rows and
states held against the plain reference (`reference`), which reads
them only to judge them.

The reference is eager PyTorch, many times slower than the program's
graphs, so it cannot replay a whole window.  It checks two things on
its own inputs, the frames the benchmark made:

* the start: from the initial state over the stream's first frames (the
  accumulation window and the first registrations), its own rows and
  state against the program's;
* the window: at each frame the sampler kept (drawn from the seed, and
  the last frame the window ran), one step from the program's state
  before that frame, at the program's tier of the capacity schedule;
  its rows, its state after the frame and (several heads) the frame's
  pieces against the program's.

The numbers compared, each the largest over what it covers:

* ``pose_gap_m``: the distance between a row's position and the
  reference's; infinite where the rows' count or acceptance differ;
* ``map_gap_m``: the largest coordinate gap of a history-ring or
  matching-buffer point valid on either side (the map the frame leaves);
  infinite where the masks, the ring's pointers or the counters differ;
* ``feature_gap_m`` (several heads): the largest coordinate gap of a
  piece's corner, surface or full-cloud point, or of its time range;
  infinite where the masks differ.

A buffer the schedule re-padded is compared over its valid prefix, and
its padding must be empty.

``control="tf32"`` puts the reference computed with TF32 matrix
products in the program's place (the start from its own state, each
step from the program's state before the frame): the lower precision
that the check has to refuse.
"""
from __future__ import annotations

import math
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .reference import config as RC
from .reference.odometry import OdometryState
from .reference.ops import FeatureFrame, PointBatch
from .reference.pipeline import PlainOdometry
from .yardstick.ate import ate_rmse

INF = math.inf


def to_reference_state(state) -> Optional[OdometryState]:
    """The reference's state from the program's (its fields by name)."""
    if state is None:
        return None
    fields = {f: getattr(state, f) for f in OdometryState._fields}
    for f in ("map_corners", "map_surface"):
        fields[f] = PointBatch(*fields[f])
    return OdometryState(**fields)


def _pieces(frames) -> List[FeatureFrame]:
    return [FeatureFrame(PointBatch(*f.corners), PointBatch(*f.surface), PointBatch(*f.full),
                         f.time_min, f.time_max) for f in frames]


def _fit(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` over their common leading shape, and whether what
    lies past it on either side is empty (zero)."""
    common = tuple(min(x, y) for x, y in zip(a.shape, b.shape))
    sl = tuple(slice(0, n) for n in common)
    rest_empty = bool((a.abs().sum() == a[sl].abs().sum()).item()) if a.dtype != torch.bool \
        else int(a.sum()) == int(a[sl].sum())
    rest_empty_b = bool((b.abs().sum() == b[sl].abs().sum()).item()) if b.dtype != torch.bool \
        else int(b.sum()) == int(b[sl].sum())
    return a[sl], b[sl], rest_empty and rest_empty_b


def _cloud_gap(xa, ma, xb, mb) -> float:
    """Largest coordinate gap over slots valid on either side; infinite
    where the masks differ or a padding slot is set."""
    ma, mb, ok_m = _fit(ma, mb)
    xa, xb, _ = _fit(xa, xb)
    if not ok_m or not torch.equal(ma, mb):
        return INF
    if not bool(ma.any()):
        return 0.0
    return float((xa[ma] - xb[mb]).abs().max())


def state_gap(a: OdometryState, b: OdometryState) -> float:
    """``map_gap_m`` of two states (module doc)."""
    for f in ("frame_count", "hist_ptr", "hist_len"):
        if int(getattr(a, f)) != int(getattr(b, f)):
            return INF
    gaps = [_cloud_gap(a.hist_corner_xyz, a.hist_corner_mask, b.hist_corner_xyz,
                       b.hist_corner_mask),
            _cloud_gap(a.hist_surf_xyz, a.hist_surf_mask, b.hist_surf_xyz, b.hist_surf_mask),
            _cloud_gap(a.map_corners.xyz, a.map_corners.mask, b.map_corners.xyz,
                       b.map_corners.mask),
            _cloud_gap(a.map_surface.xyz, a.map_surface.mask, b.map_surface.xyz,
                       b.map_surface.mask)]
    return max(gaps)


def rows_gap(cand: np.ndarray, ref: np.ndarray) -> float:
    """``pose_gap_m`` of two row sets ((n, >= 9): time, t, q, accepted)."""
    if cand.shape[0] != ref.shape[0]:
        return INF
    if cand.shape[0] == 0:
        return 0.0
    if np.any(cand[:, 8] != ref[:, 8]) or np.any(cand[:, 0] != ref[:, 0]):
        return INF
    return float(np.linalg.norm(cand[:, 1:4] - ref[:, 1:4], axis=1).max())


def features_gap(a: List[FeatureFrame], b: List[FeatureFrame]) -> float:
    if len(a) != len(b):
        return INF
    gap = 0.0
    for fa, fb in zip(a, b):
        for ca, cb in ((fa.corners, fb.corners), (fa.surface, fb.surface), (fa.full, fb.full)):
            gap = max(gap, _cloud_gap(ca.xyz, ca.mask, cb.xyz, cb.mask))
        gap = max(gap, float((fa.time_min - fb.time_min).abs()),
                  float((fa.time_max - fb.time_max).abs()))
    return gap


def _frame(frames, i: int, dev):
    return tuple(getattr(frames, k)[i].to(dev) for k in ("xyz", "inten", "mask")) + (
        frames.t0[i],)


def _step(ref: PlainOdometry, frames, i: int, dev, n_heads: int):
    """Frame ``i`` through the reference; returns its pieces (several heads)."""
    xyz, inten, mask, t0 = _frame(frames, i, dev)
    if n_heads == 1:
        ref.process_raw(xyz[0], inten[0], mask[0], t0)
        return None
    pieces = ref.head_frames(xyz, inten, mask, t0)
    for p in pieces:
        ref.process_feature_frame(p)
    return pieces


def _rows_np(ref: PlainOdometry) -> np.ndarray:
    return ref.rows().double().cpu().numpy() if ref._rows else np.zeros((0, 10))


class _Precision:
    """TF32 matrix products on (the control) or off (the reference)."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old


def judge(cfg_doc: dict, frames, dev, rows: np.ndarray, per_frame: int, start, snaps,
          n_frames_run: int, control: Optional[str] = None
          ) -> Tuple[dict, List[float]]:
    """The numbers compared (module doc) and each compared window frame's
    ``pose_gap_m``.  ``rows`` are the program's (time, t, q, accepted) of
    every registration it ran, ``start`` and ``snaps`` its kept states."""
    cfg = RC.SlamConfig().replace(**cfg_doc["slam"])
    n_heads = len(cfg_doc["site"].get("heads_yaw_deg", [0.0]))
    if rows.shape[0] != n_frames_run * per_frame:
        return {"pose_gap_m": INF, "map_gap_m": INF}, [INF]
    tf32 = control == "tf32"
    pose: List[float] = []
    maps: List[float] = []
    feats: List[float] = []

    t0 = time.perf_counter()
    # the start, from the initial state
    n_start = start.frame + 1
    with _Precision(False):
        ref = PlainOdometry(cfg, dev)
        for i in range(n_start):
            _step(ref, frames, i, dev, n_heads)
    ref_rows, ref_state = _rows_np(ref), ref.state
    cand_rows, cand_state = rows[:n_start * per_frame], start.post
    if tf32:
        with _Precision(True):
            ctl = PlainOdometry(cfg, dev)
            for i in range(n_start):
                _step(ctl, frames, i, dev, n_heads)
        cand_rows, cand_state = _rows_np(ctl), ctl.state
    pose.append(rows_gap(cand_rows, ref_rows))
    maps.append(state_gap(cand_state, ref_state))

    t_start = time.perf_counter() - t0
    # the window, a step from the program's state before each kept frame
    window_gaps = []
    for s in snaps:
        with _Precision(False):
            ref = PlainOdometry(cfg, dev)
            ref.resume(s.pre, s.scale)
            ref_pieces = _step(ref, frames, s.frame, dev, n_heads)
        ref_rows, ref_state = _rows_np(ref), ref.state
        cand_rows = rows[s.frame * per_frame:(s.frame + 1) * per_frame]
        cand_state, cand_pieces = s.post, s.features
        if tf32:
            with _Precision(True):
                ctl = PlainOdometry(cfg, dev)
                ctl.resume(s.pre, s.scale)
                cand_pieces = _step(ctl, frames, s.frame, dev, n_heads)
            cand_rows, cand_state = _rows_np(ctl), ctl.state
        gap = rows_gap(cand_rows, ref_rows)
        window_gaps.append(gap)
        pose.append(gap)
        maps.append(state_gap(cand_state, ref_state))
        if n_heads > 1:
            feats.append(features_gap(_pieces(cand_pieces), ref_pieces))
    print(f"slambench: the reference took {t_start:.1f} s over the first {n_start} frames, "
          f"{time.perf_counter() - t0 - t_start:.1f} s over {len(snaps)} window frames"
          + (" (with the control)" if tf32 else ""), file=sys.stderr)
    checks = {"pose_gap_m": max(pose), "map_gap_m": max(maps)}
    if n_heads > 1:
        checks["feature_gap_m"] = max(feats, default=0.0)
    return checks, window_gaps


def window_ate(site, rows: np.ndarray, first_row: int) -> float:
    """Aligned ATE (m) of the window's rows against the site's ground
    truth at each row's time."""
    from .gen.stream import ground_truth

    win = rows[first_row:]
    if len(win) < 3:
        return float("nan")
    return ate_rmse(win[:, 1:4], ground_truth(site, win[:, 0]))
