"""Loop-closure payoff scoring, the counterpart of
``loam_livox_tpu/eval/loop_payoff.py``.

The reference's loop output is the optimised path and the corrected map
it republishes (``laser_mapping.hpp:845-871``, ``:1091-1100``).  Scored
here against ground truth and against themselves:

* trajectory: the raw (unaligned; drift is the point) ATE of the
  keyframe poses before (`KeyframeRecord.q/t`, the drifted odometry)
  and after (`LoopClosureResult.q_opt/t_opt`) the pose-graph solve;
* map: the mean nearest-neighbour residual between the two keyframe
  clouds that closed the loop, before and after each is moved by its
  pose correction (`loop.map_refine.refine_points`).
"""
from __future__ import annotations

import numpy as np
import torch

#: the noise floor of the scene-alignment measurement in the JAX
#: package's forensics (plane-only coarse-to-fine at 0.1 m over 1 cm
#: clouds): ~0.2 m of implied pose correction
ALIGNMENT_FLOOR_M = 0.2


def _subsample(pts: np.ndarray, n: int = 1500) -> np.ndarray:
    if len(pts) <= n:
        return np.asarray(pts, np.float32)
    return np.asarray(pts[::len(pts) // n][:n], np.float32)


def mean_nn_residual(a: np.ndarray, b: np.ndarray, n_sub: int = 1500) -> float:
    """Symmetric mean nearest-neighbour distance between two clouds
    (each subsampled to ``n_sub`` points), on the CPU."""
    a = torch.from_numpy(_subsample(a, n_sub))
    b = torch.from_numpy(_subsample(b, n_sub))
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)
    ab = torch.sqrt(d2.min(dim=1).values).mean()
    ba = torch.sqrt(d2.min(dim=0).values).mean()
    return float((ab + ba) * 0.5)


def score_loop_payoff(closer, times, gt_pose_at) -> dict:
    """Score an accepted loop: ``closer`` the `LoopCloser`, ``times`` the
    trajectory's row times, ``gt_pose_at(t)`` the true (q, t) at time t.
    Returns {} when no loop was accepted; else the keyframe poses' raw
    ATE before and after the solve, and the revisit clouds' mean NN
    residual before and after the map correction."""
    from ..loop.map_refine import refine_points
    from .ate import ate_rmse

    if closer is None or not closer.closed or closer.result is None:
        return {}
    res = closer.result
    kfs = closer.keyframes
    kt = np.stack([np.asarray(k.t.cpu()) for k in kfs])
    idxs = [min(int(k.ending_frame_idx), len(times) - 1) for k in kfs]
    gt = np.stack([np.asarray(gt_pose_at(times[i])[1]) for i in idxs])
    out = {"ate_kf_raw_before_loop": float(ate_rmse(kt, gt, align=False)),
           "ate_kf_raw_after_loop": float(ate_rmse(np.asarray(res.t_opt), gt, align=False))}

    a, b = kfs[res.his_idx], kfs[res.cur_idx]
    if a.snap_full is not None and b.snap_full is not None and len(a.snap_full) \
            and len(b.snap_full):
        out["revisit_nn_residual_before"] = mean_nn_residual(a.snap_full, b.snap_full)
        a_fix = refine_points(a.snap_full, a.q.cpu(), a.t.cpu(),
                              res.q_opt[res.his_idx], res.t_opt[res.his_idx])
        b_fix = refine_points(b.snap_full, b.q.cpu(), b.t.cpu(),
                              res.q_opt[res.cur_idx], res.t_opt[res.cur_idx])
        out["revisit_nn_residual_after"] = mean_nn_residual(a_fix, b_fix)
    return out


def payoff_verdict(payoff: dict, floor: float = ALIGNMENT_FLOOR_M) -> dict:
    """Judge a scored payoff by regime.  ``drift`` (keyframe ATE before
    the solve at least twice the floor): the solve must lower it.
    ``floor`` (drift at the alignment's own noise): the solve may move it
    by at most the floor, and the revisit clouds must not grow apart by
    more than 2 cm."""
    before = float(payoff["ate_kf_raw_before_loop"])
    after = float(payoff["ate_kf_raw_after_loop"])
    out = {"floor_m": floor}
    if before >= 2.0 * floor:
        out["regime"] = "drift"
        out["ok"] = after < before
    else:
        out["regime"] = "floor"
        ok = abs(after - before) <= floor
        if "revisit_nn_residual_after" in payoff:
            ok = ok and (payoff["revisit_nn_residual_after"]
                         <= payoff["revisit_nn_residual_before"] + 0.02)
        out["ok"] = ok
    return out
