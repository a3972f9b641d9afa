"""Absolute trajectory error (ATE), a frozen copy of the program's
metric arithmetic: the evaluation metric the
reference's papers report and BASELINE.json targets (ATE RMSE on the
HKU_ZYM / HKUST_01 sequences).

Standard Horn/Umeyama SE(3) alignment (no scale) of the estimated
trajectory onto ground truth, then RMSE over translational residuals.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray):
    """Least-squares rigid alignment est -> gt. Returns (R, t)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    H = E.T @ G / len(est)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True):
    """ATE RMSE (meters) between matched position sequences (N, 3)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        R, t = umeyama_alignment(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))
