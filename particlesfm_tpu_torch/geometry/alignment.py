"""Umeyama Sim(3)/SE(3) trajectory alignment + ATE/RPE metrics.
(copy of particlesfm_tpu/geometry/alignment.py; numpy only).

Replaces the reference's external `evo` dependency
(upstream evaluation_evo/eval_sintel.py): ATE = RMSE of translation after
Sim3 (or SE3) Umeyama alignment; RPE = relative pose error with delta=1 frame.

"""
from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ~ s * R @ src + t.

    src, dst: (N,3). Returns (s, R (3,3), t (3,)).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE, meters) after Umeyama alignment."""
    s, R, t = umeyama(est_centers, gt_centers, with_scale=with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    err = np.linalg.norm(aligned - gt_centers, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(est_R: np.ndarray, est_t: np.ndarray, gt_R: np.ndarray, gt_t: np.ndarray, delta: int = 1):
    """Relative pose error with fixed frame delta (all pairs i, i+delta).

    Poses are cam->world (R (N,3,3), centers t (N,3)).
    Returns (rpe_trans_rmse [m], rpe_rot_rmse [deg]).
    """
    est_R, est_t = np.asarray(est_R, np.float64), np.asarray(est_t, np.float64)
    gt_R, gt_t = np.asarray(gt_R, np.float64), np.asarray(gt_t, np.float64)
    n = est_R.shape[0]
    # align scale (monocular): scale est relative motion to gt via Umeyama scale
    s, _, _ = umeyama(est_t, gt_t, with_scale=True)
    terrs, rerrs = [], []
    for i in range(n - delta):
        j = i + delta
        dR_est = est_R[i].T @ est_R[j]
        dt_est = est_R[i].T @ (est_t[j] - est_t[i]) * s
        dR_gt = gt_R[i].T @ gt_R[j]
        dt_gt = gt_R[i].T @ (gt_t[j] - gt_t[i])
        dR = dR_est.T @ dR_gt
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2.0, -1.0, 1.0)))
        terrs.append(np.linalg.norm(dt_est - dt_gt))
        rerrs.append(ang)
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return float(np.sqrt((terrs ** 2).mean())), float(np.sqrt((rerrs ** 2).mean()))
