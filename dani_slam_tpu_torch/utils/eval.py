"""Trajectory evaluation: ATE RMSE with Horn alignment (counterpart of
dani_slam_tpu/utils/eval.py; numpy only)."""
from __future__ import annotations

import numpy as np


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (reference:
    evaluation/associate.py). Returns (idx_est, idx_gt)."""
    ie, ig = [], []
    for i, te in enumerate(t_est):
        j = int(np.argmin(np.abs(t_gt - te)))
        if abs(t_gt[j] - te) <= max_dt:
            ie.append(i)
            ig.append(j)
    return np.asarray(ie, int), np.asarray(ig, int)


def align_horn(P: np.ndarray, Q: np.ndarray, with_scale: bool = False):
    """(s, R, t) minimizing ||Q - (s R P + t)|| for [N,3] point sets."""
    mu_p, mu_q = P.mean(0), Q.mean(0)
    Pc, Qc = P - mu_p, Q - mu_q
    U, D, Vt = np.linalg.svd(Qc.T @ Pc)
    E = np.eye(3)
    E[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ E @ Vt
    s = (D * np.diag(E)).sum() / (Pc ** 2).sum() if with_scale else 1.0
    return s, R, mu_q - s * R @ mu_p


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray,
             with_scale: bool = False) -> float:
    """RMSE of aligned positions; rows already associated."""
    s, R, t = align_horn(traj_est, traj_gt, with_scale)
    err = np.linalg.norm((s * (R @ traj_est.T)).T + t - traj_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def centers_from_tcw(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """Camera centers C = -R^T t for stacked poses [N,3,3], [N,3]."""
    return -np.einsum('nji,nj->ni', R_cw, t_cw)
