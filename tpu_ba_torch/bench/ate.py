"""Trajectory accuracy metrics: ATE (after Umeyama alignment) and RPE.

Counterpart of ``tpu_ba/bench/ate.py``. SfM reconstructs up to a similarity
gauge, so ATE is computed after a closed-form Umeyama Sim(3) alignment of
the estimated camera centers to ground truth (the TUM-benchmark procedure).
numpy on the host; rotations through the port's ``aa_to_matrix`` in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ba_torch.geometry.rotations import aa_to_matrix


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """(F, 6) [aa, t] world→camera poses → (F, 3) camera centers −Rᵀt."""
    poses = np.asarray(poses, np.float64)
    R = aa_to_matrix(torch.as_tensor(poses[:, 0:3])).numpy()
    return -np.einsum("fji,fj->fi", R, poses[:, 3:6])


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form similarity transform minimizing |dst − (s·R·src + t)|².

    Returns (s, R (3,3), t (3,)). Requires ≥3 non-degenerate points.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs * xs).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-30)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _centers(est_poses, gt_poses, mask):
    est_c, gt_c = camera_centers(est_poses), camera_centers(gt_poses)
    if mask is not None:
        est_c, gt_c = est_c[mask], gt_c[mask]
    return est_c, gt_c


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             mask: np.ndarray | None = None, with_scale: bool = True):
    """Absolute trajectory error (RMSE of aligned camera centers).

    est/gt: (F, 6) [aa, t]; mask selects the frames to evaluate (e.g. the
    registered ones). Returns dict with rmse, mean, max, alignment scale.
    """
    est_c, gt_c = _centers(est_poses, gt_poses, mask)
    s, R, t = umeyama_alignment(est_c, gt_c, with_scale=with_scale)
    aligned = (s * (R @ est_c.T)).T + t
    err = np.linalg.norm(aligned - gt_c, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err ** 2))),
        "ate_mean": float(err.mean()),
        "ate_max": float(err.max()),
        "frames": int(est_c.shape[0]),
        "align_scale": s,
    }


def rpe_stats(est_poses: np.ndarray, gt_poses: np.ndarray,
              mask: np.ndarray | None = None, delta: int = 1):
    """Relative pose error over frame pairs (i, i+delta): translation drift
    per step, scale-corrected by the global Umeyama scale."""
    est_c, gt_c = _centers(est_poses, gt_poses, mask)
    s, _, _ = umeyama_alignment(est_c, gt_c)
    de = np.linalg.norm(np.diff(est_c[::delta], axis=0), axis=1) * s
    dg = np.linalg.norm(np.diff(gt_c[::delta], axis=0), axis=1)
    err = np.abs(de - dg)
    return {"rpe_mean": float(err.mean()), "rpe_max": float(err.max())}
