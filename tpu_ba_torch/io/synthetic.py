"""Synthetic ring-of-cameras BA problem with known ground truth.

Counterpart of ``tpu_ba/io/synthetic.py``. Host-side numpy drawn from
``np.random.default_rng(seed)`` in the reference's order, so both packages
build byte-identical problems from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ba_torch.core import BAProblem, make_problem


def _cross_np(a, b):
    """Component-wise cross product of (..., 3) arrays."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1)


def _look_at_rotation(center, target, up=(0.0, 1.0, 0.0)):
    """Rotation matrix (rows = camera axes) for a BAL camera at ``center``
    looking at ``target`` — the view direction maps to −z (BAL convention)."""
    d = target - center
    d = d / np.linalg.norm(d)
    z_cam = -d
    up = np.asarray(up, float)
    x_cam = _cross_np(up, z_cam)
    n = np.linalg.norm(x_cam)
    if n < 1e-8:  # view parallel to up: pick another up
        up = np.array([1.0, 0.0, 0.0])
        x_cam = _cross_np(up, z_cam)
        n = np.linalg.norm(x_cam)
    x_cam /= n
    y_cam = _cross_np(z_cam, x_cam)
    return np.stack([x_cam, y_cam, z_cam])


def _matrix_to_aa_np(R):
    """Rotation matrix → angle-axis (host-side numpy)."""
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-10:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near pi: axis from diagonal of (R + I)/2, signs from off-diagonals
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diagonal(A), 0.0))
        if axis[0] > 0:
            axis[1] *= np.sign(A[0, 1]) if A[0, 1] != 0 else 1.0
            axis[2] *= np.sign(A[0, 2]) if A[0, 2] != 0 else 1.0
        axis /= np.linalg.norm(axis)
        return theta * axis
    axis = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(theta))
    )
    return theta * axis


def _project_bal_np(cams, X):
    """Vectorized numpy BAL projection. cams: (O, 9), X: (O, 3) → (O, 2)."""
    aa, t = cams[:, 0:3], cams[:, 3:6]
    f, k1, k2 = cams[:, 6:7], cams[:, 7:8], cams[:, 8:9]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    small = theta < 1e-12
    k = aa / np.where(small, 1.0, theta)
    c, s = np.cos(theta), np.sin(theta)
    P = X * c + _cross_np(k, X) * s + k * np.sum(k * X, 1, keepdims=True) * (1 - c) + t
    P = np.where(small, X + t, P)
    p = -P[:, 0:2] / P[:, 2:3]
    s2 = np.sum(p * p, 1, keepdims=True)
    return f * (1.0 + k1 * s2 + k2 * s2 * s2) * p


def make_synthetic_problem(
    n_cams: int = 20,
    n_pts: int = 500,
    *,
    obs_per_point: int = 8,
    pixel_noise: float = 1.0,
    cam_perturb: float = 0.03,
    point_perturb: float = 0.10,
    intrinsics_perturb: float = 0.0,
    focal: float = 500.0,
    k1: float = 0.0,
    k2: float = 0.0,
    radius: float = 10.0,
    cloud_radius: float = 3.0,
    seed: int = 0,
    dtype=torch.float32,
    pad_multiple: int = 1024,
    device="cpu",
) -> tuple[BAProblem, dict]:
    """A ring-of-cameras BA problem; each point is seen by its
    ``obs_per_point`` nearest cameras. Returns (problem, ground_truth)."""
    rng = np.random.default_rng(seed)

    angles = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack(
        [radius * np.cos(angles), 0.5 * rng.standard_normal(n_cams), radius * np.sin(angles)],
        axis=-1,
    )
    points_gt = cloud_radius * rng.standard_normal((n_pts, 3)) * np.array([1.0, 0.6, 1.0])

    cams_gt = np.zeros((n_cams, 9))
    for i in range(n_cams):
        R = _look_at_rotation(centers[i], np.zeros(3))
        cams_gt[i, 0:3] = _matrix_to_aa_np(R)
        cams_gt[i, 3:6] = -R @ centers[i]
        cams_gt[i, 6] = focal * (1.0 + 0.02 * rng.standard_normal())
        cams_gt[i, 7] = k1
        cams_gt[i, 8] = k2

    d2 = ((points_gt[:, None, :] - centers[None, :, :]) ** 2).sum(-1)  # (P, C)
    k_obs = min(obs_per_point, n_cams)
    nearest = np.argsort(d2, axis=1)[:, :k_obs]
    pt_idx = np.repeat(np.arange(n_pts), k_obs)
    cam_idx = nearest.reshape(-1)

    obs = _project_bal_np(cams_gt[cam_idx], points_gt[pt_idx])
    obs += pixel_noise * rng.standard_normal(obs.shape)

    cams0 = cams_gt.copy()
    cams0[:, 0:3] += cam_perturb * rng.standard_normal((n_cams, 3))
    cams0[:, 3:6] += cam_perturb * radius * 0.3 * rng.standard_normal((n_cams, 3))
    if intrinsics_perturb > 0:
        cams0[:, 6] *= 1.0 + intrinsics_perturb * rng.standard_normal(n_cams)
    points0 = points_gt + point_perturb * rng.standard_normal((n_pts, 3))

    problem = make_problem(
        cams0, points0, obs, cam_idx, pt_idx, model="bal", dtype=dtype,
        pad_multiple=pad_multiple, device=device,
    )
    ground_truth = {
        "cameras": cams_gt,
        "points": points_gt,
        "pixel_noise": pixel_noise,
        "n_obs": len(pt_idx),
    }
    return problem, ground_truth
