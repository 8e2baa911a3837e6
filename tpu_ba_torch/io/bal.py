"""BAL-dimension-matched stand-in problems (ring covisibility).

Counterpart of ``tpu_ba/io/bal.py:make_bal_like_problem``: cameras along a
closed vehicle loop, points in a band around it, each point seen by a window
of nearby cameras — the Ladybug structure, at the published BAL counts of
cameras, points and observations. Numpy drawn from
``np.random.default_rng(seed)`` in the reference's order, so both packages
generate byte-identical problems; the ``data/cache/*.npz`` cache uses the
reference's key and format, so either package's cache serves the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_ba_torch.core import make_problem
from tpu_ba_torch.io.synthetic import (_cross_np, _look_at_rotation,
                                       _matrix_to_aa_np, _project_bal_np)

# (n_cameras, n_points, n_observations) of the canonical BAL problems
BAL_DATASET_DIMS = {
    "ladybug-49": (49, 7776, 31843),
    "ladybug-1723": (1723, 156502, 678718),
    "trafalgar-257": (257, 65132, 225911),
    "venice-1778": (1778, 993923, 5001946),
}


def make_bal_like_problem(
    name: str,
    *,
    pixel_noise: float = 1.0,
    cam_perturb: float = 0.02,
    point_perturb: float = 0.05,
    intrinsics_perturb: float = 0.0,
    outlier_frac: float = 0.0,
    seed: int = 0,
    dtype=torch.float32,
    pad_multiple: int = 1024,
    covis: str = "ring",
    device="cpu",
):
    """Synthesize the ring stand-in for BAL problem ``name``, with its exact
    observation count. Returns (problem, ground_truth dict). The cache lives
    under ``data/cache/`` relative to the working directory."""
    if name not in BAL_DATASET_DIMS:
        raise KeyError(f"unknown BAL stand-in {name!r}; have {sorted(BAL_DATASET_DIMS)}")
    if covis != "ring":
        raise NotImplementedError(
            f"covis={covis!r}: only the ring stand-in is ported "
            "(community covisibility: ROADMAP queue 1, item 7)")
    n_cams, n_pts, n_obs = BAL_DATASET_DIMS[name]

    cache_key = (f"balstandin_{name}_s{seed}_n{pixel_noise}_c{cam_perturb}"
                 f"_p{point_perturb}_i{intrinsics_perturb}_o{outlier_frac}")
    cache_path = os.path.join("data", "cache", cache_key + ".npz")
    if os.path.exists(cache_path):
        z = np.load(cache_path)
        problem = make_problem(
            z["cams0"], z["points0"], z["obs"], z["cam_idx"], z["pt_idx"],
            model="bal", dtype=dtype, pad_multiple=pad_multiple, device=device)
        ground_truth = {"cameras": z["cams_gt"], "points": z["points_gt"],
                        "pixel_noise": pixel_noise, "n_obs": int(z["cam_idx"].shape[0])}
        return problem, ground_truth

    rng = np.random.default_rng(seed)

    # trajectory: closed loop of radius R with lateral wobble
    s = 2 * np.pi * np.arange(n_cams) / n_cams
    R_loop = 30.0
    centers = np.stack(
        [R_loop * np.cos(s), 0.2 * rng.standard_normal(n_cams), R_loop * np.sin(s)],
        axis=-1,
    )

    # points scattered in an annulus around the loop, biased outward
    ang = 2 * np.pi * rng.random(n_pts)
    rad = R_loop + rng.normal(8.0, 3.0, n_pts)
    height = rng.normal(1.0, 2.0, n_pts)
    points_gt = np.stack([rad * np.cos(ang), height, rad * np.sin(ang)], axis=-1)

    cams_gt = np.zeros((n_cams, 9))
    for i in range(n_cams):
        # look outward from the loop at the point band
        target = centers[i] * np.array([1.3, 0.0, 1.3])
        Rm = _look_at_rotation(centers[i], target)
        cams_gt[i, 0:3] = _matrix_to_aa_np(Rm)
        cams_gt[i, 3:6] = -Rm @ centers[i]
        cams_gt[i, 6] = 400.0 * (1.0 + 0.05 * rng.standard_normal())
        cams_gt[i, 7] = -1e-7 * rng.random()
        cams_gt[i, 8] = 1e-13 * rng.random()

    # visibility: candidate cameras in an angular window around each point,
    # kept where the point is in front of the camera (−z) at a sane pixel
    pt_ang = np.arctan2(points_gt[:, 2], points_gt[:, 0])
    cam_ang = np.arctan2(centers[:, 2], centers[:, 0])
    k_target = max(int(np.ceil(n_obs / n_pts)), 2)
    k_window = min(n_cams, 2 * k_target + 4)
    cam_order = np.argsort(cam_ang)
    nearest_pos = np.searchsorted(cam_ang[cam_order], pt_ang) % n_cams
    offsets = np.arange(k_window) - k_window // 2
    window = cam_order[(nearest_pos[:, None] + offsets[None, :]) % n_cams]  # (P, k)

    cand_cam = window.reshape(-1).astype(np.int32)
    cand_pt = np.repeat(np.arange(n_pts, dtype=np.int32), k_window)
    cam_flat = cams_gt[cand_cam]
    X_flat = points_gt[cand_pt]
    aa, t = cam_flat[:, 0:3], cam_flat[:, 3:6]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    k_ax = aa / np.where(theta < 1e-12, 1.0, theta)
    c, s = np.cos(theta), np.sin(theta)
    P = (X_flat * c + _cross_np(k_ax, X_flat) * s
         + k_ax * np.sum(k_ax * X_flat, 1, keepdims=True) * (1 - c) + t)
    uv = _project_bal_np(cam_flat, X_flat)
    valid = (P[:, 2] < -1.0) & (np.abs(uv) < 1500.0).all(axis=1)

    # rank candidates per point: valid first, then nearest in window order
    valid_mat = valid.reshape(n_pts, k_window)
    rank = np.argsort(~valid_mat, axis=1, kind="stable")[:, :k_target]  # (P, k_t)
    chosen_valid = np.take_along_axis(valid_mat, rank, axis=1)
    cam_idx = np.take_along_axis(window, rank, axis=1)[chosen_valid].astype(np.int32)
    pt_idx = np.repeat(np.arange(n_pts, dtype=np.int32), k_target).reshape(
        n_pts, k_target)[chosen_valid]

    # match the exact observation count: trim extras or duplicate valid pairs
    total = cam_idx.shape[0]
    if total > n_obs:
        keep = rng.permutation(total)[:n_obs]
        keep.sort()
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]
    elif total < n_obs:
        extra = rng.integers(0, total, n_obs - total)
        cam_idx = np.concatenate([cam_idx, cam_idx[extra]])
        pt_idx = np.concatenate([pt_idx, pt_idx[extra]])

    obs = _project_bal_np(cams_gt[cam_idx], points_gt[pt_idx])
    obs += pixel_noise * rng.standard_normal(obs.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * obs.shape[0])
        out_idx = rng.choice(obs.shape[0], n_out, replace=False)
        obs[out_idx] += rng.normal(0.0, 40.0, (n_out, 2))  # gross outliers

    cams0 = cams_gt.copy()
    cams0[:, 0:3] += cam_perturb * rng.standard_normal((n_cams, 3))
    cams0[:, 3:6] += cam_perturb * 5.0 * rng.standard_normal((n_cams, 3))
    if intrinsics_perturb > 0:
        cams0[:, 6] *= 1.0 + intrinsics_perturb * rng.standard_normal(n_cams)
        cams0[:, 7] = 0.0  # start distortion from zero: must be re-estimated
        cams0[:, 8] = 0.0
    points0 = points_gt + point_perturb * rng.standard_normal((n_pts, 3))

    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    np.savez_compressed(
        cache_path, cams0=cams0, points0=points0, obs=obs,
        cam_idx=cam_idx, pt_idx=pt_idx, cams_gt=cams_gt, points_gt=points_gt,
    )

    problem = make_problem(cams0, points0, obs, cam_idx, pt_idx, model="bal",
                           dtype=dtype, pad_multiple=pad_multiple, device=device)
    ground_truth = {"cameras": cams_gt, "points": points_gt,
                    "pixel_noise": pixel_noise, "n_obs": int(cam_idx.shape[0])}
    return problem, ground_truth
