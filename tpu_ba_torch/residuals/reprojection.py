"""Batched reprojection residuals (counterpart of
``tpu_ba/residuals/reprojection.py``)."""

from __future__ import annotations

import torch

from tpu_ba_torch.geometry.cameras import project_bal, project_pinhole


def residuals_bal(cameras, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Per-observation residuals (predicted − measured) for the BAL model.

    cameras: (C, 9), points: (P, 3), obs_2d: (O, 2), cam_idx/pt_idx: (O,).
    Returns (O, 2); masked rows are zero.
    """
    r = project_bal(cameras[cam_idx], points[pt_idx]) - obs_2d
    if mask is not None:
        r = torch.where(mask[:, None], r, torch.zeros_like(r))
    return r


def residuals_pinhole(cameras, intrinsics, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Per-observation residuals for the pinhole fixed-K model.

    cameras: (C, 6), intrinsics: (C, 4), rest as :func:`residuals_bal`.
    """
    r = project_pinhole(cameras[cam_idx], intrinsics[cam_idx], points[pt_idx]) - obs_2d
    if mask is not None:
        r = torch.where(mask[:, None], r, torch.zeros_like(r))
    return r


def cost_from_residuals(r, mask=None):
    """Plain (non-robust) cost ½ Σ |r_o|²."""
    s = torch.sum(r * r, dim=-1)
    if mask is not None:
        s = torch.where(mask, s, torch.zeros_like(s))
    return 0.5 * torch.sum(s)
