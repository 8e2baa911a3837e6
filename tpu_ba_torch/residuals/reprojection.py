"""Batched reprojection residuals (counterpart of
``tpu_ba/residuals/reprojection.py``)."""

from __future__ import annotations

import torch

from tpu_ba_torch.geometry.cameras import project_bal


def residuals_bal(cameras, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Per-observation residuals (predicted − measured) for the BAL model.

    cameras: (C, 9), points: (P, 3), obs_2d: (O, 2), cam_idx/pt_idx: (O,).
    Returns (O, 2); masked rows are zero.
    """
    r = project_bal(cameras[cam_idx], points[pt_idx]) - obs_2d
    if mask is not None:
        r = torch.where(mask[:, None], r, torch.zeros_like(r))
    return r
