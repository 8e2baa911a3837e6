"""Autodiff Jacobian blocks — the correctness oracle.

Counterpart of ``tpu_ba/jacobians/autodiff.py``: forward-mode autodiff
(``torch.func.jacfwd``, batched by ``torch.func.vmap``) of the
per-observation projection gives the exact 2×9 camera block and 2×3 point
block, which the hand-derived blocks of ``jacobians/analytic.py`` are held
against.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from tpu_ba_torch.geometry.cameras import project_bal


def _proj(cam, X, obs):
    return project_bal(cam, X) - obs


_jac_cam = vmap(jacfwd(_proj, argnums=0), in_dims=(0, 0, 0), out_dims=-1)
_jac_pt = vmap(jacfwd(_proj, argnums=1), in_dims=(0, 0, 0), out_dims=-1)


def jacobian_blocks_bal_autodiff(cameras, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Lane-major (r (2, O), Jc (2, 9, O), Jp (2, 3, O)), masked
    observations zeroed: the layout of ``jacobian_blocks_bal``."""
    cam = cameras[cam_idx]
    X = points[pt_idx]
    r = _proj(cam, X, obs_2d).T
    Jc = _jac_cam(cam, X, obs_2d)
    Jp = _jac_pt(cam, X, obs_2d)
    if mask is not None:
        r = torch.where(mask[None, :], r, torch.zeros_like(r))
        Jc = torch.where(mask[None, None, :], Jc, torch.zeros_like(Jc))
        Jp = torch.where(mask[None, None, :], Jp, torch.zeros_like(Jp))
    return r, Jc, Jp
