"""Angle-axis rotations (Rodrigues), the subset the BAL slice uses.

Counterpart of ``tpu_ba/geometry/rotations.py``: ``rotate_aa``,
``aa_to_matrix``, ``skew`` and the NaN-free ``_safe_theta``. Small-angle
branches use ``torch.where`` on safe intermediates, so values and
``torch.func`` derivatives stay finite at θ = 0.
"""

from __future__ import annotations

import torch

# below this squared angle the 2nd-order Taylor forms take over
_SMALL_THETA2 = 1e-12


def _safe_theta(theta2):
    """sqrt(theta2) that is NaN-free (value and gradient) at theta2 == 0."""
    small = theta2 < _SMALL_THETA2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    return small, torch.sqrt(theta2_safe)


def rotate_aa(aa, x):
    """Rotate point(s) ``x`` (..., 3) by angle-axis ``aa`` (..., 3).

    Rodrigues: R x = x cos(t) + (k × x) sin(t) + k (k·x)(1 − cos(t)),
    k = aa/t, t = |aa|. Near t = 0: R x ≈ x + aa × x + ½ aa × (aa × x).
    """
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small, theta = _safe_theta(theta2)
    k = aa / theta
    c = torch.cos(theta)
    s = torch.sin(theta)
    k, x = torch.broadcast_tensors(k, x)
    kxx = torch.linalg.cross(k, x, dim=-1)
    kdx = torch.sum(k * x, dim=-1, keepdim=True)
    rot = x * c + kxx * s + k * kdx * (1.0 - c)
    aa_b = torch.broadcast_to(aa, x.shape)
    aaxx = torch.linalg.cross(aa_b, x, dim=-1)
    rot_small = x + aaxx + 0.5 * torch.linalg.cross(aa_b, aaxx, dim=-1)
    return torch.where(small, rot_small, rot)


def aa_to_matrix(aa):
    """Angle-axis (..., 3) → rotation matrix (..., 3, 3)."""
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(aa.shape[:-1] + (3, 3))
    cols = rotate_aa(aa[..., None, :], eye)  # rotates each basis vector
    return cols.transpose(-1, -2)


def skew(v):
    """(..., 3) → skew-symmetric matrix [v]× (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        torch.stack([zeros, -vz, vy], dim=-1),
        torch.stack([vz, zeros, -vx], dim=-1),
        torch.stack([-vy, vx, zeros], dim=-1),
    ], dim=-2)
