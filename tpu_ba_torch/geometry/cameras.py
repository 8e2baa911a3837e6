"""BAL camera projection (9 params / camera: ``[aa(3), t(3), f, k1, k2]``).

Counterpart of ``tpu_ba/geometry/cameras.py``::

    P  = R(aa) · X + t          # world → camera
    p  = -P_xy / P_z            # BAL cameras look down −z
    r  = 1 + k1·|p|² + k2·|p|⁴  # radial distortion
    u  = f · r · p              # pixel coordinates (origin at center)
"""

from __future__ import annotations

import torch

from tpu_ba_torch.geometry.rotations import rotate_aa


def world_to_cam_bal(cam, X):
    """World point (..., 3) → camera frame (..., 3). cam: (..., 9)."""
    return rotate_aa(cam[..., 0:3], X) + cam[..., 3:6]


def project_bal(cam, X):
    """BAL projection. cam: (..., 9), X: (..., 3) → pixel (..., 2).

    The division is guarded, so padded observations give finite values that
    the observation mask kills downstream."""
    P = world_to_cam_bal(cam, X)
    z = P[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    p = -P[..., 0:2] / z_safe
    s = torch.sum(p * p, dim=-1, keepdim=True)
    r = 1.0 + s * (cam[..., 7:8] + s * cam[..., 8:9])
    return cam[..., 6:7] * r * p
