"""Camera projection models.

Counterpart of ``tpu_ba/geometry/cameras.py``. The BAL model (9 params per
camera, ``[aa(3), t(3), f, k1, k2]``)::

    P  = R(aa) · X + t          # world → camera
    p  = -P_xy / P_z            # BAL cameras look down −z
    r  = 1 + k1·|p|² + k2·|p|⁴  # radial distortion
    u  = f · r · p              # pixel coordinates (origin at center)

and the fixed-K pinhole model (6 params, ``[aa(3), t(3)]``, intrinsics
``[fx, fy, cx, cy]`` per camera, looking down +z) of the SfM front end.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.geometry.rotations import rotate_aa

BAL_CAM_DIM = 9
PINHOLE_CAM_DIM = 6


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def world_to_cam_bal(cam, X):
    """World point (..., 3) → camera frame (..., 3). cam: (..., 9)."""
    return rotate_aa(cam[..., 0:3], X) + cam[..., 3:6]


def project_bal(cam, X):
    """BAL projection. cam: (..., 9), X: (..., 3) → pixel (..., 2).

    The division is guarded, so padded observations give finite values that
    the observation mask kills downstream."""
    P = world_to_cam_bal(cam, X)
    p = -P[..., 0:2] / _safe_z(P[..., 2:3])
    s = torch.sum(p * p, dim=-1, keepdim=True)
    r = 1.0 + s * (cam[..., 7:8] + s * cam[..., 8:9])
    return cam[..., 6:7] * r * p


def camera_center_bal(cam):
    """Optical center C = −Rᵀ t of a BAL camera. cam: (..., 9) → (..., 3)."""
    return rotate_aa(-cam[..., 0:3], -cam[..., 3:6])


def project_pinhole(cam, K, X):
    """Pinhole fixed-K projection. cam: (..., 6), K: (..., 4) [fx fy cx cy],
    X: (..., 3) → pixel (..., 2). Looks down +z."""
    P = rotate_aa(cam[..., 0:3], X) + cam[..., 3:6]
    p = P[..., 0:2] / _safe_z(P[..., 2:3])
    return p * K[..., 0:2] + K[..., 2:4]
