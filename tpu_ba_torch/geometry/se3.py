"""SE(3) utilities on the (aa(3), t(3)) 6-vector parameterization.

Counterpart of ``tpu_ba/geometry/se3.py``, used by the pose graph and the
SfM front end. A pose ``g = [aa, t]`` maps world points to the local frame,
``g·X = R(aa)X + t``, as the camera models do.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.geometry.rotations import aa_to_matrix, matrix_to_aa, rotate_aa, skew

_SMALL = 1e-12


def se3_apply(g, X):
    """Apply pose (..., 6) to point (..., 3)."""
    return rotate_aa(g[..., 0:3], X) + g[..., 3:6]


def se3_compose(g1, g2):
    """Composition g1∘g2 (apply g2 first): R = R1 R2, t = R1 t2 + t1."""
    aa = matrix_to_aa(aa_to_matrix(g1[..., 0:3]) @ aa_to_matrix(g2[..., 0:3]))
    t = rotate_aa(g1[..., 0:3], g2[..., 3:6]) + g1[..., 3:6]
    return torch.cat([aa, t], dim=-1)


def se3_inverse(g):
    """Inverse pose: R⁻¹ = Rᵀ, t⁻¹ = −Rᵀ t."""
    aa_inv = -g[..., 0:3]
    t_inv = -rotate_aa(aa_inv, g[..., 3:6])
    return torch.cat([aa_inv, t_inv], dim=-1)


def se3_relative(g_i, g_j):
    """Relative pose g_i ∘ g_j⁻¹: the transform taking frame-j coordinates
    to frame-i coordinates (the pose graph's measurement model)."""
    return se3_compose(g_i, se3_inverse(g_j))


def _V_matrix(aa):
    """The SE(3) left Jacobian V(aa), t = V·rho in exp([rho, aa])."""
    theta2 = torch.sum(aa * aa, dim=-1)[..., None, None]
    small = theta2 < _SMALL
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = skew(aa)
    K2 = K @ K
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return eye + A * K + B * K2


def se3_exp(xi):
    """Exponential map: twist (..., 6) = [rho(3), aa(3)] → pose (..., 6)."""
    rho, aa = xi[..., 0:3], xi[..., 3:6]
    t = (_V_matrix(aa) @ rho[..., None])[..., 0]
    return torch.cat([aa, t], dim=-1)


def se3_log(g):
    """Log map: pose (..., 6) → twist (..., 6) = [rho, aa]; rho solves
    V rho = t as one batched solve."""
    aa, t = g[..., 0:3], g[..., 3:6]
    rho = torch.linalg.solve(_V_matrix(aa), t[..., None])[..., 0]
    return torch.cat([rho, aa], dim=-1)
