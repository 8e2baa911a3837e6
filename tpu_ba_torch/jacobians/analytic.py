"""Hand-derived analytic Jacobian blocks for the BAL camera model.

Counterpart of ``tpu_ba/jacobians/analytic.py``, batched over observations::

    P = R(aa)X + t,  p = -P_xy/P_z,  s = |p|²,  d = 1 + k1·s + k2·s²,
    u = f·d·p,       r = u − obs

    ∂u/∂p  = f·(d·I₂ + 2(k1 + 2k2 s)·p pᵀ)
    ∂p/∂P  = [[-1/z, 0, x/z²], [0, -1/z, y/z²]]
    ∂P/∂t  = I₃,  ∂P/∂X = R
    ∂P/∂aa = −R[X]×(aa aaᵀ + (Rᵀ−I)[aa]×)/θ²   (Gallego–Yezzi; −[X]× as θ→0)
    ∂u/∂f = d·p,  ∂u/∂k1 = f·s·p,  ∂u/∂k2 = f·s²·p

The oracle is ``torch.func.jacfwd`` of ``project_bal`` (tests).
"""

from __future__ import annotations

import torch

from tpu_ba_torch.geometry.rotations import aa_to_matrix, skew

_SMALL_THETA2 = 1e-12


def _jac_batch(cam, X, obs):
    """Residual and Jacobian blocks, observation-major: cam (O, 9),
    X (O, 3), obs (O, 2) → r (O, 2), Jc (O, 2, 9), Jp (O, 2, 3)."""
    dt, dev = cam.dtype, cam.device
    aa, t = cam[:, 0:3], cam[:, 3:6]
    f, k1, k2 = cam[:, 6], cam[:, 7], cam[:, 8]

    R = aa_to_matrix(aa)                                   # (O, 3, 3)
    P = torch.einsum("oij,oj->oi", R, X) + t
    z = P[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    inv_z = 1.0 / z_safe
    p = -P[:, 0:2] * inv_z[:, None]
    s = torch.sum(p * p, dim=-1)
    d = 1.0 + s * (k1 + s * k2)
    u = (f * d)[:, None] * p
    r = u - obs

    eye2 = torch.eye(2, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    dd_ds = k1 + 2.0 * k2 * s
    du_dp = f[:, None, None] * (d[:, None, None] * eye2
                                + 2.0 * dd_ds[:, None, None] * p[:, :, None] * p[:, None, :])
    # dp/dP rows: [-δ/z, ..., -p_i/z]
    e_z = torch.tensor([0.0, 0.0, -1.0], dtype=dt, device=dev)
    dp_dP = (torch.tensor([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=dt, device=dev)
             * inv_z[:, None, None]
             + p[:, :, None] * e_z[None, None, :] * inv_z[:, None, None])
    du_dP = du_dp @ dp_dP                                  # (O, 2, 3)

    theta2 = torch.sum(aa * aa, dim=-1)
    small = theta2 < _SMALL_THETA2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    K_aa = skew(aa)
    core = ((aa[:, :, None] * aa[:, None, :] + (R.transpose(-1, -2) - eye3) @ K_aa)
            / theta2_safe[:, None, None])
    dP_daa = torch.where(small[:, None, None], -skew(X), -R @ skew(X) @ core)

    Jc = torch.cat([
        du_dP @ dP_daa,                        # wrt aa
        du_dP,                                 # wrt t
        (d[:, None] * p)[:, :, None],          # wrt f
        ((f * s)[:, None] * p)[:, :, None],    # wrt k1
        ((f * s * s)[:, None] * p)[:, :, None],  # wrt k2
    ], dim=2)
    Jp = du_dP @ R
    return r, Jc, Jp


def jacobian_blocks_bal(cameras, points, obs_2d, cam_idx, pt_idx, mask=None):
    """Returns lane-major (r (2,O), Jc (2,9,O), Jp (2,3,O)); masked
    observations zeroed. Same contract as the reference."""
    r, Jc, Jp = _jac_batch(cameras[cam_idx], points[pt_idx], obs_2d)
    r = r.T.contiguous()
    Jc = Jc.permute(1, 2, 0).contiguous()
    Jp = Jp.permute(1, 2, 0).contiguous()
    if mask is not None:
        r = torch.where(mask[None, :], r, torch.zeros_like(r))
        Jc = torch.where(mask[None, None, :], Jc, torch.zeros_like(Jc))
        Jp = torch.where(mask[None, None, :], Jp, torch.zeros_like(Jp))
    return r, Jc, Jp
