"""Rotation parameterizations: angle-axis (Rodrigues), quaternions, matrices.

Counterpart of ``tpu_ba/geometry/rotations.py``, with its public names.
Small-angle branches use ``torch.where`` on safe intermediates, so values and
``torch.func`` derivatives stay finite at θ = 0. Quaternions are (w, x, y, z).
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


def rotate_aa_transpose(aa, x):
    """Apply the inverse rotation: R(aa)ᵀ x = R(−aa) x."""
    return rotate_aa(-aa, x)


def aa_to_matrix(aa):
    """Angle-axis (..., 3) → rotation matrix (..., 3, 3)."""
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(aa.shape[:-1] + (3, 3))
    cols = rotate_aa(aa[..., None, :], eye)  # rotates each basis vector
    return cols.transpose(-1, -2)


def matrix_to_aa(R):
    """Rotation matrix (..., 3, 3) → angle-axis (..., 3), through the
    quaternion (robust near π)."""
    return quat_to_aa(matrix_to_quat(R))


def aa_to_quat(aa):
    """Angle-axis (..., 3) → unit quaternion (..., 4)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small, theta = _safe_theta(theta2)
    half = 0.5 * theta
    # sin(t/2)/t, Taylor: 1/2 − t²/48
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, aa * sinc_half], dim=-1)


def quat_to_aa(q):
    """Unit quaternion (..., 4) → angle-axis (..., 3); w < 0 is flipped by
    the invariance q ≡ −q, then θ = 2·atan2(|v|, w)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., :1]
    v = q[..., 1:]
    sin_half2 = torch.sum(v * v, dim=-1, keepdim=True)
    small, sin_half = _safe_theta(sin_half2)
    theta = 2.0 * torch.atan2(sin_half, w)
    # θ / sin(θ/2), Taylor: 2 + θ²/12 ≈ 2 + sin²(θ/2)/3
    scale = torch.where(small, 2.0 + sin_half2 / 3.0, theta / sin_half)
    return v * scale


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4): Shepperd's
    method, its four cases selected by ``torch.where``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(t):
        return 2.0 * torch.sqrt(torch.clamp(t, min=1e-30))

    sw = s_of(1.0 + tr)
    qw = torch.stack([sw / 4.0, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = s_of(1.0 + m00 - m11 - m22)
    qx = torch.stack([(m21 - m12) / sx, sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = s_of(1.0 - m00 + m11 - m22)
    qy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy], dim=-1)
    sz = s_of(1.0 - m00 - m11 + m22)
    qz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0], dim=-1)

    use_w = (tr > 0.0)[..., None]
    use_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    use_y = (m11 >= m22)[..., None]
    q = torch.where(use_w, qw, torch.where(use_x, qx, torch.where(use_y, qy, qz)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_mul(q1, q2):
    """Hamilton product of quaternions."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def skew(v):
    """(..., 3) → skew-symmetric matrix [v]× (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        torch.stack([zeros, -vz, vy], dim=-1),
        torch.stack([vz, zeros, -vx], dim=-1),
        torch.stack([-vy, vx, zeros], dim=-1),
    ], dim=-2)
