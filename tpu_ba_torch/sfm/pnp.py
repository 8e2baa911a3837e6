"""Perspective-n-Point camera registration with batched RANSAC.

Counterpart of ``tpu_ba/sfm/pnp.py``: DLT minimal solves for a batch of
hypotheses at once, then a fixed 8-iteration damped Gauss-Newton refinement
of the pose on the inlier set, with no host read. Sampling is split from
scoring as in ``twoview.py`` (``twoview.sample_index_sets``).

Normalized camera coordinates (K⁻¹ applied), +z convention; the pose maps
world to camera: x ≃ R X + t.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from tpu_ba_torch.geometry.rotations import aa_to_matrix, matrix_to_aa, rotate_aa
from tpu_ba_torch.sfm import twoview


def _dlt_pnp(X, x):
    """DLT pose from ≥6 2D–3D correspondences. X: (..., N, 3), x: (..., N, 2)
    → (R (..., 3, 3), t (..., 3)). Linear, up to scale; orthonormalized by
    SVD (the null vector's sign cancels)."""
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., 0:1])], dim=-1)          # (..., N, 4)
    r1 = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)            # (..., N, 12)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                    # (..., 2N, 12)
    vt = torch.linalg.svd(A, full_matrices=False).Vh
    P = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
    U, s, Vt = torch.linalg.svd(P[..., 0:3])
    d = torch.sign(torch.linalg.det(U @ Vt))[..., None]
    R = (U * d[..., None]) @ Vt
    scale = d * 3.0 / torch.clamp(torch.sum(s, dim=-1, keepdim=True), min=1e-12)
    return R, P[..., 3] * scale


def _reproj_errors(R, t, X, x):
    """Squared reprojection errors (..., K) of X (K, 3) against x (K, 2)."""
    P = X @ R.transpose(-1, -2) + t[..., None, :]
    z = P[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.sum((P[..., 0:2] / z - x) ** 2, dim=-1)


def _gn_refine(aa, t, X, x, w, iters: int = 8):
    """Fixed-iteration damped Gauss-Newton on the 6-dof pose."""

    def residual(params):
        P = rotate_aa(params[None, 0:3], X) + params[3:6]
        z = P[:, 2:3]
        z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        return ((P[:, 0:2] / z - x) * w[:, None]).reshape(-1)

    params = torch.cat([aa, t])
    eye = 1e-6 * torch.eye(6, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        r = residual(params)
        J = jacfwd(residual)(params)                                   # (2N, 6)
        step = torch.linalg.solve(J.T @ J + eye, -(J.T @ r))
        new = params + step
        params = torch.where(torch.sum(residual(new) ** 2) < torch.sum(r ** 2), new, params)
    return params[0:3], params[3:6]


def pnp_from_samples(idx, X, x, valid, *, inlier_thresh: float = 1e-3):
    """Score the DLT hypotheses of the index sets ``idx`` (H, n), take the
    first with the most inliers, refine it by Gauss-Newton on its inliers.

    Returns (aa (3,), t (3,), inliers (K,), n_inliers)."""
    R, t = _dlt_pnp(X[idx], x[idx])                                    # (H, 3, 3), (H, 3)
    e = _reproj_errors(R, t, X, x)                                     # (H, K)
    front = (X @ R[:, 2, :].T).T + t[:, 2:3] > 0
    counts = torch.sum((e < inlier_thresh) & valid & front, dim=-1)
    best = torch.argmax(counts)
    aa, t = matrix_to_aa(R[best]), t[best]

    inl = (_reproj_errors(aa_to_matrix(aa), t, X, x) < inlier_thresh) & valid
    aa, t = _gn_refine(aa, t, X, x, inl.to(X.dtype))
    inl = (_reproj_errors(aa_to_matrix(aa), t, X, x) < inlier_thresh) & valid
    return aa, t, inl, torch.sum(inl)


def pnp_ransac(generator, X, x, valid, *, n_hypotheses: int = 256,
               sample_size: int = 6, inlier_thresh: float = 1e-3):
    """RANSAC PnP. generator: a CPU ``torch.Generator``; X: (K, 3) world
    points, x: (K, 2) normalized obs, valid: (K,) mask.
    Returns (aa (3,), t (3,), inliers (K,), n_inliers)."""
    idx = twoview.sample_index_sets(generator, valid, n_hypotheses, sample_size)
    return pnp_from_samples(idx, X, x, valid, inlier_thresh=inlier_thresh)
