"""Linear (DLT) triangulation, batched over correspondences.

Counterpart of ``tpu_ba/sfm/triangulate.py``: one batched 4×4 SVD, the null
vector its last right singular vector (its sign cancels in the division).
Normalized camera coordinates, +z convention.
"""

from __future__ import annotations

import torch


def _dlt(Pi, Pj, ui, uj):
    """Pi, Pj: (..., 3, 4); ui, uj: (..., 2) → X (..., 3)."""
    A = torch.stack([
        ui[..., 0:1] * Pi[..., 2, :] - Pi[..., 0, :],
        ui[..., 1:2] * Pi[..., 2, :] - Pi[..., 1, :],
        uj[..., 0:1] * Pj[..., 2, :] - Pj[..., 0, :],
        uj[..., 1:2] * Pj[..., 2, :] - Pj[..., 1, :],
    ], dim=-2)
    Xh = torch.linalg.svd(A).Vh[..., -1, :]
    w = Xh[..., 3:4]
    return Xh[..., 0:3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def triangulate_points(P1, P2, x1, x2):
    """DLT triangulation. P1, P2: (3, 4) projection matrices (normalized
    coords); x1, x2: (K, 2). Returns X (K, 3) world points."""
    return _dlt(P1, P2, x1, x2)


def triangulate_pairwise(poses_i, poses_j, x_i, x_j):
    """Triangulate K points, each from its own camera pair.

    poses_i/j: (K, 3, 4) per-point projection matrices; x_i/j: (K, 2).
    """
    return _dlt(poses_i, poses_j, x_i, x_j)
