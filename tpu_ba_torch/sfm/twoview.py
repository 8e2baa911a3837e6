"""Two-view geometry: essential-matrix RANSAC and decomposition.

Counterpart of ``tpu_ba/sfm/twoview.py``: RANSAC as one batch of hypotheses
scored at once (batched 8-point solves, one (H, K) Sampson-distance matrix),
then a fixed number of local-optimization refits.

The sampling is split from the scoring: ``sample_index_sets`` draws the
(H, n) index sets from a ``torch.Generator``, and ``essential_from_samples``
scores them and refits. The generator lives on the CPU, so a seed gives the
same draws on any device; the draws are uniform over the valid entries,
without replacement (the distribution of the reference's
``jax.random.choice(..., replace=False, p=valid/Σvalid)``; its bits cannot be
reproduced from a torch generator). The null vector of each SVD has an
arbitrary sign: Sampson distances, inliers and the decomposition do not
depend on it, so E agrees with the reference's up to sign.

All functions work in normalized camera coordinates (K⁻¹ applied), +z.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.sfm.triangulate import triangulate_points

# the LO-RANSAC annealing ladder: refit on inliers at mult × the threshold
LO_MULTS = (16.0, 8.0, 4.0, 2.0, 1.0, 1.0)


def sample_index_sets(generator, valid, n_hypotheses: int, sample_size: int):
    """(n_hypotheses, sample_size) int64 index sets on ``valid``'s device,
    each drawn without replacement, uniformly over the True entries of
    ``valid`` (K,). Gumbel top-k over CPU uniforms from ``generator``; where
    fewer entries are valid than ``sample_size``, the rest are invalid ones
    in index order."""
    K = valid.shape[0]
    u = torch.rand((n_hypotheses, K), generator=generator, dtype=torch.float64)
    u = u.to(valid.device).clamp_(min=1e-300)
    keys = torch.where(valid[None, :], -torch.log(-torch.log(u)),
                       torch.tensor(-torch.inf, dtype=torch.float64, device=valid.device))
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :sample_size]


def _design(x1, x2):
    """Rows kron(x2, x1) of the epipolar constraint x2ᵀ E x1 = 0: (..., 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _project_essential(E):
    """Singular values of E (..., 3, 3) projected to (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s) @ Vt


def _eight_point(x1, x2):
    """Essential matrix from 8+ normalized correspondences (..., N, 2) each.
    Returns E (..., 3, 3) with singular values projected to (1, 1, 0)."""
    A = _design(x1, x2)
    vt = torch.linalg.svd(A, full_matrices=True).Vh
    return _project_essential(vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3)))


def sampson_distance(E, x1, x2):
    """Squared Sampson distance of correspondences (K, 2) to the epipolar
    model E (..., 3, 3) → (..., K)."""
    ones = torch.ones(x1.shape[:-1] + (1,), dtype=x1.dtype, device=x1.device)
    p1 = torch.cat([x1, ones], dim=-1)  # (K, 3)
    p2 = torch.cat([x2, ones], dim=-1)
    Ex1 = p1 @ E.transpose(-1, -2)      # (..., K, 3)
    Etx2 = p2 @ E
    num = torch.sum(p2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def essential_from_samples(idx, x1, x2, valid, *, inlier_thresh: float = 1e-3):
    """Score the hypotheses of the index sets ``idx`` (H, 8), pick the best
    (the first of the largest inlier counts), then refit it on its inliers
    along ``LO_MULTS``, keeping the best model seen.

    Returns (E (3,3), inliers (K,) bool, n_inliers)."""
    Es = _eight_point(x1[idx], x2[idx])                            # (H, 3, 3)
    counts = torch.sum((sampson_distance(Es, x1, x2) < inlier_thresh) & valid, dim=-1)
    E_cur = Es[torch.argmax(counts)]

    # local optimization: refit on the inliers at a wider threshold, score at
    # the target threshold
    A_full = _design(x1, x2)
    full = A_full.shape[0] < 9          # Vt's last row is the null vector once K ≥ 9
    inl_cur = (sampson_distance(E_cur, x1, x2) < inlier_thresh) & valid
    n_cur = torch.sum(inl_cur)
    for mult in LO_MULTS:
        fit_set = (sampson_distance(E_cur, x1, x2) < inlier_thresh * mult) & valid
        vt = torch.linalg.svd(A_full * fit_set.to(x1.dtype)[:, None], full_matrices=full).Vh
        E_new = _project_essential(vt[-1].reshape(3, 3))
        inl_new = (sampson_distance(E_new, x1, x2) < inlier_thresh) & valid
        n_new = torch.sum(inl_new)
        better = n_new >= n_cur
        E_cur = torch.where(better, E_new, E_cur)
        inl_cur = torch.where(better, inl_new, inl_cur)
        n_cur = torch.maximum(n_new, n_cur)
    return E_cur, inl_cur, n_cur


def estimate_essential_ransac(generator, x1, x2, valid, *, n_hypotheses: int = 512,
                              inlier_thresh: float = 1e-3):
    """Batched-RANSAC essential matrix.

    generator: a CPU ``torch.Generator``; x1, x2: (K, 2) normalized
    correspondences; valid: (K,) mask.
    Returns (E (3,3), inliers (K,) bool, n_inliers).
    """
    idx = sample_index_sets(generator, valid, n_hypotheses, 8)
    return essential_from_samples(idx, x1, x2, valid, inlier_thresh=inlier_thresh)


def decompose_essential(E, x1, x2, inliers):
    """E → (R, t) with cheirality disambiguation (most points in front of
    both cameras). Returns (R (3,3), t (3,) unit-norm, n_good)."""
    U, _, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[:, 2]
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device)

    def score(R, tt):
        X = triangulate_points(eye34, torch.cat([R, tt[:, None]], dim=1), x1, x2)
        z2 = X @ R[2] + tt[2]
        return torch.sum((X[:, 2] > 0) & (z2 > 0) & inliers)

    cands = [(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)]
    scores = torch.stack([score(R, tt) for R, tt in cands])
    best = torch.argmax(scores)
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return Rs[best], ts[best], scores[best]
