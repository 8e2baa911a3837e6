"""Descriptor matching: mutual nearest neighbors + Lowe ratio test.

Counterpart of ``tpu_ba/sfm/matching.py``: one K1×K2 similarity product,
elementwise tests, and a fixed-size output (K1 matches with a validity mask).
The two best per row come in the reference's order among equal values
(``top_k_stable``).
"""

from __future__ import annotations

import torch

from tpu_ba_torch.sfm.features import top_k_stable


def match_descriptors(desc1, desc2, score1=None, score2=None,
                      ratio: float = 0.8, min_sim: float = 0.5):
    """Match normalized descriptors (K1, D) × (K2, D).

    Returns (idx2 (K1,) int32 — best match in image 2 for each keypoint of
    image 1, valid (K1,) bool). Valid requires: mutual nearest neighbor,
    Lowe ratio (on 1−sim distances), similarity floor, and both keypoints
    real (score > 0 when scores given).
    """
    sim = desc1 @ desc2.T  # (K1, K2) cosine similarity
    neg_inf = torch.tensor(-torch.inf, dtype=sim.dtype, device=sim.device)
    if score1 is not None:
        sim = torch.where(score1[:, None] > 0, sim, neg_inf)
    if score2 is not None:
        sim = torch.where(score2[None, :] > 0, sim, neg_inf)

    best2, idx2 = top_k_stable(sim, 2)             # per row: two best in img2
    best1 = torch.max(sim, dim=0).values           # per col: best in img1
    mutual = best1[idx2[:, 0]] <= best2[:, 0] + 1e-12
    d1 = 1.0 - best2[:, 0]
    d2 = 1.0 - best2[:, 1]
    ratio_ok = d1 <= ratio * d2
    valid = mutual & ratio_ok & (best2[:, 0] > min_sim) & torch.isfinite(best2[:, 0])
    return idx2[:, 0].to(torch.int32), valid
