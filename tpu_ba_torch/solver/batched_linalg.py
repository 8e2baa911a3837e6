"""Batched small-matrix inverse (counterpart of
``tpu_ba/solver/batched_linalg.py``).

BA only inverts damped SPD blocks (the 9×9 camera preconditioner blocks), so
an unrolled Gauss-Jordan without pivoting is exact enough; a floor guards
exact-zero pivots. ``torch.linalg.inv`` pivots, and its results differ from
the reference's on near-singular blocks, so it is not used here.
"""

from __future__ import annotations

import torch


def inv_spd_small(M, *, pivot_floor: float = 1e-30):
    """Batched inverse of small SPD matrices. M: (..., k, k), k small
    (unrolled k-step Gauss-Jordan, no pivoting)."""
    k = M.shape[-1]
    eye = torch.eye(k, dtype=M.dtype, device=M.device).expand(M.shape)
    A = torch.cat([M, eye], dim=-1)                     # (..., k, 2k)
    floor = torch.tensor(pivot_floor, dtype=M.dtype, device=M.device)
    for i in range(k):
        piv = A[..., i, i:i + 1]
        piv = torch.where(torch.abs(piv) < pivot_floor, floor, piv)
        row = A[..., i, :] / piv                        # (..., 2k)
        col = A[..., :, i]                              # (..., k)
        A = A - col[..., :, None] * row[..., None, :]   # a new tensor each step
        A[..., i, :] = row
    return A[..., k:].contiguous()
