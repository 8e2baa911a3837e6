"""Block-sparse Gauss-Newton system assembly.

Counterpart of ``tpu_ba/solver/normal.py``. The system stays in block form,
with the reference's lane-major layouts (batch axis last)::

    H = [ U   W ]     U: (C, dc, dc) camera diagonal blocks
        [ Wᵀ  V ]     V: (9, P)  point diagonal blocks, row 3a+b = V[a,b]
                      W: (3·dc, O) one coupling block per observation, row 3m+n

Robust IRLS weighting (√ρ′ scaling of r and J) happens once per
linearization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_ba_torch.residuals.robust import robust_rho, robust_weight
from tpu_ba_torch.solver.plans import cam_segsum_t, pt_segsum_t


class BlockSystem(NamedTuple):
    """The assembled (robust-weighted) Gauss-Newton system in block form."""

    U: torch.Tensor        # (C, dc, dc) camera diagonal blocks of JᵀJ
    V: torch.Tensor        # (9, P)      point diagonal blocks, row 3a+b = V[a,b]
    W: torch.Tensor        # (3·dc, O)   coupling blocks, row 3m+n = W[m,n]
    gc: torch.Tensor       # (C, dc)     camera gradient Jᵀr
    gp: torch.Tensor       # (3, P)      point gradient Jᵀr
    cost: torch.Tensor     # scalar, ½ Σ ρ(|r|²)
    cam_idx: torch.Tensor  # (O,)
    pt_idx: torch.Tensor   # (O,)


def apply_irls_weights(r, Jc, Jp, robust_kind: int, robust_scale: float, mask=None):
    """Scale residuals and Jacobian blocks by √ρ′(|r|²). Lane-major inputs:
    r (2,O), Jc (2,dc,O), Jp (2,3,O). Returns (r_w, Jc_w, Jp_w, cost), cost
    being the robust cost of the unweighted residuals."""
    s = torch.sum(r * r, dim=0)
    rho = robust_rho(robust_kind, s, robust_scale)
    w = robust_weight(robust_kind, s, robust_scale)
    if mask is not None:
        rho = torch.where(mask, rho, torch.zeros_like(rho))
        w = torch.where(mask, w, torch.zeros_like(w))
    cost = 0.5 * torch.sum(rho)
    sw = torch.sqrt(w)
    return r * sw[None, :], Jc * sw[None, None, :], Jp * sw[None, None, :], cost


def assemble(r, Jc, Jp, cam_idx, pt_idx, n_cameras: int, n_points: int,
             robust_kind: int = 0, robust_scale: float = 1.0, mask=None,
             plans=None) -> BlockSystem:
    """Assemble the block system from per-observation residuals/Jacobians
    (masked rows already zeroed; the IRLS weighting re-applies the mask)."""
    r, Jc, Jp, cost = apply_irls_weights(r, Jc, Jp, robust_kind, robust_scale, mask)
    O = r.shape[-1]
    dc = Jc.shape[1]
    UtU = torch.einsum("smo,sno->mno", Jc, Jc).reshape(dc * dc, O)
    VtV = torch.einsum("smo,sno->mno", Jp, Jp).reshape(9, O)
    W = torch.einsum("smo,sno->mno", Jc, Jp).reshape(dc * 3, O)
    gco = torch.einsum("smo,so->mo", Jc, r)
    gpo = torch.einsum("smo,so->mo", Jp, r)

    cam_packed = cam_segsum_t(plans, torch.cat([UtU, gco], dim=0), cam_idx, n_cameras)
    U = cam_packed[:dc * dc].reshape(dc, dc, n_cameras).permute(2, 0, 1).contiguous()
    gc = cam_packed[dc * dc:].T.contiguous()
    pt_packed = pt_segsum_t(plans, torch.cat([VtV, gpo], dim=0), pt_idx, n_points)
    return BlockSystem(U=U, V=pt_packed[:9], W=W, gc=gc, gp=pt_packed[9:], cost=cost,
                       cam_idx=cam_idx, pt_idx=pt_idx)


def damp_blocks(B: BlockSystem, lam, diag_floor: float, diag_ceil: float):
    """Marquardt damping: add λ·clamp(diag) to the diagonal of each block.
    Returns (U_λ (C,dc,dc), V_λ (9,P) lane-major)."""
    dU = torch.clamp(torch.diagonal(B.U, dim1=-2, dim2=-1), diag_floor, diag_ceil)
    n = B.U.shape[-1]
    Ul = B.U + lam * dU[..., None] * torch.eye(n, dtype=B.U.dtype, device=B.U.device)
    Vl = B.V.clone()
    for a in range(3):
        Vl[4 * a] += lam * torch.clamp(B.V[4 * a], diag_floor, diag_ceil)
    return Ul, Vl
