"""Matrix-free Schur complement: eliminate points, solve cameras.

Counterpart of ``tpu_ba/solver/schur.py``. The reduced camera system

    S = U_λ − W V_λ⁻¹ Wᵀ,      b = −g_c + W V_λ⁻¹ g_p

is never formed: its matvec is a gather → per-observation product →
segment sum by point, then the same by camera. With plans the segment sums
go through the K1 wrapper, so on the card each CG iteration launches K1
twice. Per-observation and per-point data keep the lane-major layouts of
``tpu_ba_torch/solver/normal.py``.

Sharded (``group``, see ``solver/collective.py``): W and the index maps are
the rank's observation shard, everything else is replicated, and each
observation sum is the rank's partial followed by one all-reduce, so the
matrix-free CG all-reduces twice an iteration, as the reference's psums do.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.solver.batched_linalg import inv_spd_small
from tpu_ba_torch.solver.collective import all_reduce
from tpu_ba_torch.solver.normal import BlockSystem, damp_blocks
from tpu_ba_torch.solver.pcg import pcg
from tpu_ba_torch.solver.plans import cam_segsum_t, pt_segsum_t


def inv3x3_rows(v):
    """Batched 3×3 inverse on the flat lane-major layout: v (9, N) with
    v[3a+b] = M[a,b] per column → (9, N). Adjugate over the determinant,
    which is floored at 1e-30 in magnitude for padded or empty blocks."""
    a, b, c, d, e, f, g, h, i = (v[k] for k in range(9))
    A = e * i - f * h
    B = f * g - d * i
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    inv = torch.stack([
        A, c * h - b * i, b * f - c * e,
        B, a * i - c * g, c * d - a * f,
        Cc, b * g - a * h, a * e - b * d,
    ])
    return inv / det


def _matmul_rows_33(v, x):
    """Per-column 3×3 · 3-vector on lane-major rows: v (9,N), x (3,N) → (3,N)."""
    return (v.reshape(3, 3, -1) * x[None, :, :]).sum(dim=1)


def _w_dot(W, x, dc: int):
    """Per-observation W·u: W (3dc,O) rows 3m+n, u (3,O) → (dc,O)."""
    return (W.reshape(dc, 3, -1) * x[None, :, :]).sum(dim=1)


def _wt_dot(W, y, dc: int):
    """Per-observation Wᵀ·y: W (3dc,O), y (dc,O) → (3,O)."""
    return (W.reshape(dc, 3, -1) * y[:, None, :]).sum(dim=0)


def w_vinv_wt_diag(W, Vinv, cam_idx, pt_idx, n_cameras: int, plans=None, group=None):
    """Σ_obs W_o V⁻¹[pt_o] W_oᵀ per camera → (C, dc, dc): the second term of
    diag(S), for the block-Jacobi preconditioner. W (3dc,O), Vinv (9,P)."""
    dc = W.shape[0] // 3
    O = W.shape[1]
    Vg = Vinv[:, pt_idx].reshape(3, 3, O)                 # (a, b, O)
    Wr = W.reshape(dc, 3, O)                              # (m, a, O)
    WVi = torch.einsum("mao,abo->mbo", Wr, Vg)
    WViWt = torch.einsum("mbo,nbo->mno", WVi, Wr).reshape(dc * dc, O)
    out = all_reduce(cam_segsum_t(plans, WViWt.contiguous(), cam_idx, n_cameras), group)
    return out.reshape(dc, dc, n_cameras).permute(2, 0, 1)


def schur_rhs(B: BlockSystem, Vinv, plans=None, group=None):
    """b = −g_c + W V_λ⁻¹ g_p → (C, dc). Vinv (9,P) lane-major."""
    dc = B.W.shape[0] // 3
    t = _matmul_rows_33(Vinv, B.gp)                       # (3, P)
    Wt = _w_dot(B.W, t[:, B.pt_idx], dc)                  # (dc, O)
    n_cameras = B.U.shape[0]
    return -B.gc + all_reduce(cam_segsum_t(plans, Wt, B.cam_idx, n_cameras), group).T


def make_schur_matvec(Ul, W, Vinv, cam_idx, pt_idx, n_points: int, plans=None, group=None):
    """Returns x ↦ S·x for x of shape (C, dc), matrix-free."""
    n_cameras = Ul.shape[0]
    dc = W.shape[0] // 3

    def matvec(x):
        y = torch.einsum("cij,cj->ci", Ul, x)            # U_λ x
        wtx = _wt_dot(W, x.T[:, cam_idx], dc)            # (3, O)
        t = all_reduce(pt_segsum_t(plans, wtx, pt_idx, n_points), group)   # (3, P)
        u = _matmul_rows_33(Vinv, t)                     # (3, P)
        z = _w_dot(W, u[:, pt_idx], dc)                  # (dc, O)
        z = all_reduce(cam_segsum_t(plans, z, cam_idx, n_cameras), group)  # (dc, C)
        return y - z.T

    return matvec


def back_substitute(B: BlockSystem, Vinv, dx_cam, plans=None, group=None):
    """δ_p = V_λ⁻¹ (−g_p − Wᵀ δ_c) → (P, 3)."""
    dc = B.W.shape[0] // 3
    wtd = _wt_dot(B.W, dx_cam.T[:, B.cam_idx], dc)      # (3, O)
    n_points = B.V.shape[-1]
    s = all_reduce(pt_segsum_t(plans, wtd, B.pt_idx, n_points), group)   # (3, P)
    return _matmul_rows_33(Vinv, -B.gp - s).T


def solve_schur_pcg(B: BlockSystem, lam, *, cg_max_iters: int, cg_tol,
                    cg_x0=None, diag_floor: float, diag_ceil: float, plans=None, group=None):
    """Full Schur + block-Jacobi PCG linear solve (sharded under ``group``).

    Returns (δ_cameras, δ_points, cg_iters: int, ok: 0-dim bool tensor);
    ``ok`` False ⇒ the LM loop must reject the step and raise λ."""
    Ul, Vl = damp_blocks(B, lam, diag_floor, diag_ceil)
    Vinv = inv3x3_rows(Vl)                               # (9, P)
    n_cameras = Ul.shape[0]
    n_points = Vl.shape[-1]

    b = schur_rhs(B, Vinv, plans, group)
    matvec = make_schur_matvec(Ul, B.W, Vinv, B.cam_idx, B.pt_idx, n_points, plans, group)
    # exact block-Jacobi preconditioner: inverse of diag(S)
    diag_S = Ul - w_vinv_wt_diag(B.W, Vinv, B.cam_idx, B.pt_idx, n_cameras, plans, group)
    Minv = inv_spd_small(diag_S)

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    dx_cam, cg_iters, ok = pcg(matvec, b, precond, max_iters=cg_max_iters,
                               tol=cg_tol, x0=cg_x0, group=group)
    dx_pt = back_substitute(B, Vinv, dx_cam, plans, group)
    return dx_cam, dx_pt, cg_iters, ok
