"""Block-tridiagonal PCG preconditioner via parallel cyclic reduction (PCR).

Counterpart of ``tpu_ba/solver/tridiag.py``. Block-Jacobi ignores the
dominant off-diagonal structure of the reduced camera system S: on
trajectory-style problems the offset-1 band blocks (consecutive cameras)
carry most of the off-diagonal mass. This module preconditions with the exact
inverse of the block-tridiagonal part

    M = tridiag(A_c, D_c, B_c),   D_c = damped diag(S),  B_c = S_{c,c+1},
    A_c = B_{c-1}ᵀ

by parallel cyclic reduction: at level k (stride s = 2ᵏ) every camera
eliminates its ±s neighbours at once,

    P_c = A_c (D_{c-s})⁻¹          Q_c = B_c (D_{c+s})⁻¹
    D_c ← D_c − P_c B_{c-s} − Q_c A_{c+s}
    A_c ← −P_c A_{c-s}             B_c ← −Q_c B_{c+s}
    r_c ← r_c − P_c r_{c-s} − Q_c r_{c+s}

After ⌈log₂ C⌉ levels the system is block diagonal: z = D⁻¹ r. The factors
(Pᵏ, Qᵏ, final D⁻¹) depend only on (S, λ) and are computed once per λ-retry
in plain PyTorch (batched 9×9 Gauss–Jordan and products); each application is
two batched block·vector products and two shifts per level, inside the PCG
kernel (``tpu_ba_torch/kernels/pcg_band.py``) or through ``pcr_apply``.

Full-depth PCR is algebraically M⁻¹. M is positive definite where the damping
is strong enough; at weak damping it can be indefinite, which PCG reports as
a breakdown (rᵀz ≤ 0) so that LM raises λ.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ba_torch.core import resolve_device
from tpu_ba_torch.solver.batched_linalg import inv_spd_small


def _shift_dn(X, s: int):
    """Batch-axis shift: out[c] = X[c−s] (zeros for c < s)."""
    out = torch.zeros_like(X)
    if s < X.shape[0]:
        out[s:] = X[:X.shape[0] - s]
    return out


def _shift_up(X, s: int):
    """Batch-axis shift: out[c] = X[c+s] (zeros for c ≥ C−s)."""
    out = torch.zeros_like(X)
    if s < X.shape[0]:
        out[:X.shape[0] - s] = X[s:]
    return out


def n_pcr_levels(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def pcr_factor(D, B_up):
    """Factor the block-tridiagonal M once (per λ-retry).

    D (C, dc, dc): diagonal blocks (damped); B_up (C, dc, dc): upper
    couplings B_c = M_{c,c+1} (row C−1 must be zero).
    Returns (P (K, C, dc, dc), Q (K, C, dc, dc), Dinv_fin (C, dc, dc))."""
    K = n_pcr_levels(D.shape[0])
    A = _shift_dn(B_up, 1).transpose(-1, -2)     # A_c = B_{c-1}ᵀ
    B = B_up
    Ps, Qs = [], []
    for k in range(K):
        s = 1 << k
        Dinv = inv_spd_small(D)
        P = A @ _shift_dn(Dinv, s)
        Q = B @ _shift_up(Dinv, s)
        D = D - P @ _shift_dn(B, s) - Q @ _shift_up(A, s)
        A, B = -(P @ _shift_dn(A, s)), -(Q @ _shift_up(B, s))
        Ps.append(P)
        Qs.append(Q)
    empty = D.new_zeros((0,) + tuple(D.shape))
    return (torch.stack(Ps) if Ps else empty, torch.stack(Qs) if Qs else empty,
            inv_spd_small(D))


def pcr_apply(P, Q, Dinv_fin, r):
    """Apply the PCR-factored M⁻¹ to r (C, dc): the plain version of the
    kernel's preconditioner step."""
    for k in range(P.shape[0]):
        s = 1 << k
        r = (r - torch.einsum("cij,cj->ci", P[k], _shift_dn(r, s))
             - torch.einsum("cij,cj->ci", Q[k], _shift_up(r, s)))
    return torch.einsum("cij,cj->ci", Dinv_fin, r)


def tridiag_from_band(blk, diag_S, pairs, dc: int):
    """The block-tridiagonal part of S from the banded compact storage.
    ``diag_S`` (C, dc, dc) is the damped diagonal that ``solve_schur_sparse``
    has formed; the offset-1 band slot holds T_{c,c+1} and S = Ul − T, so
    B_c = −T1[c]. Needs ``band_offsets[1] == 1``. Row C−1 couples to nothing:
    a pair with offset 1 has cj = ci + 1 < C, so its band cell is zero."""
    C, c_pad = pairs.n_cameras, pairs.c_pad
    t1 = blk[:, c_pad:2 * c_pad]                       # (dc², c_pad)
    B_up = -t1.reshape(dc, dc, c_pad)[:, :, :C].permute(2, 0, 1)
    return diag_S, B_up


def factor_t(P, Q, Dinv_fin, c_pad: int):
    """The factors in the layout the PCG kernel reads: lane-major f32, one
    row per (level, block entry) and one column per camera, padded to
    ``c_pad`` columns — P, Q (K, C, dc, dc) → (K·dc², c_pad), Dinv_fin
    (C, dc, dc) → (dc², c_pad). Thread (camera, row) of the kernel then reads
    its block row with neighbouring cameras on neighbouring addresses, as it
    reads the band. Same layout as the reference's ``factor_t``."""
    K, C, dc, _ = P.shape

    def lanes(X, rows):                                # (..., C, dc, dc) → (rows, c_pad)
        out = torch.zeros((rows, c_pad), dtype=torch.float32, device=X.device)
        out[:, :C] = X.movedim(-3, -1).reshape(rows, C)
        return out

    return lanes(P, K * dc * dc), lanes(Q, K * dc * dc), lanes(Dinv_fin, dc * dc)


def tridiag_from_numpy(P, Q, Dinv_fin, *, dtype=torch.float64, device=None):
    """(P, Q, Dinv_fin) given as numpy arrays (e.g. the reference's
    ``pcr_factor`` output) as the tensors ``pcr_apply`` and ``pcg_banded``
    take, on ``device`` (default: the CUDA card, see ``resolve_device``)."""
    device = resolve_device(device)
    return tuple(torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
                 for a in (P, Q, Dinv_fin))
