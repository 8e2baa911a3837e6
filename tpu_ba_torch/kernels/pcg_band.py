"""K4: the whole banded-Schur PCG solve in one kernel.

Replaces the Pallas kernel ``tpu_ba/kernels/pcg_band.py:pcg_banded`` in its
fold-damp, block-Jacobi form: the kernel receives the undamped lane-major
camera blocks ``U_t`` and λ, damps them and inverts the block diagonal of
S = U_λ − T in its prologue, and runs the preconditioned CG loop (early stop,
breakdown freeze) to its end on the device. The CUDA kernel
(``tpu_ba_torch/csrc/pcg_band.cu``) is one cooperative launch with
device-wide barriers between the phases of an iteration. It is correct at
any band size: a working set inside the card's 50 MB L2 (``band_l2_bytes``)
is re-read from there every iteration, a larger one streams from device
memory. The reference's VMEM admission has no counterpart here.
The variants with a precomputed Ul/M⁻¹ or the block-tridiagonal
preconditioner are not ported (ROADMAP queue 2, K8).

Semantics are those of ``tpu_ba_torch/solver/pcg.py``, step for step.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.solver.pcg import pcg

MAX_BAND_OFFSETS = 64          # kMaxOffsets in csrc/pcg_band.cu
_WORK_ROWS = 2 * 81 + 5 * 9    # Ul, M⁻¹ and five vectors, c_pad floats a row
_CAMS_PER_GROUP = 16           # kCams in csrc/pcg_band.cu


def band_l2_bytes(pairs, dc: int = 9) -> int:
    """Bytes the kernel keeps live across CG iterations: the band blocks,
    Ul, M⁻¹ and the vectors."""
    return 4 * (pairs.k_band * dc * dc + (2 * dc * dc + 5 * dc) * pairs.c_pad)


def gauss_jordan_inverse(A):
    """Batched inverse (N, n, n) by Gauss–Jordan without pivoting, in the
    kernel's order of operations (sound for the SPD damped diag S)."""
    n = A.shape[-1]
    A = A.clone()
    inv = torch.eye(n, dtype=A.dtype, device=A.device).expand_as(A).clone()
    for k in range(n):
        piv = 1.0 / A[:, k, k]
        A[:, k, :] = A[:, k, :] * piv[:, None]
        inv[:, k, :] = inv[:, k, :] * piv[:, None]
        f = A[:, :, k].clone()
        f[:, k] = 0.0
        A = A - f[:, :, None] * A[:, k, None, :]
        inv = inv - f[:, :, None] * inv[:, k, None, :]
    return inv


def fold_damp_prologue(blk, U_t, lam, n_cameras: int, dc: int, diag_floor: float,
                       diag_ceil: float):
    """(Ul, M⁻¹), both (C, dc, dc): the damped camera blocks and the inverse
    of the block diagonal of S = Ul − T, from the undamped lane-major U_t
    (dc², c_pad) and the band's offset-0 blocks ``blk[:, :C]``."""
    C = n_cameras
    U = U_t[:, :C].reshape(dc, dc, C).permute(2, 0, 1)
    dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), diag_floor, diag_ceil)
    Ul = U + lam * dU[..., None] * torch.eye(dc, dtype=U.dtype, device=U.device)
    diag_S = Ul - blk[:, :C].reshape(dc, dc, C).permute(2, 0, 1)
    return Ul, gauss_jordan_inverse(diag_S)


def _check_variant(Ul, Minv, U_t, lam):
    if Ul is not None or Minv is not None or U_t is None or lam is None:
        raise NotImplementedError(
            "pcg_banded: only the fold-damp block-Jacobi form (Ul=None, Minv=None, U_t and lam "
            "given) is ported; precomputed Ul/M⁻¹ and the tridiagonal preconditioner are "
            "ROADMAP queue 2, K8")


def pcg_banded_plain(blk, Ul, Minv, b, pairs, *, max_iters: int, tol, x0=None, U_t=None,
                     lam=None, diag_floor: float = 1e-6, diag_ceil: float = 1e32):
    """Plain PyTorch version of K4: the prologue in PyTorch, the banded
    matvec of ``solver/pairs.py`` and the host loop of ``solver/pcg.py``.
    Returns (x (C, dc), iterations: int, ok: 0-dim bool tensor)."""
    from tpu_ba_torch.solver.pairs import make_banded_matvec

    _check_variant(Ul, Minv, U_t, lam)
    C, dc = b.shape
    Ul, Minv = fold_damp_prologue(blk, U_t, lam, C, dc, diag_floor, diag_ceil)
    matvec = make_banded_matvec(blk, Ul, pairs, dc)

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    return pcg(matvec, b, precond, max_iters=max_iters, tol=tol, x0=x0)


def pcg_banded(blk, Ul, Minv, b, pairs, *, max_iters: int, tol, x0=None, U_t=None, lam=None,
               diag_floor: float = 1e-6, diag_ceil: float = 1e32):
    """Block-Jacobi PCG on the fully banded reduced camera system.

    ``blk`` (81, k_pad) compact band blocks, ``b`` (C, 9), ``U_t`` (81, c_pad)
    undamped lane-major camera blocks, ``lam`` and ``tol`` 0-dim tensors (a
    float ``tol`` is placed on the device). Returns (x (C, 9), iterations,
    ok), the contract of ``solver/pcg.py:pcg``. A CPU tensor takes the plain
    version, whose ``iterations`` is an int; a CUDA tensor launches K4, whose
    ``iterations`` (int32) and ``ok`` (bool) are 0-dim device tensors and
    which synchronises nothing."""
    _check_variant(Ul, Minv, U_t, lam)
    if blk.device.type == "cpu":
        return pcg_banded_plain(blk, None, None, b, pairs, max_iters=max_iters, tol=tol, x0=x0,
                                U_t=U_t, lam=lam, diag_floor=diag_floor, diag_ceil=diag_ceil)
    dev = blk.device
    C, c_pad, n_off = pairs.n_cameras, pairs.c_pad, len(pairs.band_offsets)
    if not (pairs.banded and pairs.n_segments <= pairs.k_band and pairs.n_heavy_pts == 0):
        raise ValueError("pcg_banded: the kernel takes a fully banded plan without heavy points")
    if n_off > MAX_BAND_OFFSETS:
        raise ValueError(f"pcg_banded: {n_off} band offsets, the kernel takes {MAX_BAND_OFFSETS}")
    if not isinstance(tol, torch.Tensor):
        tol = torch.full((), float(tol), dtype=torch.float32, device=dev)
    _lib.check_tensor("blk", blk, torch.float32, (81, pairs.k_pad), dev)
    _lib.check_tensor("U_t", U_t, torch.float32, (81, c_pad), dev)
    _lib.check_tensor("b", b, torch.float32, (C, 9), dev)
    if x0 is not None:
        _lib.check_tensor("x0", x0, torch.float32, (C, 9), dev)
    _lib.check_tensor("band_offsets", pairs.band_offsets_t, torch.int32, (n_off,), dev)
    _lib.check_tensor("lam", lam, torch.float32, (), dev)
    _lib.check_tensor("tol", tol, torch.float32, (), dev)
    lib = _lib.load_library()
    n_groups = -(-C // _CAMS_PER_GROUP)
    work = torch.empty((_WORK_ROWS, c_pad), dtype=torch.float32, device=dev)
    partial = torch.empty((6, n_groups), dtype=torch.float32, device=dev)
    x = torch.empty((C, 9), dtype=torch.float32, device=dev)
    info = torch.empty((2,), dtype=torch.int32, device=dev)
    status = lib.tba_pcg_banded(
        blk.data_ptr(), pairs.k_pad, U_t.data_ptr(), b.data_ptr(),
        None if x0 is None else x0.data_ptr(), pairs.band_offsets_t.data_ptr(), n_off, C, c_pad,
        lam.data_ptr(), tol.data_ptr(), int(max_iters), float(diag_floor), float(diag_ceil),
        work.data_ptr(), partial.data_ptr(), x.data_ptr(), info[0:].data_ptr(),
        info[1:].data_ptr(), _lib.stream_ptr(blk))
    _lib.launches["pcg_band"] += 1
    _lib.check_status("pcg_band", status)
    return x, info[0], info[1] != 0
