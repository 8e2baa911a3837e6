"""K4 and K8: the whole banded-Schur PCG solve in one kernel.

Replaces the Pallas kernel ``tpu_ba/kernels/pcg_band.py:pcg_banded`` in all
its forms:

  * fold-damp (K4): the kernel receives the undamped lane-major camera blocks
    ``U_t`` and λ, damps them and inverts the block diagonal of S = U_λ − T in
    its prologue (block-Jacobi);
  * given (K8): the damped ``Ul`` and the block-Jacobi ``Minv`` arrive as
    (C, 9, 9) and the prologue copies them;
  * tridiagonal (K8): ``Ul`` arrives and the preconditioner is the
    PCR-factored inverse of the block-tridiagonal part of S
    (``tpu_ba_torch/solver/tridiag.py``), ``tridiag=(P, Q, Dinv_fin)``.

Each runs the preconditioned CG loop (early stop, breakdown freeze) to its end
on the device, in one cooperative launch. The CUDA kernel
(``tpu_ba_torch/csrc/pcg_band.cu``) has two forms, chosen here from the
plan's shapes (``resident_cams``):

  * resident: every group of 16 or 8 cameras keeps its slice of the band
    in the shared memory of one block for the whole solve, and a CG iteration
    makes two device-wide exchanges. It needs every group on the card at
    once: ``n_groups`` ≤ the blocks co-resident at the slice's size (ladybug-
    1723, 17 offsets: 108 groups of 16 at 209 KB);
  * streaming: any band size. A working set inside the card's 50 MB L2
    (``band_l2_bytes``) is re-read from there every iteration, a larger one
    streams from device memory; three ``grid.sync()`` an iteration.

This is a size rule, not an admission rule: a band that does not fit the
resident form runs the streaming form of the same kernel (the reference's
VMEM admission has no counterpart here). Off-band leftover segments of a
capped band are part of the kernel's matvec in both forms: each camera walks
its own lists (``PairPlan.left``) in order.

Semantics are those of ``tpu_ba_torch/solver/pcg.py``, step for step.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.solver.pcg import pcg
from tpu_ba_torch.solver.tridiag import factor_t, pcr_apply

MAX_BAND_OFFSETS = 64          # kMaxOffsets in csrc/pcg_band.cu
_WORK_ROWS = 2 * 81 + 7 * 9    # Ul, M⁻¹, five vectors and the two PCR buffers, c_pad floats a row
_CAMS_PER_GROUP = 16           # kStreamCams in csrc/pcg_band.cu

# launches of the kernel by form since the last reset_form_launches()
form_launches = {"resident": 0, "streaming": 0}
_resident_cams: dict = {}


def reset_form_launches() -> None:
    for k in form_launches:
        form_launches[k] = 0


def resident_cams(form: int, band_offsets, n_cameras: int, device) -> int:
    """Cameras per group (16 or 8) at which the resident form of the
    kernel holds this band on ``device``, or 0 where it does not fit: the
    slice of a group (an item of 81 floats a camera for each offset and for
    each transposed pass, the staged vector, M⁻¹ and scratch) within the 227
    KB a block may have, and every group co-resident. The card is asked once
    per shape."""
    offs = tuple(int(o) for o in band_offsets)
    if not offs or offs[0] != 0 or any(o <= 0 for o in offs[1:]) or len(set(offs)) != len(offs):
        return 0
    key = (torch.device(device).index, form, len(offs), n_cameras)
    if key not in _resident_cams:
        with torch.cuda.device(device):
            cams = _lib.load_library().tba_pcg_resident_cams(form, len(offs), n_cameras)
        if cams < 0:
            raise RuntimeError(f"pcg_band: the occupancy query failed: cudaError {-cams}")
        _resident_cams[key] = cams
    return _resident_cams[key]


def exchange_floor(form: int, band_offsets, n_cameras: int, n: int, device):
    """Launch the measuring kernel of ``csrc/pcg_band.cu``: ``n`` device-wide
    exchanges of one partial sum and nothing else, on the grid and with the
    shared memory of the resident form for this band (which must fit), in the
    resident form's way (``grid.sync()`` and a re-summation of the partials
    from L2). Two exchanges are
    the least a CG iteration of the resident form can take. Returns the sum
    the kernel formed (``n`` × the grid's blocks where the exchanges are
    sound), a 0-dim tensor."""
    cams = resident_cams(form, band_offsets, n_cameras, device)
    if not cams:
        raise ValueError("exchange_floor: the band does not fit the resident form")
    lib = _lib.load_library()
    n_blocks = -(-n_cameras // cams)
    smem = lib.tba_pcg_resident_smem(form, len(band_offsets), cams)
    partial = torch.zeros((6, n_blocks), dtype=torch.float32, device=device)
    out = torch.zeros((), dtype=torch.float32, device=device)
    status = lib.tba_pcg_barrier_floor(n_blocks, smem, int(n), partial.data_ptr(),
                                       out.data_ptr(), _lib.stream_ptr(partial))
    _lib.check_status("pcg_band exchange floor", status)
    return out


def band_l2_bytes(pairs, dc: int = 9, pcr_levels: int = 0) -> int:
    """Bytes the kernel keeps live across CG iterations: the band blocks,
    Ul, M⁻¹ and the vectors; with the tridiagonal preconditioner also P, Q
    and the two buffers of a PCR level."""
    d2 = dc * dc
    pcr = (2 * pcr_levels * d2 + 2 * dc) * pairs.c_pad if pcr_levels else 0
    return 4 * (pairs.k_band * d2 + (2 * d2 + 5 * dc) * pairs.c_pad + pcr)


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


def _form(Ul, Minv, tridiag, U_t, lam) -> int:
    """0: fold-damp, 1: Ul and Minv given, 2: Ul and the PCR factors given
    (the ``form`` of ``tba_pcg_banded``)."""
    if U_t is not None:
        if tridiag is not None:
            raise ValueError("pcg_banded: the fold-damp form (U_t given) is block-Jacobi only")
        if lam is None:
            raise ValueError("pcg_banded: the fold-damp form needs lam")
        return 0
    if Ul is None:
        raise ValueError("pcg_banded: give U_t and lam (fold-damp) or Ul with Minv or tridiag")
    if tridiag is not None:
        return 2
    if Minv is None:
        raise ValueError("pcg_banded: Ul given without Minv or tridiag")
    return 1


def pcg_banded_plain(blk, Ul, Minv, b, pairs, *, max_iters: int, tol, x0=None, tridiag=None,
                     U_t=None, lam=None, diag_floor: float = 1e-6, diag_ceil: float = 1e32):
    """Plain PyTorch version of K4 and K8: the prologue in PyTorch, the banded
    matvec of ``solver/pairs.py``, ``pcr_apply`` or the product with M⁻¹, and
    the host loop of ``solver/pcg.py``. Returns (x (C, dc), iterations: int,
    ok: 0-dim bool tensor)."""
    from tpu_ba_torch.solver.pairs import make_banded_matvec

    form = _form(Ul, Minv, tridiag, U_t, lam)
    C, dc = b.shape
    if form == 0:
        Ul, Minv = fold_damp_prologue(blk, U_t, lam, C, dc, diag_floor, diag_ceil)
    matvec = make_banded_matvec(blk, Ul, pairs, dc)

    if form == 2:
        def precond(r):
            return pcr_apply(*tridiag, r)
    else:
        def precond(r):
            return torch.einsum("cij,cj->ci", Minv, r)

    return pcg(matvec, b, precond, max_iters=max_iters, tol=tol, x0=x0)


def pcg_banded(blk, Ul, Minv, b, pairs, *, max_iters: int, tol, x0=None, tridiag=None,
               U_t=None, lam=None, diag_floor: float = 1e-6, diag_ceil: float = 1e32,
               resident: bool | None = None):
    """PCG on the banded reduced camera system, the reference's signature.

    ``blk`` (81, k_pad) compact blocks, ``b`` (C, 9), ``tol`` a 0-dim tensor
    (a float is placed on the device). Fold-damp form: ``U_t`` (81, c_pad)
    undamped lane-major camera blocks and ``lam`` (0-dim), ``Ul``/``Minv``
    None. Otherwise ``Ul`` (C, 9, 9) with ``Minv`` (C, 9, 9), or with
    ``tridiag`` = (P (K, C, 9, 9), Q, Dinv_fin (C, 9, 9)), which switches the
    preconditioner to the PCR-factored block-tridiagonal inverse (``Minv`` is
    then ignored). Returns (x (C, 9), iterations, ok), the contract of
    ``solver/pcg.py:pcg``. A CPU tensor takes the plain version, whose
    ``iterations`` is an int; a CUDA tensor launches the kernel, whose
    ``iterations`` (int32) and ``ok`` (bool) are 0-dim device tensors and
    which synchronises nothing. ``resident`` picks the kernel's form (for
    tests and timing): None takes the resident form where the band fits it,
    True raises where it does not, False forces the streaming form; a CPU
    tensor ignores it."""
    form = _form(Ul, Minv, tridiag, U_t, lam)
    if blk.device.type == "cpu":
        return pcg_banded_plain(blk, Ul, Minv, b, pairs, max_iters=max_iters, tol=tol, x0=x0,
                                tridiag=tridiag, U_t=U_t, lam=lam, diag_floor=diag_floor,
                                diag_ceil=diag_ceil)
    dev = blk.device
    C, c_pad, n_off = pairs.n_cameras, pairs.c_pad, len(pairs.band_offsets)
    if not (pairs.banded and pairs.n_heavy_pts == 0):
        raise ValueError("pcg_banded: the kernel takes a banded plan without heavy points")
    n_left = max(pairs.n_segments - pairs.k_band, 0)
    if n_left and pairs.left is None:
        raise ValueError("pcg_banded: a band with off-band leftover segments needs their lists "
                         "(build_pair_plan(..., with_kernel_plans=True))")
    if n_off > MAX_BAND_OFFSETS:
        raise ValueError(f"pcg_banded: {n_off} band offsets, the kernel takes {MAX_BAND_OFFSETS}")
    if not isinstance(tol, torch.Tensor):
        tol = torch.full((), float(tol), dtype=torch.float32, device=dev)
    f32 = torch.float32
    _lib.check_tensor("blk", blk, f32, (81, pairs.k_pad), dev)
    _lib.check_tensor("b", b, f32, (C, 9), dev)
    if x0 is not None:
        _lib.check_tensor("x0", x0, f32, (C, 9), dev)
    _lib.check_tensor("band_offsets", pairs.band_offsets_t, torch.int32, (n_off,), dev)
    _lib.check_tensor("tol", tol, f32, (), dev)
    ptr = dict.fromkeys(("Minv", "P", "Q", "D", "lam"))     # null where the form has none
    levels = 0
    if form == 0:
        _lib.check_tensor("U_t", U_t, f32, (81, c_pad), dev)
        _lib.check_tensor("lam", lam, f32, (), dev)
        U, ptr["lam"] = U_t, lam.data_ptr()
    else:
        _lib.check_tensor("Ul", Ul, f32, (C, 9, 9), dev)
        U = Ul
    if form == 1:
        _lib.check_tensor("Minv", Minv, f32, (C, 9, 9), dev)
        ptr["Minv"] = Minv.data_ptr()
    if form == 2:
        P, Q, Dinv_fin = tridiag
        levels = int(P.shape[0])
        _lib.check_tensor("tridiag P", P, f32, (levels, C, 9, 9), dev)
        _lib.check_tensor("tridiag Q", Q, f32, (levels, C, 9, 9), dev)
        _lib.check_tensor("tridiag Dinv_fin", Dinv_fin, f32, (C, 9, 9), dev)
        factors = factor_t(P, Q, Dinv_fin, c_pad)         # alive until the launch is queued
        ptr["P"], ptr["Q"], ptr["D"] = (t.data_ptr() for t in factors)
    left = [None] * 5
    if n_left:
        for name, t, n in zip(pairs.left._fields, pairs.left, (C + 1, n_left, C + 1, n_left,
                                                                n_left)):
            _lib.check_tensor(f"left.{name}", t, torch.int32, (n,), dev)
        left = [t.data_ptr() for t in pairs.left]
    lib = _lib.load_library()
    cams = 0 if resident is False else resident_cams(form, pairs.band_offsets, C, dev)
    if resident and not cams:
        raise ValueError(f"pcg_banded: a band of {n_off} offsets over {C} cameras does not fit "
                         f"the resident form on this card")
    n_groups = -(-C // (cams or _CAMS_PER_GROUP))
    work = torch.empty((_WORK_ROWS, c_pad), dtype=f32, device=dev)
    partial = torch.empty((6, n_groups), dtype=f32, device=dev)   # the blocks' partial sums
    x = torch.empty((C, 9), dtype=f32, device=dev)
    info = torch.empty((2,), dtype=torch.int32, device=dev)
    status = lib.tba_pcg_banded(
        form, cams, blk.data_ptr(), pairs.k_pad, U.data_ptr(), ptr["Minv"], ptr["P"], ptr["Q"],
        ptr["D"], levels, b.data_ptr(), None if x0 is None else x0.data_ptr(),
        pairs.band_offsets_t.data_ptr(), n_off, C, c_pad, *left, pairs.k_band, n_left,
        ptr["lam"], tol.data_ptr(), int(max_iters), float(diag_floor), float(diag_ceil),
        work.data_ptr(), partial.data_ptr(), x.data_ptr(), info[0:].data_ptr(),
        info[1:].data_ptr(), _lib.stream_ptr(blk))
    _lib.launches["pcg_band" if form == 0 else "pcg_band_given"] += 1
    form_launches["resident" if cams else "streaming"] += 1
    _lib.check_status("pcg_band", status)
    return x, info[0], info[1] != 0
