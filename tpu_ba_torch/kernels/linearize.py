"""K2: fused linearize + assemble, and K3: fused trial cost (BAL model).

K2 replaces ``tpu_ba/kernels/linearize.py:fused_linearize_assemble`` and K3
replaces ``tpu_ba/kernels/linearize.py:fused_cost``. The CUDA kernels are in
``tpu_ba_torch/csrc/linearize.cu`` and share one ``__device__`` projection
(``csrc/projection.cuh``); the plain PyTorch versions here share
``_projection_core`` in the same way, and follow the reference kernel's
arithmetic step for step. Both kernels walk a schedule built once per
structure (``linearize_schedule``): each camera's run of observations cut
into pieces, so no block works a long camera alone; K2 runs a block per
piece, K3 a fixed grid of blocks over the pieces.

Per-observation output rows (``(40, O)``, split into ``W`` and ``pt_vals``):
W = Jcᵀ Jp (27, row 3m+n) | VtV = Jpᵀ Jp (9) | gp = Jpᵀ r (3) | ρ·mask (1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t_plain
from tpu_ba_torch.residuals.robust import robust_rho, robust_weight

_SMALL_THETA2 = 1e-12
OBS_ROWS = 40
CAM_SUMS = 54          # a camera's sums: U's upper triangle (45), then gc (9)

# K2's and K3's schedule (``linearize_schedule``): a block of LIN_THREADS
# threads of K2 works a piece of at most PIECE_OBS consecutive observations of
# one camera. Read off scripts/torch_lin_sweep.py (PERF.md §6).
LIN_THREADS = 128
PIECE_OBS = 512
MAX_PIECE_OBS = 1024   # csrc/linearize.cu:kMaxPieceObs, what a block stages


class LinSchedule(NamedTuple):
    """K2's and K3's work list, built once per structure by
    ``linearize_schedule``: every non-empty camera's run of observations cut
    into pieces of at most ``piece_obs`` consecutive observations, in order;
    each piece is one block of ``threads`` threads of K2. The index tensors
    are int32 and a pure function of ``cam_start``. ``ticket``, ``partial``
    and ``cost_partial`` are the kernels' working memory, allocated once
    here: the block that finishes a camera (K2) or the call (K3) last, by an
    integer counter, folds the partial sums in a fixed order and resets its
    counter to 0."""

    threads: int
    piece_obs: int
    n_obs: int                  # observations covered, cam_start[-1]
    longest: int                # observations of the longest camera
    pieces: torch.Tensor        # (3, n_pieces): camera, first obs, end obs; cameras ascending
    piece_start: torch.Tensor   # (C + 1,): CSR starts of each camera's pieces
    empty: torch.Tensor         # (n_empty,): the cameras with no observation
    ticket: torch.Tensor        # (C + 1,) int32 zeros: K2's counter per camera, then K3's
    partial: torch.Tensor       # (n_pieces, CAM_SUMS) f32: K2's sums per piece
    cost_partial: torch.Tensor  # (n_pieces,) f32: K3's sums per block (at most n_pieces)


def linearize_schedule(cam_start, *, device=None, threads: int = LIN_THREADS,
                       piece_obs: int = PIECE_OBS) -> LinSchedule:
    """K2's and K3's schedule from ``cam_start`` (the camera-sorted
    observations' CSR starts, one per camera and one past the last). A
    camera of L observations becomes ceil(L / ``piece_obs``) pieces of
    near-equal length, so that no block of a split camera is left with a
    short remainder while another works a full piece."""
    if isinstance(cam_start, torch.Tensor):
        cam_start = cam_start.cpu().numpy()
    starts = np.asarray(cam_start, dtype=np.int64)
    lens = np.diff(starts)
    if starts.size == 0 or starts[0] != 0 or (lens.size and lens.min() < 0):
        raise ValueError("cam_start must be non-decreasing from 0")
    if threads not in (64, 128, 256):
        raise ValueError(f"threads must be 64, 128 or 256, got {threads}")
    if not 1 <= piece_obs <= MAX_PIECE_OBS:
        raise ValueError(f"piece_obs must lie in [1, {MAX_PIECE_OBS}], got {piece_obs}")
    n_split = -(-lens // piece_obs)                            # 0 for an empty camera
    owner = np.repeat(np.arange(lens.size), n_split)            # camera of each piece
    first = np.repeat(np.cumsum(n_split) - n_split, n_split)    # its first piece
    k, n, length = np.arange(owner.size) - first, n_split[owner], lens[owner]
    lo = starts[owner] + k * length // n
    hi = starts[owner] + (k + 1) * length // n

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    n_pieces = owner.size
    return LinSchedule(
        threads=threads, piece_obs=piece_obs, n_obs=int(starts[-1]),
        longest=int(lens.max()) if lens.size else 0,
        pieces=t(np.stack([owner, lo, hi]).reshape(3, -1)),
        piece_start=t(np.concatenate([[0], np.cumsum(n_split)])),
        empty=t(np.flatnonzero(lens == 0)),
        ticket=torch.zeros(lens.size + 1, dtype=torch.int32, device=device),
        partial=torch.empty((n_pieces, CAM_SUMS), dtype=torch.float32, device=device),
        cost_partial=torch.empty((n_pieces,), dtype=torch.float32, device=device))


def _projection_core(cameras, points, obs_2d, cam_idx, pt_idx, mask):
    """BAL projection and masked residual per observation, with every
    intermediate the Jacobian chain reuses (lists of (O,) tensors)."""
    camg = cameras[cam_idx]
    ptg = points[pt_idx]
    c = [camg[:, i] for i in range(9)]
    X = [ptg[:, i] for i in range(3)]
    mk = mask.to(cameras.dtype)
    aa0, aa1, aa2 = c[0], c[1], c[2]

    # Rodrigues R = I + A·K + B·(aa aaᵀ − θ²I), Taylor-guarded
    t2 = aa0 * aa0 + aa1 * aa1 + aa2 * aa2
    small = t2 < _SMALL_THETA2
    one = torch.ones_like(t2)
    th = torch.sqrt(torch.where(small, one, t2))
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    Bc = torch.where(small, 0.5 - t2 / 24.0,
                     (1.0 - torch.cos(th)) / torch.where(small, one, t2))
    zero = torch.zeros_like(t2)
    K = [[zero, -aa2, aa1], [aa2, zero, -aa0], [-aa1, aa0, zero]]
    aav = [aa0, aa1, aa2]
    R = [[(1.0 if i == j else 0.0) + A * K[i][j]
          + Bc * (aav[i] * aav[j] - (t2 if i == j else zero))
          for j in range(3)] for i in range(3)]

    P = [R[i][0] * X[0] + R[i][1] * X[1] + R[i][2] * X[2] + c[3 + i] for i in range(3)]
    z = P[2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    inv_z = 1.0 / z_safe
    p0, p1 = -P[0] * inv_z, -P[1] * inv_z
    s = p0 * p0 + p1 * p1
    f, k1, k2 = c[6], c[7], c[8]
    d = 1.0 + s * (k1 + s * k2)
    r0 = (f * d * p0 - obs_2d[:, 0]) * mk
    r1 = (f * d * p1 - obs_2d[:, 1]) * mk
    return dict(X=X, mk=mk, f=f, k1=k1, k2=k2, t2=t2, small=small, K=K,
                aav=aav, R=R, inv_z=inv_z, p0=p0, p1=p1, s=s, d=d, r0=r0, r1=r1)


def fused_linearize_assemble_plain(cameras, points, obs_2d, cam_idx, pt_idx, mask, *,
                                   robust_kind: int = 0, robust_scale: float = 1.0,
                                   freeze_cols: tuple = ()):
    """Plain PyTorch version of K2. Returns (U (C,9,9), gc (C,9),
    W (27,O), pt_vals (13,O)) — the layout of the reference."""
    C = cameras.shape[0]
    pc = _projection_core(cameras, points, obs_2d, cam_idx, pt_idx, mask)
    X, mk, f, k1, k2 = pc["X"], pc["mk"], pc["f"], pc["k1"], pc["k2"]
    t2, small, K, aav, R = pc["t2"], pc["small"], pc["K"], pc["aav"], pc["R"]
    inv_z, p0, p1, s, d = pc["inv_z"], pc["p0"], pc["p1"], pc["s"], pc["d"]
    r0, r1 = pc["r0"], pc["r1"]
    zero = torch.zeros_like(t2)

    # robust IRLS: ρ and √ρ′ on the masked, unweighted residual
    sr = r0 * r0 + r1 * r1
    rho = robust_rho(robust_kind, sr, robust_scale, pallas=True) * mk
    sw = torch.sqrt(robust_weight(robust_kind, sr, robust_scale)) * mk

    g2 = 2.0 * (k1 + 2.0 * k2 * s)
    pvec = [p0, p1]
    du_dp = [[f * (d * (1.0 if a == b else 0.0) + g2 * pvec[a] * pvec[b])
              for b in range(2)] for a in range(2)]
    du_dP = [[-(du_dp[a][j]) * inv_z for j in range(2)] for a in range(2)]
    for a in range(2):
        du_dP[a].append(-(du_dp[a][0] * p0 + du_dp[a][1] * p1) * inv_z)

    # dP/daa: Gallego–Yezzi with −[X]× fallback
    t2s = torch.where(small, torch.ones_like(t2), t2)
    core = [[(aav[i] * aav[j]
              + sum((R[l][i] - (1.0 if l == i else 0.0)) * K[l][j] for l in range(3))) / t2s
             for j in range(3)] for i in range(3)]
    Xk = [[zero, -X[2], X[1]], [X[2], zero, -X[0]], [-X[1], X[0], zero]]
    RXk = [[sum(R[i][l] * Xk[l][j] for l in range(3)) for j in range(3)] for i in range(3)]
    dPda = [[torch.where(small, -Xk[i][j], -sum(RXk[i][l] * core[l][j] for l in range(3)))
             for j in range(3)] for i in range(3)]

    Jc = [[None] * 9 for _ in range(2)]
    Jp = [[None] * 3 for _ in range(2)]
    for a in range(2):
        for j in range(3):
            Jc[a][j] = sum(du_dP[a][l] * dPda[l][j] for l in range(3)) * sw
            Jc[a][3 + j] = du_dP[a][j] * sw
            Jp[a][j] = sum(du_dP[a][l] * R[l][j] for l in range(3)) * sw
        Jc[a][6] = d * pvec[a] * sw
        Jc[a][7] = f * s * pvec[a] * sw
        Jc[a][8] = f * s * s * pvec[a] * sw
        for col in freeze_cols:
            Jc[a][col] = zero
    r0 = r0 * sw
    r1 = r1 * sw

    obs_rows = [Jc[0][m] * Jp[0][n] + Jc[1][m] * Jp[1][n] for m in range(9) for n in range(3)]
    obs_rows += [Jp[0][m] * Jp[0][n] + Jp[1][m] * Jp[1][n] for m in range(3) for n in range(3)]
    obs_rows += [Jp[0][m] * r0 + Jp[1][m] * r1 for m in range(3)]
    obs_rows.append(rho)
    obs_out = torch.stack(obs_rows)                              # (40, O)

    cam_rows = [Jc[0][m] * Jc[0][n] + Jc[1][m] * Jc[1][n] for m in range(9) for n in range(9)]
    cam_rows += [Jc[0][m] * r0 + Jc[1][m] * r1 for m in range(9)]
    cam = sorted_segment_sum_t_plain(torch.stack(cam_rows), cam_idx, C)   # (90, C)
    U = cam[:81].reshape(9, 9, C).permute(2, 0, 1).contiguous()
    gc = cam[81:].T.contiguous()
    return U, gc, obs_out[:27], obs_out[27:]


def fused_cost_plain(cameras, points, obs_2d, cam_idx, pt_idx, mask, *,
                     robust_kind: int = 0, robust_scale: float = 1.0):
    """Plain PyTorch version of K3: ½ Σ ρ(|r|²) over valid observations."""
    pc = _projection_core(cameras, points, obs_2d, cam_idx, pt_idx, mask)
    r0, r1 = pc["r0"], pc["r1"]
    rho = robust_rho(robust_kind, r0 * r0 + r1 * r1, robust_scale, pallas=True) * pc["mk"]
    return 0.5 * torch.sum(rho)


def _freeze_mask(freeze_cols) -> int:
    bits = 0
    for col in freeze_cols:
        if not 0 <= col < 9:
            raise ValueError(f"frozen camera column {col} outside 0..8")
        bits |= 1 << col
    return bits


def _check_inputs(cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind):
    if robust_kind not in (0, 1, 2, 3):
        raise ValueError(f"unknown robust kind {robust_kind}")
    dev = cameras.device
    C, P, O = cameras.shape[0], points.shape[0], obs_2d.shape[0]
    _lib.check_tensor("cameras", cameras, torch.float32, (C, 9), dev)
    _lib.check_tensor("points", points, torch.float32, (P, 3), dev)
    _lib.check_tensor("obs_2d", obs_2d, torch.float32, (O, 2), dev)
    _lib.check_tensor("cam_idx", cam_idx, torch.int32, (O,), dev)
    _lib.check_tensor("pt_idx", pt_idx, torch.int32, (O,), dev)
    _lib.check_tensor("mask", mask, torch.bool, (O,), dev)
    return dev, C, O


def _check_schedule(sched, C: int, O: int, dev) -> int:
    """Raise unless ``sched`` is a ``LinSchedule`` for C cameras and O
    observations on ``dev``; returns its number of pieces."""
    if not isinstance(sched, LinSchedule):
        raise ValueError("K2 and K3 on CUDA need the linearize schedule "
                         "(build_plans: AssemblyPlans.lin_sched)")
    if sched.piece_start.shape[0] != C + 1 or sched.n_obs != O:
        raise ValueError(f"linearize schedule of {sched.piece_start.shape[0] - 1} cameras and "
                         f"{sched.n_obs} observations, expected {C} and {O}")
    n_pieces, n_empty = sched.pieces.shape[1], sched.empty.shape[0]
    _lib.check_tensor("pieces", sched.pieces, torch.int32, (3, n_pieces), dev)
    _lib.check_tensor("piece_start", sched.piece_start, torch.int32, (C + 1,), dev)
    _lib.check_tensor("empty", sched.empty, torch.int32, (n_empty,), dev)
    _lib.check_tensor("ticket", sched.ticket, torch.int32, (C + 1,), dev)
    _lib.check_tensor("partial", sched.partial, torch.float32, (n_pieces, CAM_SUMS), dev)
    _lib.check_tensor("cost_partial", sched.cost_partial, torch.float32, (n_pieces,), dev)
    return n_pieces


def fused_linearize_assemble(cameras, points, obs_2d, cam_idx, pt_idx, mask,
                             cam_start=None, *, sched: LinSchedule | None = None,
                             robust_kind: int = 0, robust_scale: float = 1.0,
                             freeze_cols: tuple = ()):
    """One fused pass: (cameras, points) → (U (C,9,9), gc (C,9), W (27,O),
    pt_vals (13,O): VtV (9) | gp (3) | ρ (1)).

    A CPU tensor takes the plain version. A CUDA tensor launches K2 over
    ``sched`` (``linearize_schedule`` of the camera-sorted observations'
    ``cam_start``, ``AssemblyPlans.lin_sched``), and raises without it;
    ``cam_start`` itself is not read there."""
    if cameras.device.type == "cpu":
        return fused_linearize_assemble_plain(
            cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind=robust_kind,
            robust_scale=robust_scale, freeze_cols=freeze_cols)
    dev, C, O = _check_inputs(cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind)
    n_pieces = _check_schedule(sched, C, O, dev)
    lib = _lib.load_library()
    U = torch.empty((C, 9, 9), dtype=torch.float32, device=dev)
    gc = torch.empty((C, 9), dtype=torch.float32, device=dev)
    obs_out = torch.empty((OBS_ROWS, O), dtype=torch.float32, device=dev)
    status = lib.tba_linearize(
        cameras.data_ptr(), points.data_ptr(), obs_2d.data_ptr(), pt_idx.data_ptr(),
        mask.data_ptr(), sched.pieces.data_ptr(), n_pieces, sched.piece_obs,
        sched.piece_start.data_ptr(), sched.empty.data_ptr(), sched.empty.shape[0], O,
        sched.threads, int(robust_kind),
        float(robust_scale), _freeze_mask(freeze_cols), U.data_ptr(), gc.data_ptr(),
        obs_out.data_ptr(), sched.partial.data_ptr(), sched.ticket.data_ptr(),
        _lib.stream_ptr(cameras))
    _lib.launches["linearize"] += 1
    _lib.check_status("linearize", status)
    return U, gc, obs_out[:27], obs_out[27:]


def fused_cost(cameras, points, obs_2d, cam_idx, pt_idx, mask, *,
               sched: LinSchedule | None = None, robust_kind: int = 0,
               robust_scale: float = 1.0):
    """Robust reprojection cost ½Σρ as a 0-dim tensor. A CPU tensor takes
    the plain version; a CUDA tensor launches K3 over K2's ``sched``, and
    raises without it."""
    if cameras.device.type == "cpu":
        return fused_cost_plain(cameras, points, obs_2d, cam_idx, pt_idx, mask,
                                robust_kind=robust_kind, robust_scale=robust_scale)
    dev, C, O = _check_inputs(cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind)
    n_pieces = _check_schedule(sched, C, O, dev)
    lib = _lib.load_library()
    out = torch.empty((), dtype=torch.float32, device=dev)
    status = lib.tba_cost(
        cameras.data_ptr(), points.data_ptr(), obs_2d.data_ptr(), pt_idx.data_ptr(),
        mask.data_ptr(), sched.pieces.data_ptr(), n_pieces, int(robust_kind),
        float(robust_scale), sched.cost_partial.data_ptr(), sched.ticket[C:].data_ptr(),
        out.data_ptr(), _lib.stream_ptr(cameras))
    _lib.launches["cost"] += 1
    _lib.check_status("cost", status)
    return out
