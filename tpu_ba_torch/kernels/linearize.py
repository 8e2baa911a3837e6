"""K2: fused linearize + assemble, and K3: fused trial cost (BAL model).

K2 replaces ``tpu_ba/kernels/linearize.py:fused_linearize_assemble`` and K3
replaces ``tpu_ba/kernels/linearize.py:fused_cost``. The CUDA kernels are in
``tpu_ba_torch/csrc/linearize.cu`` and share one ``__device__`` projection
(``csrc/projection.cuh``); the plain PyTorch versions here share
``_projection_core`` in the same way, and follow the reference kernel's
arithmetic step for step.

Per-observation output rows (``(40, O)``, split into ``W`` and ``pt_vals``):
W = Jcᵀ Jp (27, row 3m+n) | VtV = Jpᵀ Jp (9) | gp = Jpᵀ r (3) | ρ·mask (1).
"""

from __future__ import annotations

import torch

from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t_plain
from tpu_ba_torch.residuals.robust import robust_rho, robust_weight

_SMALL_THETA2 = 1e-12
OBS_ROWS = 40
_COST_THREADS = 256   # csrc/linearize.cu:kCostThreads
_COST_MAX_BLOCKS = 1024


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


def fused_linearize_assemble(cameras, points, obs_2d, cam_idx, pt_idx, mask,
                             cam_start=None, *, robust_kind: int = 0,
                             robust_scale: float = 1.0, freeze_cols: tuple = ()):
    """One fused pass: (cameras, points) → (U (C,9,9), gc (C,9), W (27,O),
    pt_vals (13,O): VtV (9) | gp (3) | ρ (1)).

    A CPU tensor takes the plain version. A CUDA tensor launches K2, which
    walks each camera's run of observations from ``cam_start`` (``C + 1``
    int32 CSR starts of the camera-sorted ``cam_idx``)."""
    if cameras.device.type == "cpu":
        return fused_linearize_assemble_plain(
            cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind=robust_kind,
            robust_scale=robust_scale, freeze_cols=freeze_cols)
    dev, C, O = _check_inputs(cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind)
    if cam_start is None:
        raise ValueError("fused_linearize_assemble on CUDA needs cam_start (see solver/plans.py)")
    _lib.check_tensor("cam_start", cam_start, torch.int32, (C + 1,), dev)
    lib = _lib.load_library()
    U = torch.empty((C, 9, 9), dtype=torch.float32, device=dev)
    gc = torch.empty((C, 9), dtype=torch.float32, device=dev)
    obs_out = torch.empty((OBS_ROWS, O), dtype=torch.float32, device=dev)
    status = lib.tba_linearize(
        cameras.data_ptr(), points.data_ptr(), obs_2d.data_ptr(), pt_idx.data_ptr(),
        mask.data_ptr(), cam_start.data_ptr(), C, O, int(robust_kind), float(robust_scale),
        _freeze_mask(freeze_cols), U.data_ptr(), gc.data_ptr(), obs_out.data_ptr(),
        _lib.stream_ptr(cameras))
    _lib.launches["linearize"] += 1
    _lib.check_status("linearize", status)
    return U, gc, obs_out[:27], obs_out[27:]


def fused_cost(cameras, points, obs_2d, cam_idx, pt_idx, mask, *,
               robust_kind: int = 0, robust_scale: float = 1.0):
    """Robust reprojection cost ½Σρ as a 0-dim tensor. A CPU tensor takes
    the plain version; a CUDA tensor launches K3."""
    if cameras.device.type == "cpu":
        return fused_cost_plain(cameras, points, obs_2d, cam_idx, pt_idx, mask,
                                robust_kind=robust_kind, robust_scale=robust_scale)
    dev, C, O = _check_inputs(cameras, points, obs_2d, cam_idx, pt_idx, mask, robust_kind)
    lib = _lib.load_library()
    n_partial = max(1, min(-(-O // _COST_THREADS), _COST_MAX_BLOCKS))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    status = lib.tba_cost(
        cameras.data_ptr(), points.data_ptr(), obs_2d.data_ptr(), cam_idx.data_ptr(),
        pt_idx.data_ptr(), mask.data_ptr(), O, int(robust_kind), float(robust_scale),
        partial.data_ptr(), n_partial, out.data_ptr(), _lib.stream_ptr(cameras))
    _lib.launches["cost"] += 1
    _lib.check_status("cost", status)
    return out
