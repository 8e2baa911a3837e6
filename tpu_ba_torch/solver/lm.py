"""Levenberg–Marquardt trust-region solver.

Counterpart of ``tpu_ba/solver/lm.py`` (``lm_loop`` and ``solve``). PyTorch
has no device-side while loop, so both loops are Python over device tensors:
one *linearization* per outer iteration, then λ-retries that each redo the
linear solve and a cost evaluation until a step is accepted. λ follows
Nielsen's rule (accept: λ·max(⅓, 1−(2ρ−1)³), ν=2; reject: λ·ν, ν·2). The
iteration, acceptance and CG counts follow the reference's semantics
exactly.

Host reads: each λ-retry brings one small tensor to the host (accepted,
λ below its ceiling, and the convergence test evaluated as if this retry
were the last), and each CG iteration one flag (``solver/pcg.py``); both are
counted in ``tpu_ba_torch.solver.pcg.host_reads``.

Linear-solver tiers:
  * "schur_pcg"        — matrix-free Schur + block-Jacobi PCG, plain PyTorch
                         reductions
  * "schur_pcg_pallas" — the same with the hand-written kernels: K2
                         (linearize), K3 (trial cost) and K1 (every segment
                         sum). The name is the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from tpu_ba_torch.core import BAProblem, LMConfig, LMResult
from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
from tpu_ba_torch.kernels.linearize import fused_cost, fused_linearize_assemble
from tpu_ba_torch.residuals.reprojection import residuals_bal
from tpu_ba_torch.residuals.robust import robust_rho
from tpu_ba_torch.solver.normal import BlockSystem, assemble
from tpu_ba_torch.solver.pcg import read_flags
from tpu_ba_torch.solver.plans import build_plans, pt_segsum_t
from tpu_ba_torch.solver.schur import solve_schur_pcg

TIERS = ("schur_pcg", "schur_pcg_pallas")
# the reference's other tiers, and the ROADMAP item that brings each
_NOT_PORTED = {
    "dense": "ROADMAP queue 1, item 7 (remaining tiers: the full-H oracle)",
    "schur_dense": "ROADMAP queue 1, item 7 (remaining tiers: dense reduced system)",
    "schur_dense_pallas": "ROADMAP queue 1, item 7 (remaining tiers: dense reduced system)",
    "schur_sparse": "ROADMAP queue 1, items 1-3 (host planners, sparse-Schur runtime)",
    "schur_sparse_pallas": "ROADMAP queue 1, items 1-3 and queue 2, K4-K7",
}


def check_config(config: LMConfig) -> None:
    """Raise NotImplementedError for what this package does not run yet."""
    if config.linear_solver not in TIERS:
        where = _NOT_PORTED.get(config.linear_solver)
        if where is None:
            raise ValueError(f"unknown linear_solver {config.linear_solver!r}")
        raise NotImplementedError(
            f"linear_solver={config.linear_solver!r} is not ported yet: {where}")
    if config.checkpoint_every > 0:
        raise NotImplementedError(
            "checkpoint_every>0 (chunked checkpointing) is not ported yet: ROADMAP queue 1, item 6")
    if config.nan_guard:
        raise NotImplementedError("nan_guard is not ported yet: ROADMAP queue 1, item 6")


def _robust_cost(r, kind, scale, mask):
    rho = robust_rho(kind, torch.sum(r * r, dim=-1), scale)
    return 0.5 * torch.sum(torch.where(mask, rho, torch.zeros_like(rho)))


def lm_loop(cams0, pts0, obs, ci, pi, mask, n_cameras: int, n_points: int,
            config: LMConfig, plans=None, init_state=None) -> LMResult:
    """The LM trust-region loop. ``init_state`` = (lam, nu, it[, warm_dxc,
    gnorm0]) — numbers, numpy arrays or tensors, e.g. from a ``tpu_ba``
    LMResult — resumes the trust-region state; with cams0/pts0 from the same
    source the resumed trajectory is the uninterrupted one."""
    check_config(config)
    dtype, device = cams0.dtype, cams0.device
    kind, scale = config.robust_kind, config.robust_scale
    use_fused = (plans is not None and cams0.shape[-1] == 9
                 and config.linear_solver.endswith("_pallas"))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def as_tensor(v):  # a number, numpy or jax array, or tensor, copied
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=dtype, copy=True)
        return torch.as_tensor(np.array(v, np_dtype), device=device)

    def as_scalar(v):
        return as_tensor(v).reshape(())

    def cost_fn(cams, pts):
        if use_fused:
            return fused_cost(cams, pts, obs, ci, pi, mask, robust_kind=kind, robust_scale=scale)
        return _robust_cost(residuals_bal(cams, pts, obs, ci, pi, mask), kind, scale, mask)

    def linearize(cams, pts) -> BlockSystem:
        if use_fused:
            U, gc, W, pt_vals = fused_linearize_assemble(
                cams, pts, obs, ci, pi, mask, plans.cam_start, robust_kind=kind,
                robust_scale=scale, freeze_cols=config.freeze_camera_cols)
            ptp = pt_segsum_t(plans, pt_vals[:12], pi, n_points)
            return BlockSystem(U=U, V=ptp[:9], W=W, gc=gc, gp=ptp[9:12],
                               cost=0.5 * torch.sum(pt_vals[12]), cam_idx=ci, pt_idx=pi)
        r, Jc, Jp = jacobian_blocks_bal(cams, pts, obs, ci, pi, mask)
        if config.freeze_camera_cols:
            colmask = torch.tensor([0.0 if m in config.freeze_camera_cols else 1.0
                                    for m in range(cams.shape[-1])], dtype=dtype, device=device)
            Jc = Jc * colmask[None, :, None]
        return assemble(r, Jc, Jp, ci, pi, n_cameras, n_points, kind, scale, mask, plans)

    M = config.max_iters
    cost0 = cost_fn(cams0, pts0)
    hist = cost0.reshape(1).repeat(M)
    lam_hist = torch.zeros(M, dtype=dtype, device=device)
    cg_hist = torch.zeros(M, dtype=torch.int32, device=device)

    warm = torch.zeros_like(cams0)
    gnorm0 = as_scalar(0.0)
    if init_state is not None:
        lam = as_scalar(init_state[0])
        nu = as_scalar(init_state[1])
        it = int(init_state[2])
        if len(init_state) > 3:
            warm = as_tensor(init_state[3])
            gnorm0 = as_scalar(init_state[4])
    else:
        lam = as_scalar(config.init_lambda)
        nu = as_scalar(2.0)
        it = 0
    lam_ok = bool(lam < config.max_lambda)   # λ below its ceiling, in the working dtype

    cams, pts, cost = cams0, pts0, cost0
    n_acc = 0
    gnorm = as_scalar(np.inf)
    done = False
    while it < M and not done:
        B = linearize(cams, pts)
        gnorm = torch.maximum(B.gc.abs().max(), B.gp.abs().max())
        gnorm0 = torch.where(gnorm0 > 0, gnorm0, gnorm)
        cg_tol = config.cg_tol
        if config.cg_forcing > 0:
            cg_tol = torch.clamp(torch.sqrt(gnorm / torch.clamp(gnorm0, min=1e-30)),
                                 config.cg_tol, config.cg_forcing)
        dU = torch.clamp(torch.diagonal(B.U, dim1=-2, dim2=-1), config.diag_floor, config.diag_ceil)
        dV = torch.clamp(torch.stack([B.V[0], B.V[4], B.V[8]], dim=-1),
                         config.diag_floor, config.diag_ceil)
        x_norm_old = torch.sqrt(torch.sum(cams * cams) + torch.sum(pts * pts))

        # λ-retries on this linearization; no retry runs only when λ is at
        # its ceiling, and then the solve is done
        accepted, done = False, True
        dxc = warm
        while not accepted and it < M and lam_ok:
            dxc, dxp, n_cg, solve_ok = solve_schur_pcg(
                B, lam, cg_max_iters=config.cg_max_iters, cg_tol=cg_tol,
                cg_x0=dxc if config.cg_warm_start else None,
                diag_floor=config.diag_floor, diag_ceil=config.diag_ceil, plans=plans)
            new_cams = cams + dxc
            new_pts = pts + dxp
            new_cost = cost_fn(new_cams, new_pts)

            # predicted reduction ½(λ δᵀDδ − δᵀg), D the damping diagonal
            dTDd = torch.sum(dU * dxc * dxc) + torch.sum(dV * dxp * dxp)
            dTg = torch.sum(B.gc * dxc) + torch.sum(B.gp.T * dxp)
            pred = 0.5 * (lam * dTDd - dTg)
            rho_gain = (cost - new_cost) / torch.clamp(pred, min=1e-30)
            # a PCG breakdown makes the direction unusable: force-reject
            accept = (new_cost < cost) & torch.isfinite(new_cost) & (pred > 0) & solve_ok

            factor = torch.clamp(1.0 - (2.0 * rho_gain - 1.0) ** 3, min=1.0 / 3.0)
            lam_acc = torch.clamp(lam * factor, config.min_lambda, config.max_lambda)
            lam_rej = torch.clamp(lam * nu, config.min_lambda, config.max_lambda)
            lam_next = torch.where(accept, lam_acc, lam_rej)
            nu_next = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            hist[it] = torch.where(accept, new_cost, cost)
            lam_hist[it] = lam
            cg_hist[it] = n_cg

            # convergence tests on this (possibly last) attempted step
            cost_next = torch.where(accept, new_cost, cost)
            step_norm = torch.sqrt(torch.sum(dxc * dxc) + torch.sum(dxp * dxp))
            x_norm = torch.where(
                accept, torch.sqrt(torch.sum(new_cams * new_cams) + torch.sum(new_pts * new_pts)),
                x_norm_old)
            rel_decrease = (cost - cost_next) / torch.clamp(cost, min=1e-30)
            done_t = ((gnorm < config.grad_tol)
                      | (accept & (rel_decrease < config.cost_rel_tol))
                      | (accept & (step_norm < config.step_tol * (x_norm + config.step_tol)))
                      | (lam_next >= config.max_lambda))

            accepted, lam_ok, done = read_flags("lm", accept, lam_next < config.max_lambda, done_t)
            lam, nu = lam_next, nu_next
            it += 1

        if accepted:
            cams, pts, cost = new_cams, new_pts, new_cost
            n_acc += 1
        warm = dxc

    # forward-fill the history for iterations that never ran
    hist = torch.where(torch.arange(M, device=device) < it, hist, cost)

    def int_t(v, dt=torch.int32):
        return torch.tensor(v, dtype=dt, device=device)

    return LMResult(
        cameras=cams, points=pts, cost=cost, initial_cost=cost0, lam=lam,
        iterations=int_t(it), accepted=int_t(n_acc), grad_inf_norm=gnorm,
        converged=int_t(done, torch.bool), cost_history=hist, lam_history=lam_hist,
        cg_history=cg_hist, nu=nu, warm_dxc=warm, gnorm0=gnorm0,
    )


# host-side plan memo: repeated solves of the same problem skip building the
# permutation and segment starts
_PLAN_MEMO: dict = {}
_PLAN_MEMO_MAX = 8


def _plan_key(problem: BAProblem, tag: str) -> tuple:
    h = hashlib.blake2b(digest_size=16)
    h.update(problem.cam_idx.cpu().numpy().tobytes())
    h.update(problem.pt_idx.cpu().numpy().tobytes())
    return (tag, str(problem.device), problem.n_obs, problem.cameras.shape[0],
            problem.points.shape[0], h.hexdigest())


def _memoized(key, build):
    if key not in _PLAN_MEMO:
        if len(_PLAN_MEMO) >= _PLAN_MEMO_MAX:
            _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
        _PLAN_MEMO[key] = build()
    return _PLAN_MEMO[key]


def solve(problem: BAProblem, config: LMConfig | None = None, *,
          init_state=None) -> LMResult:
    """Bundle-adjust ``problem`` with Levenberg–Marquardt on the problem's
    device. ``linear_solver="schur_pcg_pallas"`` builds the segment plans
    (``solver/plans.py``) and runs the hand-written kernels; on CPU tensors
    the kernels' plain versions run instead. ``init_state`` is that of
    ``lm_loop``."""
    if config is None:
        config = LMConfig()
    if problem.model == "pinhole":
        # fixed-K pinhole in the BAL 9-slot layout: f, k1, k2 frozen exactly
        config = dataclasses.replace(
            config, freeze_camera_cols=tuple(sorted(set(config.freeze_camera_cols) | {6, 7, 8})))
    elif problem.model != "bal":
        raise ValueError(f"solve() handles the 'bal' and 'pinhole' models; got {problem.model!r}")
    check_config(config)
    plans = None
    if config.linear_solver == "schur_pcg_pallas":
        plans = _memoized(
            _plan_key(problem, "assembly"),
            lambda: build_plans(problem.cam_idx, problem.pt_idx,
                                problem.cameras.shape[0], problem.points.shape[0]))
    return lm_loop(problem.cameras, problem.points, problem.obs_2d, problem.cam_idx,
                   problem.pt_idx, problem.mask, problem.cameras.shape[0],
                   problem.points.shape[0], config, plans=plans,
                   init_state=init_state)
