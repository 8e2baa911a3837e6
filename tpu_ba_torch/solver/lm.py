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
were the last), and each CG iteration of the host-loop PCG one flag
(``solver/pcg.py``); both are counted in
``tpu_ba_torch.solver.pcg.host_reads``. The banded PCG kernel (K4, K8) runs
its loop on the device and reads nothing. A solve resumed from a given
state reads λ's ceiling test once; the chunked solve (``checkpoint_every``,
``nan_guard``) reads its counts, cost and finiteness once a chunk and, when
it dumps a checkpoint, copies the state to the host in one transfer.

Chunked solves and resumed solves are the uninterrupted solve bit for bit:
the loop state at a chunk's boundary is (parameters, λ, ν, iteration count,
warm-start step, g₀), and what a new chunk recomputes from it (the cost by
``cost_fn``, the linearization at the same parameters) the uninterrupted
loop computed the same way.

Linear-solver tiers (the names are the reference's):
  * "dense"               — the full damped normal equations solved directly
                            (``solver/dense.py``): the oracle, tiny problems
  * "schur_dense"         — explicit dense reduced camera system from a
                            non-symmetric pair plan, block-Jacobi PCG
  * "schur_dense_pallas"  — the same with K2/K3 (linearize, trial cost)
  * "schur_pcg"           — matrix-free Schur + block-Jacobi PCG, plain
                            PyTorch reductions
  * "schur_pcg_pallas"    — the same with the hand-written kernels: K2
                            (linearize), K3 (trial cost) and K1 (every
                            segment sum)
  * "schur_sparse"        — explicit block-sparse Schur complement from a
                            static covisibility-pair plan
                            (``solver/pairs.py``), all plain PyTorch: the
                            CPU oracle and the f64 tier
  * "schur_sparse_pallas" — the same with K2/K3/K1, the blocks built by K7
                            (pairs), K5 (tracks) and K6 (slots); on a banded
                            plan the whole PCG solve in one kernel (K4, or K8
                            with ``precond="tridiag"``), on a non-banded one
                            the host-loop PCG with K1 in its matvec

Sharded (``group``, ``tpu_ba_torch/sharding/``): the same loop on every rank
over the rank's observation shard, parameters replicated. The cost, the
linearization's sums and the Schur routines' observation sums are
all-reduced, W is all-gathered once per linearization, and every host read
of the loop's flags is checked equal across the ranks
(``solver/collective.py``). ``dense`` and ``schur_dense*`` have no sharded
path and raise, as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from tpu_ba_torch.checkpoint.state import load_checkpoint, save_checkpoint
from tpu_ba_torch.core import BAProblem, LMConfig, LMResult
from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
from tpu_ba_torch.kernels.linearize import fused_cost, fused_linearize_assemble
from tpu_ba_torch.residuals.reprojection import residuals_bal
from tpu_ba_torch.residuals.robust import robust_rho
from tpu_ba_torch.solver.collective import all_gather_cols, all_reduce, all_reduce_many
from tpu_ba_torch.solver.dense import solve_dense
from tpu_ba_torch.solver.normal import BlockSystem, assemble
from tpu_ba_torch.solver.pairs import (build_pair_plan, precompute_pair_data, solve_schur_dense,
                                       solve_schur_sparse)
from tpu_ba_torch.solver.pcg import host_reads, read_flags
from tpu_ba_torch.solver.plans import build_plans, pt_segsum_t
from tpu_ba_torch.solver.schur import solve_schur_pcg

SPARSE_TIERS = ("schur_sparse", "schur_sparse_pallas")
DENSE_TIERS = ("schur_dense", "schur_dense_pallas")
TIERS = ("dense", "schur_pcg", "schur_pcg_pallas") + DENSE_TIERS + SPARSE_TIERS


def check_config(config: LMConfig) -> None:
    """Raise ValueError for an unknown tier or preconditioner."""
    if config.linear_solver not in TIERS:
        raise ValueError(f"unknown linear_solver {config.linear_solver!r}")
    if config.precond not in ("jacobi", "tridiag"):
        raise ValueError(f"precond must be 'jacobi' or 'tridiag', got {config.precond!r}")


def check_sharded_tier(config: LMConfig) -> None:
    """Raise ValueError for the tiers with no sharded path, as the reference
    does (``tpu_ba/sharding/distributed.py:solve_sharded``)."""
    if config.linear_solver == "dense":
        raise ValueError("dense solver has no sharded path; use schur_pcg")
    if config.linear_solver in DENSE_TIERS:
        raise ValueError("schur_dense has no sharded path; use schur_sparse")


def _robust_cost(r, kind, scale, mask):
    rho = robust_rho(kind, torch.sum(r * r, dim=-1), scale)
    return 0.5 * torch.sum(torch.where(mask, rho, torch.zeros_like(rho)))


def lm_loop(cams0, pts0, obs, ci, pi, mask, n_cameras: int, n_points: int,
            config: LMConfig, plans=None, init_state=None, pairs=None,
            stop_at: int | None = None, group=None) -> LMResult:
    """The LM trust-region loop. ``pairs`` is the pair plan of the sparse
    and dense-Schur tiers (``solver/pairs.py``). ``init_state`` = (lam, nu, it[, warm_dxc,
    gnorm0]) — numbers, numpy arrays or tensors, e.g. from a ``tpu_ba``
    LMResult — resumes the trust-region state; with cams0/pts0 from the same
    source the resumed trajectory is the uninterrupted one. ``stop_at``
    pauses the loop at that iteration count (a chunk's boundary); the
    histories keep ``config.max_iters`` slots. ``group``: a sharded solve's
    mesh (``sharding.make_mesh``); obs/ci/pi/mask are then the rank's shard,
    ``plans`` and ``pairs`` the rank's (``sharding.solve_sharded``)."""
    check_config(config)
    sparse = config.linear_solver in SPARSE_TIERS
    paired = sparse or config.linear_solver in DENSE_TIERS
    if group is not None:
        check_sharded_tier(config)
    if paired and pairs is None:
        raise ValueError(f"linear_solver={config.linear_solver!r} needs a pair plan "
                         "(solve() builds one)")
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
            c = fused_cost(cams, pts, obs, ci, pi, mask, sched=plans.lin_sched,
                           robust_kind=kind, robust_scale=scale)
        else:
            c = _robust_cost(residuals_bal(cams, pts, obs, ci, pi, mask), kind, scale, mask)
        return all_reduce(c, group)

    def linearize(cams, pts) -> BlockSystem:
        if use_fused:
            U, gc, W, pt_vals = fused_linearize_assemble(
                cams, pts, obs, ci, pi, mask, plans.cam_start, sched=plans.lin_sched,
                robust_kind=kind, robust_scale=scale, freeze_cols=config.freeze_camera_cols)
            ptp = pt_segsum_t(plans, pt_vals[:12], pi, n_points)
            # the rank's partials → replicated totals, one collective
            U, gc, ptp, cost_lin = all_reduce_many([U, gc, ptp, 0.5 * torch.sum(pt_vals[12])],
                                                   group)
            return BlockSystem(U=U, V=ptp[:9], W=W, gc=gc, gp=ptp[9:12], cost=cost_lin,
                               cam_idx=ci, pt_idx=pi)
        r, Jc, Jp = jacobian_blocks_bal(cams, pts, obs, ci, pi, mask)
        if config.freeze_camera_cols:
            colmask = torch.tensor([0.0 if m in config.freeze_camera_cols else 1.0
                                    for m in range(cams.shape[-1])], dtype=dtype, device=device)
            Jc = Jc * colmask[None, :, None]
        return assemble(r, Jc, Jp, ci, pi, n_cameras, n_points, kind, scale, mask, plans, group)

    def linear_solve(B, lam, pair_data, cg_x0, cg_tol):
        if config.linear_solver == "dense":
            dxc, dxp = solve_dense(B, lam, config.diag_floor, config.diag_ceil)
            return dxc, dxp, 0, torch.ones((), dtype=torch.bool, device=device)
        kw = dict(cg_max_iters=config.cg_max_iters, cg_tol=cg_tol, cg_x0=cg_x0,
                  diag_floor=config.diag_floor, diag_ceil=config.diag_ceil)
        if sparse:
            return solve_schur_sparse(
                B, lam, pairs, pair_data, precond=config.precond, plans=plans, group=group,
                pcg_kernel=config.linear_solver == "schur_sparse_pallas", **kw)
        if paired:
            return solve_schur_dense(B, lam, pairs, pair_data, **kw)
        return solve_schur_pcg(B, lam, plans=plans, group=group, **kw)

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
        # λ below its ceiling, in the working dtype
        (lam_ok,) = read_flags("state", lam < config.max_lambda, group=group)
    else:
        lam = as_scalar(config.init_lambda)
        nu = as_scalar(2.0)
        it = 0
        lam_ok = bool(np.asarray(config.init_lambda, np_dtype) < config.max_lambda)
    limit = M if stop_at is None else min(int(stop_at), M)

    cams, pts, cost = cams0, pts0, cost0
    n_acc = 0
    gnorm = as_scalar(np.inf)
    done = False
    pair_data = None
    while it < limit and not done:
        # drop the last linearization's pair gathers (gigabytes at Venice
        # scale) before the next ones are made
        B = pair_data = None
        B = linearize(cams, pts)
        # λ-free pair-space gathers, amortized over the λ-retries; sharded, from
        # the all-gathered W (pair indices are global observation ids)
        if paired:
            pair_data = precompute_pair_data(B, pairs, all_gather_cols(B.W, group))
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
        while not accepted and it < limit and lam_ok:
            dxc, dxp, n_cg, solve_ok = linear_solve(
                B, lam, pair_data, dxc if config.cg_warm_start else None, cg_tol)
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
            cg_hist[it] = n_cg             # an int, or K4's device count: no host read

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

            accepted, lam_ok, done = read_flags("lm", accept, lam_next < config.max_lambda, done_t,
                                                group=group)
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


def _structure_key(problem: BAProblem) -> tuple:
    """What a host-built plan depends on: the index maps (hashed on the
    host, so computed once per solve), the sizes and the device."""
    h = hashlib.blake2b(digest_size=16)
    h.update(problem.cam_idx.cpu().numpy().tobytes())
    h.update(problem.pt_idx.cpu().numpy().tobytes())
    return (str(problem.device), problem.n_obs, problem.cameras.shape[0],
            problem.points.shape[0], h.hexdigest())


def _memoized(key, build):
    if key not in _PLAN_MEMO:
        if len(_PLAN_MEMO) >= _PLAN_MEMO_MAX:
            _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
        _PLAN_MEMO[key] = build()
    return _PLAN_MEMO[key]


def build_solver_plans(problem: BAProblem, config: LMConfig):
    """(assembly plans, pair plan) that ``config.linear_solver`` needs for
    ``problem``, each None where the tier uses none; memoized per problem
    structure. The ``*_pallas`` tiers get the segment plans
    (``solver/plans.py``), and so does every tier on the card, whose
    camera- and point-keyed sums are then K1's over them (built once per
    structure, where ``segment_sum_t`` would sort the point keys at every
    sum); the sparse tiers a symmetric pair plan, with what the kernels walk
    only for ``schur_sparse_pallas``; the dense-Schur tiers a full
    (non-symmetric) one."""
    plans = pairs = None
    tier = config.linear_solver
    paired = tier in SPARSE_TIERS or tier in DENSE_TIERS
    segment_plans = tier.endswith("_pallas") or problem.device.type == "cuda"
    if segment_plans or paired:
        structure = _structure_key(problem)
    if segment_plans:
        plans = _memoized(
            ("assembly",) + structure,
            lambda: build_plans(problem.cam_idx, problem.pt_idx,
                                problem.cameras.shape[0], problem.points.shape[0]))
    if paired:
        sparse = tier in SPARSE_TIERS
        kernels = tier == "schur_sparse_pallas"
        # S = Sᵀ: the compact path stores only the ci ≤ cj blocks; the dense
        # T-major build needs the full enumeration
        pairs = _memoized(
            (f"pairs-{sparse}-{kernels}",) + structure,
            lambda: build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs,
                                    problem.cameras.shape[0], problem.points.shape[0],
                                    with_kernel_plans=kernels, symmetric=sparse))
    return plans, pairs


def solve(problem: BAProblem, config: LMConfig | None = None, *,
          init_state=None, resume_from: str | None = None) -> LMResult:
    """Bundle-adjust ``problem`` with Levenberg–Marquardt on the problem's
    device. The ``*_pallas`` tiers run the hand-written kernels; on CPU
    tensors the kernels' plain versions run instead. Plans are those of
    ``build_solver_plans``, built once per solve. ``init_state`` is that of
    ``lm_loop``; ``resume_from`` names a checkpoint directory (of either
    package) whose parameters and trust-region state the solve continues
    from. ``config.checkpoint_every`` > 0 (with ``checkpoint_path``) or
    ``config.nan_guard`` runs the solve in chunks (``_solve_chunked``)."""
    if config is None:
        config = LMConfig()
    if problem.model == "pinhole":
        # fixed-K pinhole in the BAL 9-slot layout: f, k1, k2 frozen exactly
        config = dataclasses.replace(
            config, freeze_camera_cols=tuple(sorted(set(config.freeze_camera_cols) | {6, 7, 8})))
    elif problem.model != "bal":
        raise ValueError(f"solve() handles the 'bal' and 'pinhole' models; got {problem.model!r}")
    check_config(config)
    if resume_from:
        if init_state is not None:
            raise ValueError("pass init_state or resume_from, not both")
        problem, init_state = _resume_state(problem, resume_from)
    plans, pairs = build_solver_plans(problem, config)
    chunk = config.checkpoint_every if config.checkpoint_every > 0 else (
        8 if config.nan_guard else 0)
    if chunk > 0:
        return _solve_chunked(problem, config, plans, pairs, init_state, chunk)
    return lm_loop(problem.cameras, problem.points, problem.obs_2d, problem.cam_idx,
                   problem.pt_idx, problem.mask, problem.cameras.shape[0],
                   problem.points.shape[0], config, plans=plans,
                   init_state=init_state, pairs=pairs)


def _resume_state(problem: BAProblem, path: str):
    """The problem at a checkpoint's parameters and the checkpoint's
    trust-region state (λ, ν, iteration, warm-start step, g₀); ν, the
    warm-start step and g₀ default to 2, zeros and 0 where the checkpoint
    lacks them, as the reference's do."""
    ck = load_checkpoint(path)
    dt, dev = problem.cameras.dtype, problem.device

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    problem = problem.with_params(t(ck["cameras"]), t(ck["points"]))
    ex = ck["extra_tensors"]
    nu = float(np.asarray(ex.get("nu", 2.0)))
    warm = t(ex["warm_dxc"]) if "warm_dxc" in ex else torch.zeros_like(problem.cameras)
    gnorm0 = float(np.asarray(ex.get("gnorm0", 0.0)))
    return problem, (ck["lam"], nu, ck["iteration"], warm, gnorm0)


def _solve_chunked(problem: BAProblem, config: LMConfig, plans, pairs, init_state,
                   chunk: int, group=None) -> LMResult:
    """Run ``lm_loop`` ``chunk`` iterations at a time over plans built once.
    Between chunks: with ``nan_guard``, a line for a non-finite state; with
    ``checkpoint_every`` and ``checkpoint_path``, a dump of the whole loop
    state (parameters, λ, ν, iteration, warm-start step, g₀). Stops when
    converged, at ``max_iters``, or when a chunk makes no progress. The
    histories are spliced from the chunks and the accepted counts summed, so
    the result is the uninterrupted solve's. Sharded (``group``, ``problem``
    the rank's shard): every rank runs the chunks, rank 0 writes the
    checkpoints."""
    M = config.max_iters
    it = int(init_state[2]) if init_state is not None else 0
    state = init_state
    cams, pts = problem.cameras, problem.points
    hist = lam_hist = cg_hist = initial_cost = None
    accepted = 0
    dump = (config.checkpoint_every > 0 and bool(config.checkpoint_path)
            and (group is None or group.rank == 0))
    while True:
        res = lm_loop(cams, pts, problem.obs_2d, problem.cam_idx, problem.pt_idx, problem.mask,
                      problem.cameras.shape[0], problem.points.shape[0], config, plans=plans,
                      init_state=state, pairs=pairs, stop_at=it + chunk, group=group)
        finite = (torch.isfinite(res.cost) & torch.isfinite(res.cameras).all()
                  & torch.isfinite(res.points).all())
        host_reads["state"] += 1          # one transfer, as f64
        it_new, converged, cost, lam, finite = torch.stack(
            [v.to(torch.float64) for v in (res.iterations, res.converged, res.cost, res.lam,
                                           finite)]).tolist()
        it_new = int(it_new)
        if hist is None:
            hist, lam_hist, cg_hist = (res.cost_history.clone(), res.lam_history.clone(),
                                       res.cg_history.clone())
            initial_cost = res.initial_cost
        else:   # this chunk's slots; the cost history forward-filled from it
            hist[it:] = res.cost_history[it:]
            lam_hist[it:it_new] = res.lam_history[it:it_new]
            cg_hist[it:it_new] = res.cg_history[it:it_new]
        accepted = accepted + res.accepted
        if config.nan_guard and not finite:
            print(f"[tpu-ba nan-guard] non-finite state at iteration {it_new} "
                  f"(cost={cost:.6g}, lambda={lam:.3g})", flush=True)
        if dump:
            save_result(config.checkpoint_path, res)
        if converged or it_new >= M or it_new <= it:
            break
        it = it_new
        state = (res.lam, res.nu, it_new, res.warm_dxc, res.gnorm0)
        cams, pts = res.cameras, res.points
    return dataclasses.replace(res, initial_cost=initial_cost, accepted=accepted,
                               cost_history=hist, lam_history=lam_hist, cg_history=cg_hist)


def save_result(path: str, res: LMResult) -> None:
    """Checkpoint ``res``'s whole loop state (parameters, λ, ν, iteration,
    warm-start step, g₀) into the directory ``path``, copied to the host in
    one transfer: a solve resumed from it continues ``res``'s trajectory."""
    dt = res.cameras.dtype
    parts = (res.cameras, res.points, res.warm_dxc, res.lam, res.nu, res.gnorm0, res.cost,
             res.iterations)
    host_reads["state"] += 1
    flat = torch.cat([p.reshape(-1).to(dt) for p in parts]).cpu().numpy()
    cams, pts, warm, rest = np.split(flat, np.cumsum([p.numel() for p in parts[:3]]))
    lam, nu, gnorm0, cost, iteration = rest.tolist()
    save_checkpoint(path, cameras=cams.reshape(res.cameras.shape),
                    points=pts.reshape(res.points.shape), lam=lam, iteration=int(iteration),
                    cost=cost, extra={"nu": np.asarray(nu), "gnorm0": np.asarray(gnorm0),
                                      "warm_dxc": warm.reshape(res.warm_dxc.shape)})
