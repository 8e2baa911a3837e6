"""MATLAB-class CPU LM baseline — the stand-in benchmark denominator.

Counterpart of ``tpu_ba/bench/cpu_baseline.py``, numpy and scipy only: the
same algorithm and arithmetic, reading the port's ``BAProblem`` as numpy.

The reference has no retrievable published numbers (SURVEY.md §0, §6;
BASELINE.json "published": {}), so per SURVEY.md §6 the ">10× MATLAB
wall-clock" target (BASELINE.json:5) is measured against this in-repo
re-implementation of the reference's algorithm in its own style:
single-threaded scipy — explicit sparse J assembly (``sparse(i,j,v)``-style
COO), damped normal equations, and a direct sparse "backslash" solve
(``spsolve``), per-iteration λ accept/reject. Reports label it as the
"MATLAB-class CPU baseline" stand-in.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def _cross_np(a, b):
    """Component-wise cross product — numpy's np.cross has a pathologically
    slow path for large (N, 3) inputs (~1000x)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1)


def _rodrigues_np(aa, X):
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    small = theta < 1e-12
    k = aa / np.where(small, 1.0, theta)
    c, s = np.cos(theta), np.sin(theta)
    R = X * c + _cross_np(k, X) * s + k * np.sum(k * X, 1, keepdims=True) * (1 - c)
    return np.where(small, X, R)


def _residuals_and_jac(cams, pts, obs, ci, pi):
    """Residuals + forward-difference Jacobian blocks, numpy."""
    cam = cams[ci]
    X = pts[pi]
    aa, t = cam[:, 0:3], cam[:, 3:6]
    f, k1, k2 = cam[:, 6:7], cam[:, 7:8], cam[:, 8:9]
    P = _rodrigues_np(aa, X) + t
    z = P[:, 2:3]
    p = -P[:, 0:2] / z
    s = np.sum(p * p, 1, keepdims=True)
    d = 1.0 + s * (k1 + s * k2)
    u = f * d * p
    r = u - obs

    n = obs.shape[0]
    eps = 1e-7
    # forward differences over the 12 local params (reference-style numeric
    # Jacobians are common in this package class; cheap on these sizes)
    Jc = np.zeros((n, 2, 9))
    Jp = np.zeros((n, 2, 3))

    def _proj(cam_l, X_l):
        P = _rodrigues_np(cam_l[:, 0:3], X_l) + cam_l[:, 3:6]
        p = -P[:, 0:2] / P[:, 2:3]
        s = np.sum(p * p, 1, keepdims=True)
        d = 1.0 + s * (cam_l[:, 7:8] + s * cam_l[:, 8:9])
        return cam_l[:, 6:7] * d * p

    for j in range(9):
        cam_d = cam.copy()
        cam_d[:, j] += eps
        Jc[:, :, j] = (_proj(cam_d, X) - u) / eps
    for j in range(3):
        X_d = X.copy()
        X_d[:, j] += eps
        Jp[:, :, j] = (_proj(cam, X_d) - u) / eps
    return r, Jc, Jp


def _build_sparse_J(Jc, Jp, ci, pi, n_cams, n_pts):
    """COO sparse J: rows 2 per obs, cols [pts*3 | cams*9].

    Points-first column ordering: eliminating the block-diagonal point
    columns first keeps LU fill confined to the camera-camera border — the
    ordering a good direct solver (MATLAB backslash/CHOLMOD) finds on BA
    normal equations. Used with permc_spec="NATURAL" in the solve.
    """
    n = ci.shape[0]
    rows_c = np.repeat(np.arange(2 * n).reshape(n, 2), 9, axis=1).reshape(-1)
    cols_c = n_pts * 3 + np.tile(
        (ci[:, None] * 9 + np.arange(9)[None, :])[:, None, :], (1, 2, 1)
    ).reshape(-1)
    rows_p = np.repeat(np.arange(2 * n).reshape(n, 2), 3, axis=1).reshape(-1)
    cols_p = np.tile(
        (pi[:, None] * 3 + np.arange(3)[None, :])[:, None, :], (1, 2, 1)
    ).reshape(-1)
    rows = np.concatenate([rows_c, rows_p])
    cols = np.concatenate([cols_c, cols_p])
    vals = np.concatenate([Jc.reshape(-1), Jp.reshape(-1)])
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(2 * n, n_cams * 9 + n_pts * 3)).tocsr()


def _schur_solve_np(Jc, Jp, r, ci, pi, n_cams, n_pts, lam):
    """Schur-eliminated direct solve in scipy/numpy (the reference's better
    path: "Schur-complement elimination of points", BASELINE.json:5).

    Sparse W/V assembly, batched 3×3 point-block inversion, explicit reduced
    camera system S (dense), Cholesky solve, back-substitution. This is the
    *fair* CPU denominator: no SuperLU pathology, BLAS-backed.
    """
    O = ci.shape[0]
    U = np.zeros((n_cams, 9, 9))
    V = np.zeros((n_pts, 3, 3))
    gc = np.zeros((n_cams, 9))
    gp = np.zeros((n_pts, 3))
    np.add.at(U, ci, np.einsum("oki,okj->oij", Jc, Jc))
    np.add.at(V, pi, np.einsum("oki,okj->oij", Jp, Jp))
    np.add.at(gc, ci, np.einsum("oki,ok->oi", Jc, r))
    np.add.at(gp, pi, np.einsum("oki,ok->oi", Jp, r))
    W_blocks = np.einsum("oki,okj->oij", Jc, Jp)  # (O,9,3)

    def _damp(M):
        d = np.maximum(np.einsum("...ii->...i", M), 1e-6)
        out = M.copy()
        ii = np.arange(M.shape[-1])
        out[..., ii, ii] += lam * d
        return out

    Ul, Vl = _damp(U), _damp(V)
    Vinv = np.linalg.inv(Vl)

    # sparse W: (C*9, P*3) from per-observation blocks
    rows = (ci[:, None, None] * 9 + np.arange(9)[None, :, None]).repeat(3, axis=2)
    cols = (pi[:, None, None] * 3 + np.arange(3)[None, None, :]).repeat(9, axis=1)
    W_sp = sp.coo_matrix(
        (W_blocks.reshape(-1), (rows.reshape(-1), cols.reshape(-1))),
        shape=(n_cams * 9, n_pts * 3),
    ).tocsr()
    Vinv_bd = sp.block_diag([sp.csr_matrix(Vinv[p]) for p in range(n_pts)], format="csr") \
        if n_pts <= 2000 else _block_diag_fast(Vinv)

    WVinv = W_sp @ Vinv_bd
    S = sp.block_diag([sp.csr_matrix(Ul[c]) for c in range(n_cams)], format="csr") \
        - WVinv @ W_sp.T
    b = -gc.reshape(-1) + WVinv @ gp.reshape(-1)

    # np.linalg over scipy cho_factor: scipy's LAPACK potrf wrapper has been
    # seen to segfault at ladybug-1723 dims (15507²); numpy's is fine and the
    # cost is identical (one dense Cholesky — the "backslash"-class solve).
    # The two back-solves use trtrs (O(n²) triangular solves) — ADVICE.md
    # round 2: np.linalg.solve ran a full LU per factor, inflating the
    # baseline denominator severalfold.
    from scipy.linalg import solve_triangular

    Sd = S.toarray()
    L = np.linalg.cholesky(Sd)
    dc = solve_triangular(L.T, solve_triangular(L, b, lower=True), lower=False)
    dp_flat = Vinv_bd @ (-gp.reshape(-1) - W_sp.T @ dc)
    return dc.reshape(n_cams, 9), dp_flat.reshape(n_pts, 3)


def _block_diag_fast(blocks):
    """Sparse block-diagonal from (N, k, k) without python-loop overhead."""
    N, k, _ = blocks.shape
    rows = (np.arange(N)[:, None, None] * k + np.arange(k)[None, :, None]).repeat(k, 2)
    cols = (np.arange(N)[:, None, None] * k + np.arange(k)[None, None, :]).repeat(k, 1)
    return sp.coo_matrix(
        (blocks.reshape(-1), (rows.reshape(-1), cols.reshape(-1))),
        shape=(N * k, N * k),
    ).tocsr()


def _host(a, dtype=None):
    if hasattr(a, "detach"):                 # a tensor
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def solve_cpu_baseline(problem, max_iters: int = 10,
                       init_lambda: float = 1e-4, time_budget_s: float | None = None,
                       method: str = "schur"):
    """Run the MATLAB-class LM. Returns dict with cost trace and timings.

    method: "schur" (fair BLAS-backed denominator, default) or "backslash"
    (spsolve on the full normal equations — closest to the reference's
    literal algorithm, but scipy's SuperLU is slow; kept for reference).
    """
    n_obs = problem.n_obs
    cams = _host(problem.cameras, np.float64).copy()
    pts = _host(problem.points, np.float64).copy()
    obs = _host(problem.obs_2d, np.float64)[:n_obs]
    ci = _host(problem.cam_idx)[:n_obs]
    pi = _host(problem.pt_idx)[:n_obs]
    n_cams, n_pts = cams.shape[0], pts.shape[0]

    def cost_of(c, p):
        cam = c[ci]
        X = p[pi]
        P = _rodrigues_np(cam[:, 0:3], X) + cam[:, 3:6]
        pp = -P[:, 0:2] / P[:, 2:3]
        s = np.sum(pp * pp, 1, keepdims=True)
        d = 1.0 + s * (cam[:, 7:8] + s * cam[:, 8:9])
        r = cam[:, 6:7] * d * pp - obs
        return 0.5 * float(np.sum(r * r))

    lam = init_lambda
    cost = cost_of(cams, pts)
    t0 = time.perf_counter()
    iter_times = []
    costs = [cost]
    iters_done = 0
    for it in range(max_iters):
        t_it = time.perf_counter()
        r, Jc, Jp = _residuals_and_jac(cams, pts, obs, ci, pi)
        if method == "schur":
            dc, dp = _schur_solve_np(Jc, Jp, r, ci, pi, n_cams, n_pts, lam)
        else:
            J = _build_sparse_J(Jc, Jp, ci, pi, n_cams, n_pts)
            g = J.T @ r.reshape(-1)
            H = (J.T @ J).tocsc()
            D = sp.diags(np.maximum(H.diagonal(), 1e-6))
            delta = spla.spsolve((H + lam * D).tocsc(), -g, permc_spec="NATURAL")
            dp = delta[: n_pts * 3].reshape(n_pts, 3)
            dc = delta[n_pts * 3:].reshape(n_cams, 9)
        new_cost = cost_of(cams + dc, pts + dp)
        if new_cost < cost:
            cams += dc
            pts += dp
            cost = new_cost
            lam = max(lam / 3.0, 1e-12)
        else:
            lam = min(lam * 4.0, 1e12)
        costs.append(cost)
        iter_times.append(time.perf_counter() - t_it)
        iters_done += 1
        if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
            break
    total = time.perf_counter() - t0
    return {
        "cost_trace": costs,
        "final_cost": cost,
        "iters": iters_done,
        "total_s": total,
        "sec_per_iter": total / max(iters_done, 1),
        "iter_times": iter_times,
    }
