"""Pose-graph refinement: LM over SE(3) relative-pose constraints.

Counterpart of ``tpu_ba/posegraph/solver.py``:

  * residual per edge: r_e = log( Z_e⁻¹ · (g_i · g_j⁻¹) ) ∈ ℝ⁶ with an
    optional 6×6 square-root information weighting,
  * the 6×6 Jacobian blocks of each edge's two endpoints by forward-mode
    autodiff (``_edge_jacobians``),
  * dense damped normal equations (6N × 6N) solved by ``torch.linalg.solve``,
    the gauge fixed by an anchor prior on node 0.

Right-multiplicative local update: g ← exp(δ) ∘ g.

H and g are assembled in a fixed order, so a solve repeats bit for bit on the
card: the edges' block contributions are sorted on the host by (row node,
column node), and the k-th contribution of every block is added in pass k
(``_assembly_plan``), where each pass writes every block at most once. (The
CUDA forms of ``index_add_`` / ``index_put_(accumulate=True)`` add with float
atomics in any order.) The LM loop runs on the host, with one device→host
read per iteration: the done flag. Accept, λ update and stop are
``torch.where`` on device scalars, as in the reference's ``while_loop``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from tpu_ba_torch.core import resolve_device, to_host
from tpu_ba_torch.geometry.se3 import se3_compose, se3_exp, se3_inverse, se3_log


def _edge_residual(g_i, g_j, z_ij):
    """r = log(Z⁻¹ ∘ g_i ∘ g_j⁻¹) — zero when the relative pose matches."""
    rel = se3_compose(g_i, se3_inverse(g_j))
    return se3_log(se3_compose(se3_inverse(z_ij), rel))


def _edge_residual_local(delta_i, delta_j, g_i, g_j, z_ij):
    """Residual after right-multiplicative perturbations exp(δ)∘g."""
    gi = se3_compose(se3_exp(delta_i), g_i)
    gj = se3_compose(se3_exp(delta_j), g_j)
    return _edge_residual(gi, gj, z_ij)


def _edge_jacobians(g_i, g_j, z_ij):
    """(E, 6, 6) blocks ∂r/∂δ_i and ∂r/∂δ_j at δ = 0.

    The residual is batched over edges already, so the Jacobian is 12
    forward-mode products over all edges at once, one per unit twist
    (``vmap`` over the basis of ``jvp``): ``jacfwd`` with the edges as an
    outer ``vmap``, as the reference writes it, mis-batches the tangent of
    ``se3_log``'s ``torch.linalg.solve`` when the matrix is vmapped (wrong
    blocks, found with torch 2.13 on the CPU)."""
    E = g_i.shape[0]
    zero = torch.zeros((E, 6), dtype=g_i.dtype, device=g_i.device)
    basis = torch.eye(12, dtype=g_i.dtype, device=g_i.device)

    def column(v):
        return jvp(lambda di, dj: _edge_residual_local(di, dj, g_i, g_j, z_ij),
                   (zero, zero), (v[:6].expand(E, 6), v[6:].expand(E, 6)))[1]

    J = vmap(column, out_dims=-1)(basis)                       # (E, 6, 12)
    return J[..., :6], J[..., 6:]


def _whiten(sqrt_info, r):
    return r if sqrt_info is None else torch.einsum("eij,ej->ei", sqrt_info, r)


def pose_graph_cost(nodes, ei, ej, meas, sqrt_info=None):
    """½ Σ_e |Ω_e^{1/2} r_e|²."""
    ei, ej = torch.as_tensor(ei).long(), torch.as_tensor(ej).long()
    r = _whiten(sqrt_info, _edge_residual(nodes[ei], nodes[ej], meas))
    return 0.5 * torch.sum(r * r)


def _rank_passes(keys: np.ndarray, device):
    """Contributions with equal ``keys`` (source order kept) split into
    passes: pass k holds the k-th contribution of every key, so no key
    repeats within a pass. Returns [(source index, key)] per pass."""
    order = np.argsort(keys, kind="stable")
    k_sorted = keys[order]
    starts = np.r_[0, np.nonzero(np.diff(k_sorted))[0] + 1]
    seg_len = np.diff(np.r_[starts, k_sorted.size])
    rank = np.arange(k_sorted.size) - np.repeat(starts, seg_len)
    return [(torch.as_tensor(order[rank == k], device=device),
             torch.as_tensor(k_sorted[rank == k], device=device))
            for k in range(int(rank.max()) + 1 if rank.size else 0)]


def _assembly_plan(ei: np.ndarray, ej: np.ndarray, N: int, device):
    """Host-built fixed-order plan for H's 6×6 blocks and g's 6-vectors.

    Block sources, in this order: JiᵀJi at (i, i), JjᵀJj at (j, j), JiᵀJj at
    (i, j), its transpose at (j, i); gradient sources Jiᵀr at i, Jjᵀr at j."""
    rows = np.concatenate([ei, ej, ei, ej]).astype(np.int64)
    cols = np.concatenate([ei, ej, ej, ei]).astype(np.int64)
    h_passes = _rank_passes(rows * N + cols, device)
    g_passes = _rank_passes(np.concatenate([ei, ej]).astype(np.int64), device)
    return h_passes, g_passes


def solve_pose_graph(nodes0, ei, ej, meas, sqrt_info=None, *,
                     max_iters: int = 30, init_lambda: float = 1e-4,
                     anchor_weight: float = 1e8, device=None):
    """LM pose-graph optimization.

    nodes0: (N, 6) initial poses [aa, t]; ei, ej: (E,) edge endpoints;
    meas: (E, 6) measured relative poses g_i ∘ g_j⁻¹; sqrt_info: optional
    (E, 6, 6) square-root information matrices. Arrays or tensors; they run
    on ``device`` (default: the tensor ``nodes0``'s device, else the CUDA
    card, see ``resolve_device``) in ``nodes0``'s dtype.
    Returns (nodes, final_cost, iterations).
    """
    if device is None and isinstance(nodes0, torch.Tensor):
        device = nodes0.device
    device = resolve_device(device)
    nodes0 = torch.as_tensor(nodes0, device=device)
    dtype = nodes0.dtype
    ei_h, ej_h = to_host(ei).astype(np.int64), to_host(ej).astype(np.int64)
    meas = torch.as_tensor(meas, dtype=dtype, device=device)
    if sqrt_info is not None:
        sqrt_info = torch.as_tensor(sqrt_info, dtype=dtype, device=device)
    N = nodes0.shape[0]
    ei_t = torch.as_tensor(ei_h, device=device)
    ej_t = torch.as_tensor(ej_h, device=device)
    h_passes, g_passes = _assembly_plan(ei_h, ej_h, N, device)
    a6 = torch.arange(6, device=device)

    def linearize(nodes):
        gi, gj = nodes[ei_t], nodes[ej_t]
        r = _edge_residual(gi, gj, meas)                       # (E, 6)
        Ji, Jj = _edge_jacobians(gi, gj, meas)                  # (E, 6, 6) each
        if sqrt_info is not None:
            r = _whiten(sqrt_info, r)
            Ji = sqrt_info @ Ji
            Jj = sqrt_info @ Jj
        JiTJj = Ji.transpose(1, 2) @ Jj
        blocks = torch.cat([Ji.transpose(1, 2) @ Ji, Jj.transpose(1, 2) @ Jj,
                            JiTJj, JiTJj.transpose(1, 2)])    # sources of _assembly_plan
        grads = torch.cat([(Ji.transpose(1, 2) @ r[..., None])[..., 0],
                           (Jj.transpose(1, 2) @ r[..., None])[..., 0]])
        H = torch.zeros((N * 6, N * 6), dtype=dtype, device=device)
        Hv = H.view(N, 6, N, 6)
        for src, key in h_passes:                              # each block once a pass
            rn, cn = key // N, key % N
            Hv[rn, :, cn, :] = Hv[rn, :, cn, :] + blocks[src]
        g = torch.zeros((N, 6), dtype=dtype, device=device)
        for src, key in g_passes:
            g[key] = g[key] + grads[src]
        H[a6, a6] += anchor_weight                             # gauge anchor on node 0
        return H, g.reshape(-1)

    def cost_of(nodes):
        return pose_graph_cost(nodes, ei_t, ej_t, meas, sqrt_info)

    nodes, cost = nodes0, cost_of(nodes0)
    lam = torch.tensor(init_lambda, dtype=dtype, device=device)
    it, done = 0, False
    while it < max_iters and not done:
        H, g = linearize(nodes)
        d = torch.clamp(torch.diagonal(H), 1e-8, 1e32)
        H.diagonal().add_(lam * d)                             # H + λ·diag(d)
        delta = torch.linalg.solve(H, -g).reshape(N, 6)
        del H
        new_nodes = se3_compose(se3_exp(delta), nodes)
        new_cost = cost_of(new_nodes)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        nodes = torch.where(accept, new_nodes, nodes)
        cost_next = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                          torch.clamp(lam * 4.0, max=1e10))
        rel = (cost - cost_next) / torch.clamp(cost, min=1e-30)
        cost = cost_next
        it += 1
        done = bool(accept & (rel < 1e-10))                    # the one host read
    return nodes, cost, it
