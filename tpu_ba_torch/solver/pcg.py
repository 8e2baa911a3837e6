"""Preconditioned conjugate gradients on the reduced camera system.

Counterpart of ``tpu_ba/solver/pcg.py``. PyTorch has no device-side while
loop, so the loop runs on the host over device tensors and reads one flag to
the host per iteration: ``rᵀr > tol²·max(‖b‖², 1e-30)`` and no breakdown.
``host_reads`` counts those reads (and the LM loop's and the chunked
solve's, see ``lm.py``).

Breakdown contract: pᵀAp ≤ 0 (A not positive definite at this damping) or
rᵀz ≤ 0 (the preconditioner is not) freezes the iterate, flags not-ok and
stops; the LM loop then rejects the step and raises λ.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.solver.collective import agree

# device→host reads since the last reset: "cg" per CG iteration test,
# "lm" per λ-retry (accept / λ ceiling / done), "state" per read of the loop
# state at a resumed solve's or a chunk's boundary
host_reads = {"cg": 0, "lm": 0, "state": 0}


def reset_host_reads() -> None:
    for k in host_reads:
        host_reads[k] = 0


def read_flags(kind: str, *flags, group=None) -> list[bool]:
    """Bring boolean device scalars to the host in one transfer; under a
    sharded solve's ``group``, checked equal on every rank
    (``collective.agree``)."""
    host_reads[kind] += 1
    return agree(torch.stack(flags), group)


def _safe(x):
    return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)


def pcg(matvec, b, precond, *, max_iters: int, tol, x0=None, group=None):
    """Solve A x = b with preconditioned CG.

    Returns (x, iterations_used: int, ok: 0-dim bool tensor); ``ok`` is
    False when a breakdown was hit. ``group``: the sharded solve's, whose
    ranks must agree on every iteration's flag."""
    x = torch.zeros_like(b) if x0 is None else x0

    def dot(a, c):
        return torch.sum(a * c)

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    tol2 = tol * tol * torch.clamp(dot(b, b), min=1e-30)
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iters:
        (go,) = read_flags("cg", (dot(r, r) > tol2) & ok, group=group)
        if not go:
            break
        Ap = matvec(p)
        pAp = dot(p, Ap)
        broke = (pAp <= 0) | (rz <= 0)
        alpha = torch.where(broke, torch.zeros_like(rz), rz / _safe(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / _safe(rz)
        p = z + beta * p
        rz = rz_new
        ok = ok & ~broke
        k += 1
    return x, k, ok
