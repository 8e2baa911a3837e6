"""Preconditioned conjugate gradients on the reduced camera system.

Counterpart of ``tpu_ba/solver/pcg.py``. PyTorch has no device-side while
loop, so the loop runs on the host over device tensors and reads one flag to
the host per iteration: ``rᵀr > tol²·max(‖b‖², 1e-30)`` and no breakdown.
``host_reads`` counts those reads (and the LM loop's, see ``lm.py``).

Breakdown contract: pᵀAp ≤ 0 (A not positive definite at this damping) or
rᵀz ≤ 0 (the preconditioner is not) freezes the iterate, flags not-ok and
stops; the LM loop then rejects the step and raises λ.
"""

from __future__ import annotations

import torch

# device→host reads since the last reset: "cg" per CG iteration test,
# "lm" per λ-retry (accept / λ ceiling / done)
host_reads = {"cg": 0, "lm": 0}


def reset_host_reads() -> None:
    for k in host_reads:
        host_reads[k] = 0


def read_flags(kind: str, *flags) -> list[bool]:
    """Bring boolean device scalars to the host in one transfer."""
    host_reads[kind] += 1
    return [bool(v) for v in torch.stack(flags).tolist()]


def _safe(x):
    return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)


def pcg(matvec, b, precond, *, max_iters: int, tol, x0=None):
    """Solve A x = b with preconditioned CG.

    Returns (x, iterations_used: int, ok: 0-dim bool tensor); ``ok`` is
    False when a breakdown was hit."""
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
        (go,) = read_flags("cg", (dot(r, r) > tol2) & ok)
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
