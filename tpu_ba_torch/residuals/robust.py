"""Robust losses (Huber / Cauchy / arctan) and their IRLS weights.

Counterpart of ``tpu_ba/residuals/robust.py``. For a residual block with
squared norm ``s = |r|²`` the robust cost is ``ρ(s)`` and the IRLS weight is
``w = ρ'(s)``; the weighted Gauss-Newton system uses ``√w·r`` and ``√w·J``.

ρ conventions (scale a in pixels):
  none:    ρ(s) = s
  huber:   ρ(s) = s                        if s ≤ a²
           ρ(s) = 2a√s − a²                otherwise
  cauchy:  ρ(s) = a² log(1 + s/a²)
  arctan:  ρ(s) = a² arctan(s/a²)
"""

from __future__ import annotations

import torch

ROBUST_NONE = 0
ROBUST_HUBER = 1
ROBUST_CAUCHY = 2
ROBUST_ARCTAN = 3
ROBUST_KINDS = {"none": ROBUST_NONE, "huber": ROBUST_HUBER,
                "cauchy": ROBUST_CAUCHY, "arctan": ROBUST_ARCTAN}


def atan_pos(x):
    """arctan(x) for x ≥ 0 by the reduction and minimax polynomial of
    ``tpu_ba.residuals.robust.atan_pos`` — the form the kernels evaluate
    (tpu_ba_torch/csrc/projection.cuh), so the plain versions of the kernels
    compute the same function."""
    inv = x > 1.0
    xr = torch.where(inv, 1.0 / torch.clamp(x, min=1e-30), x)
    big = xr > 0.4142135623730951
    x1 = torch.where(big, (xr - 1.0) / (xr + 1.0), xr)
    z = x1 * x1
    p = x1 + x1 * z * (-3.33329491539e-1 + z * (
        1.99777106478e-1 + z * (-1.38776856032e-1 + z * 8.05374449538e-2)))
    r = torch.where(big, 0.7853981633974483 + p, p)
    return torch.where(inv, 1.5707963267948966 - r, r)


def robust_rho(kind: int, s, scale, *, pallas: bool = False):
    """ρ(s) for squared residual norms s. ``pallas=True`` selects the
    polynomial arctan of the kernels (the name follows the reference)."""
    a2 = scale * scale
    if kind == ROBUST_NONE:
        return s
    if kind == ROBUST_HUBER:
        s_safe = torch.clamp(s, min=a2)
        return torch.where(s <= a2, s, 2.0 * scale * torch.sqrt(s_safe) - a2)
    if kind == ROBUST_CAUCHY:
        return a2 * torch.log1p(s / a2)
    if kind == ROBUST_ARCTAN:
        at = atan_pos if pallas else torch.atan
        return a2 * at(s / a2)
    raise ValueError(f"unknown robust kind {kind}")


def robust_weight(kind: int, s, scale):
    """IRLS weight w = ρ'(s)."""
    a2 = scale * scale
    if kind == ROBUST_NONE:
        return torch.ones_like(s)
    if kind == ROBUST_HUBER:
        s_safe = torch.clamp(s, min=a2)
        return torch.where(s <= a2, torch.ones_like(s), scale / torch.sqrt(s_safe))
    if kind == ROBUST_CAUCHY:
        return 1.0 / (1.0 + s / a2)
    if kind == ROBUST_ARCTAN:
        return 1.0 / (1.0 + (s / a2) ** 2)
    raise ValueError(f"unknown robust kind {kind}")


def robust_cost(kind: int, r2d, scale, mask=None):
    """Total robust cost ½ Σ ρ(|r_o|²) over observations.

    r2d: (O, 2) per-observation residuals; mask: (O,) validity (padding).
    """
    rho = robust_rho(kind, torch.sum(r2d * r2d, dim=-1), scale)
    if mask is not None:
        rho = torch.where(mask, rho, torch.zeros_like(rho))
    return 0.5 * torch.sum(rho)
