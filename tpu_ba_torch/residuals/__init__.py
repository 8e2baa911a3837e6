"""Robust losses and reprojection residuals."""

from tpu_ba_torch.residuals.reprojection import (  # noqa: F401
    residuals_bal,
    residuals_pinhole,
    cost_from_residuals,
)
from tpu_ba_torch.residuals.robust import (  # noqa: F401
    ROBUST_NONE,
    ROBUST_HUBER,
    ROBUST_CAUCHY,
    ROBUST_ARCTAN,
    robust_rho,
    robust_weight,
    robust_cost,
)
