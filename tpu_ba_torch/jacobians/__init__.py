"""Analytic and autodiff Jacobian blocks."""

from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal  # noqa: F401
from tpu_ba_torch.jacobians.autodiff import jacobian_blocks_bal_autodiff  # noqa: F401
