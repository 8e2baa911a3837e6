"""Problem generators, BAL and scene files, image sequences."""

from tpu_ba_torch.io.synthetic import make_synthetic_problem  # noqa: F401
from tpu_ba_torch.io.bal import load_bal, save_bal, make_bal_like_problem  # noqa: F401
