"""The SfM front end: features, matching, two-view, PnP, incremental SfM."""

from tpu_ba_torch.sfm.features import detect_harris, describe_patches  # noqa: F401
from tpu_ba_torch.sfm.matching import match_descriptors  # noqa: F401
from tpu_ba_torch.sfm.twoview import (  # noqa: F401
    estimate_essential_ransac,
    decompose_essential,
)
from tpu_ba_torch.sfm.triangulate import triangulate_points  # noqa: F401
from tpu_ba_torch.sfm.pnp import pnp_ransac  # noqa: F401
from tpu_ba_torch.sfm.incremental import run_incremental_sfm  # noqa: F401
