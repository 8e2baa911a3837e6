"""Rotations, camera models and SE(3) poses."""

from tpu_ba_torch.geometry.rotations import (  # noqa: F401
    aa_to_matrix,
    matrix_to_aa,
    aa_to_quat,
    quat_to_aa,
    quat_to_matrix,
    quat_mul,
    rotate_aa,
    rotate_aa_transpose,
)
from tpu_ba_torch.geometry.cameras import (  # noqa: F401
    BAL_CAM_DIM,
    PINHOLE_CAM_DIM,
    project_bal,
    project_pinhole,
    camera_center_bal,
)
from tpu_ba_torch.geometry.se3 import (  # noqa: F401
    se3_exp,
    se3_log,
    se3_compose,
    se3_inverse,
    se3_apply,
    se3_relative,
)
