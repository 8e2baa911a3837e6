"""Per-problem static schedules for the segment-sum kernels.

Counterpart of ``tpu_ba/solver/plans.py``. Built once on the host from the
observation index maps and reused for every LM iteration and CG matvec:

  * ``perm_pt``: the permutation that puts observations in point-sorted
    order, and ``pt_sorted_keys = pt_idx[perm_pt]``;
  * ``cam_start`` / ``pt_start``: CSR segment starts of the camera-sorted
    ``cam_idx`` and of ``pt_sorted_keys`` (``n + 1`` int32 each). The CUDA
    kernels read segment k as the run ``[start[k], start[k+1])``; these
    replace the reference's one-hot ``SegsumPlan`` work lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t, sorted_segment_sum_t_plain


@dataclasses.dataclass(frozen=True)
class AssemblyPlans:
    perm_pt: torch.Tensor         # (O,) int64: obs order → point-sorted order
    pt_sorted_keys: torch.Tensor  # (O,) int32: pt_idx[perm_pt] (sorted)
    cam_start: torch.Tensor       # (C+1,) int32 CSR starts of cam_idx
    pt_start: torch.Tensor        # (P+1,) int32 CSR starts of pt_sorted_keys


def _csr_starts(sorted_keys: np.ndarray, n: int) -> np.ndarray:
    return np.searchsorted(sorted_keys, np.arange(n + 1), side="left").astype(np.int32)


def build_plans(cam_idx, pt_idx, n_cameras: int, n_points: int) -> AssemblyPlans:
    """Host-side plan construction from the index maps; the plan's tensors
    live on the device of ``cam_idx``."""
    device = cam_idx.device
    ci = cam_idx.cpu().numpy()
    pi = pt_idx.cpu().numpy()
    if np.any(np.diff(ci) < 0):
        raise ValueError("cam_idx must be sorted (camera-sorted observations)")
    # the kernels index cameras and points without bounds checks
    for name, idx, n in (("cam_idx", ci, n_cameras), ("pt_idx", pi, n_points)):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{name} outside [0, {n})")
    perm = np.argsort(pi, kind="stable")
    pk = pi[perm].astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    return AssemblyPlans(
        perm_pt=t(perm.astype(np.int64)),
        pt_sorted_keys=t(pk),
        cam_start=t(_csr_starts(ci, n_cameras)),
        pt_start=t(_csr_starts(pk, n_points)),
    )


def cam_segsum_t(plans: AssemblyPlans | None, values_t, cam_idx, n_cameras: int):
    """Camera-keyed segment sum, lane-major: (D, O) → (D, C). With plans it
    goes through the K1 wrapper; without, through plain PyTorch."""
    if plans is None:
        return sorted_segment_sum_t_plain(values_t, cam_idx, n_cameras)
    return sorted_segment_sum_t(values_t, cam_idx, n_cameras, plans.cam_start)


def pt_segsum_t(plans: AssemblyPlans | None, values_t, pt_idx, n_points: int):
    """Point-keyed segment sum, lane-major: (D, O) → (D, P). With plans:
    gather into point-sorted order, then K1 over the sorted keys."""
    if plans is None:
        return sorted_segment_sum_t_plain(values_t, pt_idx, n_points)
    return sorted_segment_sum_t(values_t[:, plans.perm_pt], plans.pt_sorted_keys,
                                n_points, plans.pt_start)
