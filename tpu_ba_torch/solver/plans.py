"""Per-problem static schedules for the segment-sum kernels.

Counterpart of ``tpu_ba/solver/plans.py``. Built once on the host from the
observation index maps and reused for every LM iteration and CG matvec:

  * ``perm_pt``: the permutation that puts observations in point-sorted
    order (int32: the K1 kernel gathers through it), and
    ``pt_sorted_keys = pt_idx[perm_pt]``;
  * ``cam_start`` / ``pt_start``: CSR segment starts of the camera-sorted
    ``cam_idx`` and of ``pt_sorted_keys`` (``n + 1`` int32 each). The CUDA
    kernels read segment k as the run ``[start[k], start[k+1])``; these
    replace the reference's one-hot ``SegsumPlan`` work lists;
  * ``cam_longest`` / ``pt_longest``: the longest segment of each, from
    which K1 picks its schedule (``kernels/segsum.py:group_log2``);
  * ``lin_sched``: K2's and K3's schedule, each camera's run cut into pieces
    (``kernels/linearize.py:linearize_schedule``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ba_torch.kernels.linearize import LinSchedule, linearize_schedule
from tpu_ba_torch.kernels.segsum import segment_sum_t, sorted_segment_sum_t


@dataclasses.dataclass(frozen=True)
class AssemblyPlans:
    perm_pt: torch.Tensor         # (O,) int32: obs order → point-sorted order (K1's ``perm``)
    pt_sorted_keys: torch.Tensor  # (O,) int32: pt_idx[perm_pt] (sorted)
    cam_start: torch.Tensor       # (C+1,) int32 CSR starts of cam_idx
    pt_start: torch.Tensor        # (P+1,) int32 CSR starts of pt_sorted_keys
    cam_longest: int | None = None   # observations of the camera with the most
    pt_longest: int | None = None    # observations of the point with the most
    lin_sched: LinSchedule | None = None   # K2's and K3's pieces


def _csr_starts(sorted_keys: np.ndarray, n: int) -> np.ndarray:
    return np.searchsorted(sorted_keys, np.arange(n + 1), side="left").astype(np.int32)


def longest_segment(starts: np.ndarray) -> int:
    """Length of the longest segment of CSR ``starts`` (0 with no segment)."""
    return int(np.diff(starts).max()) if starts.size > 1 else 0


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

    cam_start, pt_start = _csr_starts(ci, n_cameras), _csr_starts(pk, n_points)
    return AssemblyPlans(
        perm_pt=t(perm.astype(np.int32)),
        pt_sorted_keys=t(pk),
        cam_start=t(cam_start),
        pt_start=t(pt_start),
        cam_longest=longest_segment(cam_start),
        pt_longest=longest_segment(pt_start),
        lin_sched=linearize_schedule(cam_start, device=device),
    )


def cam_segsum_t(plans: AssemblyPlans | None, values_t, cam_idx, n_cameras: int):
    """Camera-keyed segment sum, lane-major: (D, O) → (D, C). With plans it
    goes through the K1 wrapper; without, through ``segment_sum_t`` (the
    plain version on the CPU, K1 over starts built on the device on the
    card)."""
    if plans is None:
        return segment_sum_t(values_t, cam_idx, n_cameras, sorted_keys=True)
    return sorted_segment_sum_t(values_t, cam_idx, n_cameras, plans.cam_start,
                                longest=plans.cam_longest)


def pt_segsum_t(plans: AssemblyPlans | None, values_t, pt_idx, n_points: int):
    """Point-keyed segment sum, lane-major: (D, O) → (D, P). With plans: K1
    over the point-sorted keys, reading the values through ``perm_pt`` (one
    kernel, no gathered copy)."""
    if plans is None:
        return segment_sum_t(values_t, pt_idx, n_points)
    return sorted_segment_sum_t(values_t, plans.pt_sorted_keys, n_points, plans.pt_start,
                                perm=plans.perm_pt, longest=plans.pt_longest)
