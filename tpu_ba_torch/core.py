"""Core containers: the BA problem, solver config and solver result.

The PyTorch counterpart of ``tpu_ba/core.py``, with the same field names:

  * ``BAProblem`` holds padded, camera-sorted observation arrays as tensors
    on one explicit device. ``n_obs`` and friends record the true counts and
    ``mask`` kills padded rows.
  * Observations are sorted by camera. The hand kernels
    (``tpu_ba_torch/kernels/``) reduce each camera's observations as one
    contiguous run, so they depend on this order.
  * Padding rows repeat the LAST camera and point index, which keeps
    ``cam_idx`` sorted and every gather in bounds; the mask zeroes their
    contributions.

``problem_from_numpy`` / ``problem_to_numpy`` carry a problem between this
package and ``tpu_ba`` (or anything else that speaks numpy) unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ba_torch.residuals.robust import ROBUST_NONE

_ARRAY_FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. ``None`` without a usable card raises; it never falls
    back to the CPU (pass ``device="cpu"`` to ask for it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_ba_torch runs on a CUDA card by default and torch.cuda.is_available() is "
            "false; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def device_of(index_map, device=None) -> torch.device:
    """Where a host-built plan puts its tensors: ``device`` if given, else
    the device of ``index_map`` when that is a tensor, else the default of
    ``resolve_device``."""
    if device is None and isinstance(index_map, torch.Tensor):
        return index_map.device
    return resolve_device(device)


def to_host(a) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """A (possibly padded) bundle-adjustment problem.

    cameras: (C, 9) — BAL: [aa(3), t(3), f, k1, k2]
    points:  (P, 3)
    obs_2d:  (O, 2) measured pixel coordinates
    cam_idx, pt_idx: (O,) int32 — observation incidence, camera-sorted
    mask:    (O,) bool — False on padded rows
    n_cameras/n_points/n_obs: true (unpadded) counts
    model:   "bal" or "pinhole"
    """

    cameras: torch.Tensor
    points: torch.Tensor
    obs_2d: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    mask: torch.Tensor
    n_cameras: int
    n_points: int
    n_obs: int
    model: str = "bal"

    @property
    def device(self) -> torch.device:
        return self.cameras.device

    def with_params(self, cameras, points) -> "BAProblem":
        return dataclasses.replace(self, cameras=cameras, points=points)


def make_problem(cameras, points, obs_2d, cam_idx, pt_idx, *,
                 model: str = "bal", pad_obs_to: int | None = None,
                 pad_multiple: int = 1024, dtype=torch.float32,
                 sort: bool = True, device=None) -> BAProblem:
    """Build a BAProblem from numpy arrays: sorts observations by camera,
    pads the observation axis to a bucket size, casts and places the
    tensors on ``device`` (default: the CUDA card, see ``resolve_device``).
    Same layout as ``tpu_ba.core.make_problem``."""
    device = resolve_device(device)
    cameras = np.asarray(cameras)
    points = np.asarray(points)
    obs_2d = np.asarray(obs_2d)
    cam_idx = np.asarray(cam_idx, dtype=np.int32)
    pt_idx = np.asarray(pt_idx, dtype=np.int32)
    n_obs = int(obs_2d.shape[0])

    if sort:
        order = np.argsort(cam_idx, kind="stable")
        obs_2d, cam_idx, pt_idx = obs_2d[order], cam_idx[order], pt_idx[order]

    target = pad_obs_to if pad_obs_to is not None else _round_up(max(n_obs, 1), pad_multiple)
    pad = target - n_obs
    if pad < 0:
        raise ValueError(f"pad_obs_to={pad_obs_to} < n_obs={n_obs}")
    mask = np.concatenate([np.ones(n_obs, bool), np.zeros(pad, bool)])
    obs_2d = np.concatenate([obs_2d, np.zeros((pad, 2), obs_2d.dtype)])
    last_c = cam_idx[-1] if n_obs else np.int32(0)
    last_p = pt_idx[-1] if n_obs else np.int32(0)
    cam_idx = np.concatenate([cam_idx, np.full(pad, last_c, np.int32)])
    pt_idx = np.concatenate([pt_idx, np.full(pad, last_p, np.int32)])

    def t(a, dt):  # a copy: the problem never aliases the caller's arrays
        return torch.as_tensor(np.array(a, order="C"), dtype=dt, device=device)

    return BAProblem(
        cameras=t(cameras, dtype), points=t(points, dtype), obs_2d=t(obs_2d, dtype),
        cam_idx=t(cam_idx, torch.int32), pt_idx=t(pt_idx, torch.int32),
        mask=t(mask, torch.bool),
        n_cameras=int(cameras.shape[0]), n_points=int(points.shape[0]),
        n_obs=n_obs, model=model,
    )


def problem_from_numpy(arrays: dict, *, n_cameras: int, n_points: int,
                       n_obs: int, model: str = "bal", device=None,
                       dtype=torch.float32) -> BAProblem:
    """The port's BAProblem from the fields of an already padded and
    camera-sorted problem (e.g. a ``tpu_ba.core.BAProblem``) given as numpy
    arrays: ``cameras, points, obs_2d, cam_idx, pt_idx, mask``. Nothing is
    re-sorted or re-padded, so both packages see the same observation order."""
    device = resolve_device(device)
    missing = [k for k in _ARRAY_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"problem arrays missing {missing}")
    cam_idx = np.asarray(arrays["cam_idx"])
    if cam_idx.size and np.any(np.diff(cam_idx) < 0):
        raise ValueError("cam_idx must be sorted (camera-sorted observations)")
    dts = {"cam_idx": torch.int32, "pt_idx": torch.int32, "mask": torch.bool}
    fields = {k: torch.as_tensor(np.array(arrays[k], order="C"), dtype=dts.get(k, dtype),
                                 device=device)
              for k in _ARRAY_FIELDS}
    return BAProblem(**fields, n_cameras=int(n_cameras), n_points=int(n_points),
                     n_obs=int(n_obs), model=model)


def problem_to_numpy(problem: BAProblem) -> dict:
    """The problem's arrays as numpy, plus its counts and model."""
    out = {k: getattr(problem, k).detach().cpu().numpy() for k in _ARRAY_FIELDS}
    out.update(n_cameras=problem.n_cameras, n_points=problem.n_points,
               n_obs=problem.n_obs, model=problem.model)
    return out


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg–Marquardt trust-region configuration; the fields and
    defaults of ``tpu_ba.core.LMConfig``. This package runs every
    ``linear_solver`` tier and both preconditioners of the reference, and
    its chunked checkpointing and NaN guard (``tpu_ba_torch/solver/lm.py``)."""

    max_iters: int = 50
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e12
    # convergence thresholds
    grad_tol: float = 1e-10       # on ‖g‖∞
    cost_rel_tol: float = 1e-8    # on relative cost decrease of accepted steps
    step_tol: float = 1e-12       # on ‖δ‖ / (‖x‖ + eps)
    # robustification
    robust_kind: int = ROBUST_NONE
    robust_scale: float = 1.0
    # inner linear solver: "dense", "schur_dense", "schur_pcg", "schur_sparse"
    # (plain torch) or their "*_pallas" forms (the hand-written kernels)
    linear_solver: str = "schur_pcg"
    cg_max_iters: int = 100
    cg_tol: float = 1e-3
    # warm-start CG from the previous linear solve's camera step
    cg_warm_start: bool = True
    # >0: per-linearization CG tolerance clip(sqrt(‖g‖∞/‖g₀‖∞), cg_tol, cg_forcing)
    cg_forcing: float = 0.0
    # PCG preconditioner of the sparse tiers: "jacobi" (block diagonal of S)
    # or "tridiag" (PCR-factored block-tridiagonal part; banded plans)
    precond: str = "jacobi"
    diag_floor: float = 1e-6
    diag_ceil: float = 1e32
    # camera parameter columns held fixed (zeroed Jacobian ⇒ zero update)
    freeze_camera_cols: tuple = ()
    checkpoint_every: int = 0
    checkpoint_path: str = ""
    nan_guard: bool = False

    def __post_init__(self):
        if not isinstance(self.freeze_camera_cols, tuple):
            object.__setattr__(self, "freeze_camera_cols",
                               tuple(self.freeze_camera_cols))


@dataclasses.dataclass(frozen=True)
class LMResult:
    """Solver output, with the fields of ``tpu_ba.core.LMResult``.
    ``cost_history`` has one slot per outer iteration, forward-filled with
    the final cost; ``nu``/``warm_dxc``/``gnorm0`` with (params, λ,
    iterations) are the whole trust-region state, so a solve resumed from
    them continues the same trajectory."""

    cameras: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    lam: torch.Tensor
    iterations: torch.Tensor
    accepted: torch.Tensor
    grad_inf_norm: torch.Tensor
    converged: torch.Tensor
    cost_history: torch.Tensor
    lam_history: torch.Tensor   # λ used at each linear solve
    cg_history: torch.Tensor    # CG iterations used at each linear solve
    nu: torch.Tensor            # Nielsen rejection growth factor
    warm_dxc: torch.Tensor      # last camera step (CG warm start)
    gnorm0: torch.Tensor        # first linearization's ‖g‖∞ (forcing sequence)
