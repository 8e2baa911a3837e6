"""Scene save/load — .npz and MATLAB .mat containers.

Counterpart of ``tpu_ba/io/scene.py``, with its schema, so files cross
between the packages::

    cameras (C, cam_dim), points (P, 3), obs_2d (O, 2),
    cam_idx (O,) int32, pt_idx (O,) int32, model (a string)

Padded rows are stripped on save and made again on load, so files do not
depend on the padding.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_ba_torch.core import BAProblem, make_problem, to_host


def _to_arrays(problem: BAProblem) -> dict:
    n = problem.n_obs
    return {
        "cameras": to_host(problem.cameras),
        "points": to_host(problem.points),
        "obs_2d": to_host(problem.obs_2d)[:n],
        "cam_idx": to_host(problem.cam_idx)[:n].astype(np.int32),
        "pt_idx": to_host(problem.pt_idx)[:n].astype(np.int32),
        "model": np.asarray(problem.model),
    }


def _extension(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".npz", ".mat"):
        raise ValueError(f"unsupported scene extension {ext!r} (use .npz or .mat)")
    return ext


def save_scene(path: str, problem: BAProblem) -> None:
    """Save a scene as .npz or .mat (chosen by extension)."""
    arrays = _to_arrays(problem)
    if _extension(path) == ".mat":
        from scipy.io import savemat

        savemat(path, arrays)
    else:
        np.savez_compressed(path, **arrays)


def load_scene(path: str, *, dtype=torch.float32, pad_multiple: int = 1024,
               device=None) -> BAProblem:
    """Load a scene saved by either package's ``save_scene`` (or a MATLAB
    struct with the same field names) onto ``device`` (default: the CUDA
    card, see ``resolve_device``)."""
    if _extension(path) == ".mat":
        from scipy.io import loadmat

        raw = loadmat(path)
    else:
        with np.load(path, allow_pickle=False) as z:
            raw = dict(z)

    def arr(name):
        if name not in raw:
            raise KeyError(f"scene file {path} missing field {name!r}")
        return np.asarray(raw[name])

    model = str(np.asarray(raw.get("model", "bal")).reshape(-1)[0])
    return make_problem(arr("cameras"), arr("points"), arr("obs_2d"),
                        arr("cam_idx").reshape(-1), arr("pt_idx").reshape(-1),
                        model=model, dtype=dtype, pad_multiple=pad_multiple, device=device)
