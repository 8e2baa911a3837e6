"""Build and load the hand-written CUDA kernels (``tpu_ba_torch/csrc/``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``: no PyTorch headers, so a build takes
seconds. The library lands in ``build/tpu_ba_torch/`` at the root of the
checkout, named by a hash of the sources and flags, and is built on first
use; a failed build raises with nvcc's output. Nothing here runs at import.

Each wrapper counts its launches in ``launches`` — one per call that
launches its kernel, none for a call that takes the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_ba_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel name → launches since the last reset
launches = {"segsum": 0, "linearize": 0, "cost": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # values, seg_start, out, n_rows, n_obs, n_out, group_log2, stream
    "tba_segsum_t": [_P, _P, _P, _I, _I, _I, _I, _P],
    # cams, pts, obs, pt_idx, mask, cam_start, n_cameras, n_obs, robust_kind,
    # robust_scale, freeze_mask, U, gc, obs_out, stream
    "tba_linearize": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                      ctypes.c_uint, _P, _P, _P, _P],
    # cams, pts, obs, cam_idx, pt_idx, mask, n_obs, robust_kind, robust_scale,
    # partial, n_partial, out, stream
    "tba_cost": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P, _I, _P, _P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_ba_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    path = library_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what the kernel takes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
