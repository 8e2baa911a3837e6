"""Build and load the hand-written CUDA kernels (``tpu_ba_torch/csrc/``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``: no PyTorch headers, so a build takes
seconds. Each ``.cu`` compiles to its own object, all started together, and
one link makes the library. It lands in ``build/tpu_ba_torch/`` at the root
of the checkout, named by a hash of the sources and flags, and is built on
first use; a failed build raises with nvcc's output. Nothing here runs at
import.

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
              "-Xcompiler", "-fPIC")

# kernel name → launches since the last reset
# ("pcg_band": the fold-damp form of the PCG kernel, K4; "pcg_band_given": its
# forms with Ul and the preconditioner given, K8)
launches = {"segsum": 0, "linearize": 0, "cost": 0, "pcg_band": 0, "trackband": 0,
            "slotband": 0, "pairblocks": 0, "pcg_band_given": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # packed, lam, items, n_items, pieces, n_pieces, empty, n_empty, fold_seg,
    # fold_start, n_split, partial, out, n_pairs, k_pad, group_log2,
    # diag_floor, diag_ceil, stream
    "tba_pair_blocks": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _F, _F,
                        _P],
    # Wt, Vt, mask, key_start, lam, out, dmax, pt_pad, c_pad, ld_out, diag_floor,
    # diag_ceil, stream
    "tba_track_blocks": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # W, cam, mask, V, inc_start, inc, off_idx, lam, out, degree, pt_pad,
    # c_pad, ld_out, diag_floor, diag_ceil, stream
    "tba_slot_blocks": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # form, cams, blk, ld, U, Minv, pcr_P, pcr_Q, pcr_D, pcr_levels, b, x0,
    # offsets, n_offsets, n_cameras, c_pad, row_start, row_cj, col_start, col_seg,
    # col_ci, left_base, n_left, lam, tol, max_iters, diag_floor, diag_ceil, work,
    # partial, x, iterations, ok, stream
    "tba_pcg_banded": [_I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                       _P, _P, _P, _I, _I, _P, _P, _I, _F, _F, _P, _P, _P, _P, _P, _P],
    # form, n_offsets, n_cameras → cameras a group of the resident form, 0, or −cudaError
    "tba_pcg_resident_cams": [_I, _I, _I],
    # form, n_offsets, cams → bytes of dynamic shared memory of the resident form
    "tba_pcg_resident_smem": [_I, _I, _I],
    # n_blocks, smem_bytes, n, partial, out, stream
    "tba_pcg_barrier_floor": [_I, _I, _I, _P, _P, _P],
    # values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2, stream
    "tba_segsum_t": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the same in double
    "tba_segsum_t_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # cams, pts, obs, pt_idx, mask, pieces, n_pieces, piece_obs, piece_start,
    # empty, n_empty, n_obs, threads, robust_kind, robust_scale, freeze_mask, U,
    # gc, obs_out, scratch, ticket, stream
    "tba_linearize": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _F,
                      ctypes.c_uint, _P, _P, _P, _P, _P, _P],
    # cams, pts, obs, pt_idx, mask, pieces, n_pieces, robust_kind, robust_scale,
    # partial, ticket, out, stream
    "tba_cost": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P],
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
    tag = f"{path.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _, proc in jobs:                  # wait for every compile, then report
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.tmp"
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {type(t).__name__}, the kernel takes a tensor on {device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
