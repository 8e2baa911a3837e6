"""ctypes bindings for the native BAL parser (``io/_native/bal_parser.cpp``).

Counterpart of ``tpu_ba/io/native.py``. The parser compiles with ``g++ -O3
-shared -fPIC`` on first use into ``build/tpu_ba_torch/`` at the root of the
checkout, named by a hash of the source and flags, under a temporary name
that is then renamed, so processes that build at once do not see each
other's half-written library. A failed build or parse raises; nothing
falls back to the Python tokenizer (``load_bal(..., use_native=False)``
asks for that).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpu_ba_torch.kernels._lib import BUILD_DIR

SRC = Path(__file__).resolve().parent / "_native" / "bal_parser.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


class _BalData(ctypes.Structure):
    _fields_ = [
        ("n_cameras", ctypes.c_int64),
        ("n_points", ctypes.c_int64),
        ("n_obs", ctypes.c_int64),
        ("cam_idx", ctypes.POINTER(ctypes.c_int32)),
        ("pt_idx", ctypes.POINTER(ctypes.c_int32)),
        ("obs", ctypes.POINTER(ctypes.c_double)),
        ("cameras", ctypes.POINTER(ctypes.c_double)),
        ("points", ctypes.POINTER(ctypes.c_double)),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libbalparse_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the parser if the library for this source is missing."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the native BAL parser needs it ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The parser library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.bal_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(_BalData)]
            lib.bal_parse.restype = ctypes.c_int
            lib.bal_free.argtypes = [ctypes.POINTER(_BalData)]
            lib.bal_free.restype = None
            _lib = lib
        return _lib


def parse_bal_native(path: str):
    """Parse a plain-text BAL file. Returns (cameras (C, 9) f64, points
    (P, 3) f64, obs (O, 2) f64, cam_idx (O,) i32, pt_idx (O,) i32) in file
    order. Raises for a ``.gz`` file (the Python tokenizer reads those) and
    for a file the parser rejects."""
    if path.endswith(".gz"):
        raise ValueError(f"{path}: the native parser reads plain text; "
                         "load_bal(use_native=False) reads .gz files")
    lib = load_library()
    data = _BalData()
    rc = lib.bal_parse(os.fsencode(path), ctypes.byref(data))
    if rc != 0:
        lib.bal_free(ctypes.byref(data))        # what a failed parse allocated
        raise OSError(f"native BAL parser failed on {path} (code {rc}: -1 open, -2 stat, "
                      "-3 mmap, -4 a count not positive, -5 out of memory)")
    try:
        O, C, P = int(data.n_obs), int(data.n_cameras), int(data.n_points)
        cam_idx = np.ctypeslib.as_array(data.cam_idx, (O,)).copy()
        pt_idx = np.ctypeslib.as_array(data.pt_idx, (O,)).copy()
        obs = np.ctypeslib.as_array(data.obs, (O, 2)).copy()
        cams = np.ctypeslib.as_array(data.cameras, (C, 9)).copy()
        pts = np.ctypeslib.as_array(data.points, (P, 3)).copy()
    finally:
        lib.bal_free(ctypes.byref(data))
    return cams, pts, obs, cam_idx, pt_idx
