"""Checkpoint / resume for the LM optimizer.

Counterpart of ``tpu_ba/checkpoint/state.py``, in its format: a directory
holding ``state.safetensors`` (tensors ``cameras``, ``points`` and
``extra.<k>`` for array extras) and ``manifest.json`` (``iteration``,
``lam``, ``cost``, ``format_version: 1`` and ``extra.<k>`` for the other
extras). Both files are written under a temporary name and then renamed, so
a process killed mid-dump leaves the previous complete checkpoint. A
checkpoint written by either package loads in the other.

The safetensors layout is read and written here with numpy alone: an 8-byte
little-endian header length, a JSON header (``dtype``, ``shape``,
``data_offsets`` per tensor) padded with spaces to 8 bytes, then the raw
little-endian bytes, laid out by descending dtype and then by name, as the
``safetensors`` package lays them out. Tensors on any device are copied to
the host before writing; loading returns numpy.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from tpu_ba_torch.core import to_host

# safetensors dtype codes, in the order the format ranks them (a tensor of a
# later code is laid out first)
_DTYPES = {"BOOL": np.dtype(np.bool_), "I32": np.dtype("<i4"), "F32": np.dtype("<f4"),
           "F64": np.dtype("<f8"), "I64": np.dtype("<i8")}
_RANK = {code: i for i, code in enumerate(_DTYPES)}
_CODES = {dt: code for code, dt in _DTYPES.items()}


def safetensors_bytes(tensors: dict) -> bytes:
    """``tensors`` (name → array-like) in the safetensors layout."""
    arrays = {}
    for name, v in tensors.items():
        a = to_host(v)
        code = _CODES.get(a.dtype.newbyteorder("<"))
        if code is None:
            raise TypeError(f"{name}: dtype {a.dtype} is not one of {sorted(_DTYPES)}")
        arrays[name] = (code, np.asarray(a, dtype=_DTYPES[code]))
    order = sorted(arrays, key=lambda n: (-_RANK[arrays[n][0]], n))
    header, chunks, off = {}, [], 0
    for name in order:
        code, a = arrays[name]
        data = a.tobytes()
        header[name] = {"dtype": code, "shape": list(a.shape),
                        "data_offsets": [off, off + len(data)]}
        chunks.append(data)
        off += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    return struct.pack("<Q", len(head)) + head + b"".join(chunks)


def safetensors_arrays(buf: bytes) -> dict:
    """The tensors of a safetensors byte string, as writable numpy arrays."""
    if len(buf) < 8:
        raise ValueError("not a safetensors file: shorter than its header length")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > len(buf) - 8:
        raise ValueError(f"safetensors header of {n} bytes in a file of {len(buf)}")
    header = json.loads(buf[8:8 + n])
    body = memoryview(buf)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _DTYPES.get(info["dtype"])
        if dt is None:
            raise TypeError(f"{name}: dtype {info['dtype']} is not one of {sorted(_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not (0 <= begin <= end <= len(body)) or end - begin != dt.itemsize * int(
                np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{name}: data_offsets {info['data_offsets']} do not hold "
                             f"{info['dtype']}{list(shape)} in {len(body)} bytes")
        out[name] = np.frombuffer(body[begin:end], dtype=dt).reshape(shape).copy()
    return out


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


def save_checkpoint(path: str, *, cameras, points, lam=None, iteration=0,
                    cost=None, extra: dict | None = None) -> None:
    """Write optimizer state. ``path`` is a directory. An extra that is a
    numpy array or a tensor goes into the safetensors file, any other into
    the manifest."""
    os.makedirs(path, exist_ok=True)
    tensors = {"cameras": cameras, "points": points}
    manifest = {
        "iteration": int(iteration),
        "lam": float(lam) if lam is not None else None,
        "cost": float(cost) if cost is not None else None,
        "format_version": 1,
    }
    for k, v in (extra or {}).items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            tensors[f"extra.{k}"] = v
        else:
            manifest[f"extra.{k}"] = v
    # each file replaced whole, the manifest last: a kill mid-dump leaves no
    # torn file
    _write_atomic(os.path.join(path, "state.safetensors"), safetensors_bytes(tensors))
    _write_atomic(os.path.join(path, "manifest.json"),
                  json.dumps(manifest, indent=1).encode())


def load_checkpoint(path: str) -> dict:
    """Load optimizer state → the manifest's fields, ``cameras`` and
    ``points`` (numpy) and ``extra_tensors`` (name → numpy)."""
    with open(os.path.join(path, "state.safetensors"), "rb") as fh:
        tensors = safetensors_arrays(fh.read())
    with open(os.path.join(path, "manifest.json")) as fh:
        out = json.load(fh)
    out["cameras"] = tensors["cameras"]
    out["points"] = tensors["points"]
    out["extra_tensors"] = {k[6:]: v for k, v in tensors.items() if k.startswith("extra.")}
    return out
