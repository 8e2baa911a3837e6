"""K1: sorted segment sum, lane-major ``(D, O) → (D, n_out)``.

Replaces the Pallas kernel ``tpu_ba/kernels/segsum.py:sorted_segment_sum_t``.
The CUDA kernel (``tpu_ba_torch/csrc/segsum.cu``) takes CSR segment starts
(``n_out + 1`` int32, built once per problem in
``tpu_ba_torch/solver/plans.py``) in place of the reference's one-hot work
list. ``sorted_segment_sum_t_plain`` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.kernels import _lib


def sorted_segment_sum_t_plain(values_t, keys, n_out: int):
    """``out[:, k] = Σ_{o: keys[o]=k} values_t[:, o]``; empty segments 0.
    ``scatter_add_`` rather than ``index_add_(1, ...)``: the same sums, and on
    the CPU several times faster for (D, O) rows."""
    out = torch.zeros((values_t.shape[0], n_out), dtype=values_t.dtype,
                      device=values_t.device)
    return out.scatter_add_(1, keys.long().expand_as(values_t), values_t)


def group_log2(n_obs: int, n_out: int) -> int:
    """log2 of the lanes per segment: a quarter of the mean segment length,
    rounded up to a power of two between 1 and 32 (a warp). On an H100 at
    ladybug-1723 this picks 2 lanes for point segments (mean 4.3) and 32 for
    camera segments (mean 394); see PERF.md for the sweep over widths."""
    quarter = n_obs / max(n_out, 1) / 4.0
    g = 0
    while g < 5 and (1 << g) < quarter:
        g += 1
    return g


def sorted_segment_sum_t(values_t, keys, n_out: int, seg_start=None):
    """Segment sum of ``values_t`` (D, O) by sorted ``keys`` (O,) → (D, n_out).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel,
    which reads the segments from ``seg_start`` (``n_out + 1`` int32 CSR
    starts of the sorted keys); anything the kernel does not take raises."""
    if values_t.device.type == "cpu":
        return sorted_segment_sum_t_plain(values_t, keys, n_out)
    if seg_start is None:
        raise ValueError("sorted_segment_sum_t on CUDA needs seg_start (see solver/plans.py)")
    D, O = values_t.shape
    dev = values_t.device
    _lib.check_tensor("values_t", values_t, torch.float32, (D, O), dev)
    _lib.check_tensor("seg_start", seg_start, torch.int32, (n_out + 1,), dev)
    lib = _lib.load_library()
    out = torch.empty((D, n_out), dtype=torch.float32, device=dev)
    status = lib.tba_segsum_t(values_t.data_ptr(), seg_start.data_ptr(), out.data_ptr(),
                              D, O, n_out, group_log2(O, n_out), _lib.stream_ptr(values_t))
    _lib.launches["segsum"] += 1
    _lib.check_status("segsum", status)
    return out
