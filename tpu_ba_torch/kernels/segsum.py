"""K1: sorted segment sum, lane-major ``(D, O) → (D, n_out)``.

Replaces the Pallas kernel ``tpu_ba/kernels/segsum.py:sorted_segment_sum_t``.
The CUDA kernel (``tpu_ba_torch/csrc/segsum.cu``) takes CSR segment starts
(``n_out + 1`` int32, built once per problem in
``tpu_ba_torch/solver/plans.py``) in place of the reference's one-hot work
list, and can gather its input through a permutation as it reads
(``perm``). ``sorted_segment_sum_t_plain`` is its plain PyTorch version.

``segment_sum_t`` is the sum the solver takes where it has no plan (the
plain tiers, the SfM's windowed BA): on the card it launches K1 over starts
built on the device, so that no solve adds with atomics and every solve
repeats bit for bit.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.kernels import _lib


def sorted_segment_sum_t_plain(values_t, keys, n_out: int, perm=None):
    """``out[:, k] = Σ_{o: keys[o]=k} values_t[:, o]``; empty segments 0. With
    ``perm`` the values are gathered first: ``values_t[:, perm[o]]`` is summed
    under ``keys[o]``. ``scatter_add_`` rather than ``index_add_(1, ...)``:
    the same sums, and on the CPU several times faster for (D, O) rows."""
    if perm is not None:
        values_t = values_t[:, perm.long()]
    out = torch.zeros((values_t.shape[0], n_out), dtype=values_t.dtype,
                      device=values_t.device)
    return out.scatter_add_(1, keys.long().expand_as(values_t), values_t)


BLOCK_LOG2 = 7     # group_log2 of the schedule with 128 threads a segment (kBlockLog2 in segsum.cu)

# Fitted to the sweep on an H100 (scripts/torch_segsum_sweep.py, its lines
# for values read from device memory; PERF.md). Under lanes a call waits for
# its longest segment: each observation that a lane walks beyond the mean
# segment's share costs about 200 ns (a load's latency over the loop's unroll
# of four). A block a segment costs about 2.5 µs more than lanes do on even
# runs; 0.9 ns a task (segment × row tile) where that exceeds the time the
# bytes take at 2 bytes a picosecond; and through perm, where a block reads
# scalars, 2.3 ps a value.
_LANE_NS_PER_OBS = 200.0
_BLOCK_NS = 2500.0
_BLOCK_NS_PER_TASK = 0.9
_BLOCK_NS_PER_GATHERED = 0.0023
_BYTES_PER_NS = 2000.0
_FILL_THREADS = 648_806   # 2.4 × the threads an H100 keeps resident (132 SMs × 2048)

_fill_threads: dict = {}


def fill_threads(device) -> int:
    """2.4 × the threads ``device`` keeps resident, asked once per card."""
    key = torch.device(device).index
    if key not in _fill_threads:
        props = torch.cuda.get_device_properties(device)
        _fill_threads[key] = int(2.4 * props.multi_processor_count
                                 * props.max_threads_per_multi_processor)
    return _fill_threads[key]


def row_tile(n_rows: int) -> int:
    """Rows a task of the kernel covers: 3, 4, 2 or 1, the first that divides
    ``n_rows`` (``tba_segsum_t`` in segsum.cu)."""
    return next(r for r in (3, 4, 2, 1) if n_rows % r == 0)


def group_log2(n_obs: int, n_out: int, n_rows: int, longest: int | None = None,
               fill: int = _FILL_THREADS, gathered: bool = False) -> int:
    """The kernel's schedule: log2 of the lanes that share a segment (0 … 5),
    or ``BLOCK_LOG2`` for a block of 128 threads per segment.

    The lanes come from the mean segment length: a lane per 4 observations up
    to a warp, then more lanes until the grid (segments × row tiles × lanes)
    reaches ``fill`` threads (point segments, mean 4.3: two lanes each for
    the (12, O) sums in 4 row tiles, eight for the (3, O) sums in one).
    Under lanes a call lasts as long as its longest segment: with ``longest``
    (the longest segment's length, which the planners read off the CSR starts
    once, ``solver/plans.py:longest_segment``) the block schedule is taken
    where waiting for that segment would cost more than a block a segment
    does (more where the values are ``gathered`` through ``perm``), so even
    camera runs (ladybug-1723: 394, the longest 579) keep their warp and
    skewed ones get blocks. Without ``longest`` nothing is known of the skew,
    and every mean of 128 or more takes blocks: on even runs they lose at
    most 2.5×, lanes on skewed runs lose without limit."""
    mean = n_obs / max(n_out, 1)
    tasks = n_out * (n_rows // row_tile(n_rows)) if n_rows > 0 else 0
    g = 0
    while g < 5 and (4 << g) < mean:
        g += 1
    while g < 5 and 0 < (tasks << g) < fill:
        g += 1
    if longest is None:
        return BLOCK_LOG2 if mean >= 128 else g
    lanes_wait_ns = _LANE_NS_PER_OBS * max(longest - mean, 0.0) / (1 << g)
    values = float(n_rows) * n_obs
    blocks_ns = (_BLOCK_NS + max(_BLOCK_NS_PER_TASK * tasks - 4.0 * values / _BYTES_PER_NS, 0.0)
                 + (_BLOCK_NS_PER_GATHERED * values if gathered else 0.0))
    return BLOCK_LOG2 if lanes_wait_ns > blocks_ns else g


def sorted_segment_sum_t(values_t, keys, n_out: int, seg_start=None, perm=None,
                         schedule: int | None = None, longest: int | None = None):
    """Segment sum of ``values_t`` (D, O), f32 or f64, by sorted ``keys`` (O,)
    → (D, n_out).
    With ``perm`` ((O,) int32) the kernel gathers as it reads: the value summed
    under ``keys[o]`` is ``values_t[:, perm[o]]``, so values that lie in
    another order need no gathered copy.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel,
    which reads the segments from ``seg_start`` (``n_out + 1`` int32 CSR
    starts of the sorted keys); anything the kernel does not take raises.
    ``longest`` is the longest segment's length where the caller's plan knows
    it (``group_log2``); ``schedule`` overrides the rule (for sweeps and
    tests)."""
    if values_t.device.type == "cpu":
        return sorted_segment_sum_t_plain(values_t, keys, n_out, perm)
    if seg_start is None:
        raise ValueError("sorted_segment_sum_t on CUDA needs seg_start (see solver/plans.py)")
    D, O = values_t.shape
    dev, dt = values_t.device, values_t.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"values_t: dtype {dt}, the kernel takes float32 or float64")
    _lib.check_tensor("values_t", values_t, dt, (D, O), dev)
    _lib.check_tensor("seg_start", seg_start, torch.int32, (n_out + 1,), dev)
    if perm is not None:
        _lib.check_tensor("perm", perm, torch.int32, (O,), dev)
    lib = _lib.load_library()
    if schedule is None:
        schedule = group_log2(O, n_out, D, longest, fill_threads(dev), perm is not None)
    out = torch.empty((D, n_out), dtype=dt, device=dev)
    fn = lib.tba_segsum_t if dt == torch.float32 else lib.tba_segsum_t_f64
    status = fn(values_t.data_ptr(), None if perm is None else perm.data_ptr(),
                seg_start.data_ptr(), out.data_ptr(), D, O, n_out, int(schedule),
                _lib.stream_ptr(values_t))
    _lib.launches["segsum"] += 1
    _lib.check_status("segsum", status)
    return out


def segment_sum_t(values_t, keys, n_out: int, perm=None, *, sorted_keys: bool = False):
    """``sorted_segment_sum_t_plain``'s sum in a fixed order: what the solver
    calls where it has no plan. A CPU tensor takes the plain version. On a
    CUDA tensor (f32 or f64) K1 runs over CSR starts built on the device
    (``torch.searchsorted``); keys that are not known to be sorted
    (``sorted_keys`` False) are first put in order by a stable argsort, which
    K1 reads through as its ``perm``. Keys outside [0, n_out) are dropped."""
    if values_t.device.type == "cpu":
        return sorted_segment_sum_t_plain(values_t, keys, n_out, perm)
    if not sorted_keys:
        order = torch.argsort(keys, stable=True)
        keys = keys[order]
        perm = order if perm is None else perm.long()[order]
    keys = keys.contiguous()
    edges = torch.arange(n_out + 1, dtype=keys.dtype, device=keys.device)
    seg_start = torch.searchsorted(keys, edges, out_int32=True)
    return sorted_segment_sum_t(values_t.contiguous(), keys, n_out, seg_start,
                                perm=None if perm is None else perm.to(torch.int32))
