"""K7: damped pair products reduced by compact covisibility segment.

Replaces the Pallas kernel ``tpu_ba/kernels/pairblocks.py:fused_pair_blocks``.
For every enumerated covisibility pair (i, j, p) the 9×9 block
``W_i (V_p + λ·clip(diag V_p))⁻¹ W_jᵀ`` is formed and summed by the pair's
sorted segment id into ``(81, n_out)``. The CUDA kernel
(``tpu_ba_torch/csrc/pairblocks.cu``) walks a schedule built once per
structure (``pair_schedule``) in place of the reference's one-hot work list:
the work is split by pairs, so no group walks a long segment alone; its pair
products never reach memory.

Also here, shared by the plain versions of K5 and K6: the damped 3×3 inverse
and the per-column block product on lane-major rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_ba_torch.bench import roofline
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t_plain
from tpu_ba_torch.solver.schur import inv3x3_rows


def damped_vinv_rows(V, lam, diag_floor: float, diag_ceil: float):
    """(V + λ·clip(diag V))⁻¹ per column of the lane-major V (9, N)."""
    Vl = V.clone()
    for a in range(3):
        Vl[4 * a] += lam * torch.clamp(V[4 * a], diag_floor, diag_ceil)
    return inv3x3_rows(Vl)


def block_products_rows(Wa, Vinv, Wb, dc: int):
    """Per column the block W_a · Vinv · W_bᵀ: Wa, Wb (3dc, N) rows 3m+a,
    Vinv (9, N) → (dc², N) rows dc·m+n."""
    N = Wa.shape[-1]
    M = torch.einsum("man,abn->mbn", Wa.reshape(dc, 3, N), Vinv.reshape(3, 3, N))
    return torch.einsum("mbn,kbn->mkn", M, Wb.reshape(dc, 3, N)).reshape(dc * dc, N)


def fused_pair_blocks_plain(packed, pair_seg, lam, n_out: int, sched=None, *, dc: int = 9,
                            diag_floor: float, diag_ceil: float):
    """Plain PyTorch version of K7: the pair products written out, then a
    sorted segment sum. Padding pairs land in their trash segment
    ``n_out − 1``, which the caller zeroes."""
    Wi, Wj, V = packed[:3 * dc], packed[3 * dc:6 * dc], packed[6 * dc:6 * dc + 9]
    vals = block_products_rows(Wi, damped_vinv_rows(V, lam, diag_floor, diag_ceil), Wj, dc)
    return sorted_segment_sum_t_plain(vals, pair_seg, n_out)


# K7's schedule (``pair_schedule``): no thread walks more than 8 pairs. A
# lane of a short segment's group walks at most SHORT_ITERS of its pairs, so a
# segment longer than G·SHORT_ITERS is split into pieces of PIECE_PAIRS
# consecutive pairs, each worked by a whole block of PIECE_THREADS threads
# (the kernel's block: two warps, so that a piece of a segment just past the
# cut leaves few threads idle). The pairs a thread are read off
# scripts/torch_pair_sweep.py (PERF.md §6): fewer run ladybug-1723's call
# faster and venice-1778-community's slower, which loses more a solve.
SHORT_ITERS = 8
PIECE_THREADS = 64
PIECE_PAIRS = SHORT_ITERS * PIECE_THREADS


class PairSchedule(NamedTuple):
    """K7's work list over the real pairs' segments, built once per
    structure by ``pair_schedule``. Every non-empty segment of at most
    ``cut`` pairs is a short item, worked by a group of 2^``group_log2``
    lanes; every longer one is split into pieces of ``PIECE_PAIRS``
    consecutive pairs (the last one shorter), each worked by a whole block,
    whose sums the fold adds in piece order; every empty one is written 0.
    All int32, segments ascending in each list."""

    group_log2: int
    cut: int                  # the longest short segment, G·SHORT_ITERS pairs
    longest: int              # pairs of the longest segment
    items: torch.Tensor       # (3, n_items): segment, first pair, end pair
    pieces: torch.Tensor      # (2, n_pieces): first pair, end pair, in pair order
    empty: torch.Tensor       # (n_empty,): the empty segments
    fold_seg: torch.Tensor    # (n_split,): the split segments
    fold_start: torch.Tensor  # (n_split + 1,): CSR starts of their pieces


def pair_schedule(seg_start, *, device=None, short_iters: int = SHORT_ITERS,
                  piece_pairs: int = PIECE_PAIRS) -> PairSchedule:
    """K7's schedule from ``seg_start`` (the real pairs' CSR starts, one per
    segment and one past the last). G is the median non-empty segment length
    rounded up to a power of two (at most 32): a median, so the few long
    segments do not move it, where a mean is pulled up by them (venice-1778's
    segments: median 3, mean 24)."""
    starts = np.asarray(seg_start, dtype=np.int64)
    lens = np.diff(starts)
    if lens.size and (lens.min() < 0 or starts[0] < 0):
        raise ValueError("seg_start must be non-decreasing from 0")
    nonempty = lens[lens > 0]
    g = 0
    if nonempty.size:
        med = float(np.median(nonempty))
        while g < 5 and (1 << g) < med:
            g += 1
    cut = (1 << g) * short_iters
    seg = np.flatnonzero((lens > 0) & (lens <= cut))
    items = np.stack([seg, starts[seg], starts[seg + 1]])
    fold_seg = np.flatnonzero(lens > cut)
    n_split = -(-lens[fold_seg] // piece_pairs)
    owner = np.repeat(fold_seg, n_split)                       # segment of each piece
    first = np.repeat(np.cumsum(n_split) - n_split, n_split)   # its first piece
    lo = starts[owner] + (np.arange(owner.size) - first) * piece_pairs
    pieces = np.stack([lo, np.minimum(lo + piece_pairs, starts[owner + 1])])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return PairSchedule(group_log2=g, cut=cut, longest=int(lens.max()) if lens.size else 0,
                        items=t(items.reshape(3, -1)), pieces=t(pieces.reshape(2, -1)),
                        empty=t(np.flatnonzero(lens == 0)), fold_seg=t(fold_seg),
                        fold_start=t(np.concatenate([[0], np.cumsum(n_split)])))


def fused_pair_blocks(packed, pair_seg, lam, n_out: int, sched: PairSchedule | None = None, *,
                      dc: int = 9, diag_floor: float, diag_ceil: float):
    """blk (81, n_out) = Σ_pairs W_i V_λ⁻¹ W_jᵀ by compact segment id.

    ``packed`` (63, Np) is the λ-free pair gather of
    ``solver/pairs.py:precompute_pair_data``, ``pair_seg`` the sorted segment
    ids, ``lam`` a 0-dim tensor. A CPU tensor takes the plain version. A CUDA
    tensor launches K7 over ``sched`` (``pair_schedule`` of the plan's real
    pairs, ``PairPlan.pair_sched``): the padding pairs lie past the last
    segment, so their trash segment comes out zero where the plain version
    sums them; the caller zeroes that column either way."""
    if packed.device.type == "cpu":
        return fused_pair_blocks_plain(packed, pair_seg, lam, n_out, dc=dc,
                                       diag_floor=diag_floor, diag_ceil=diag_ceil)
    if dc != 9:
        raise ValueError(f"fused_pair_blocks: the kernel takes 9-parameter cameras, got dc={dc}")
    if not isinstance(sched, PairSchedule):
        raise ValueError("fused_pair_blocks on CUDA needs the pair schedule "
                         "(build_pair_plan(..., with_kernel_plans=True): PairPlan.pair_sched)")
    dev = packed.device
    Np = packed.shape[1]
    n_items, n_pieces = sched.items.shape[1], sched.pieces.shape[1]
    n_empty, n_split = sched.empty.shape[0], sched.fold_seg.shape[0]
    if n_items + n_empty + n_split != n_out:
        raise ValueError(f"pair schedule of {n_items + n_empty + n_split} segments, "
                         f"expected {n_out}")
    _lib.check_tensor("packed", packed, torch.float32, (63, Np), dev)
    _lib.check_tensor("lam", lam, torch.float32, (), dev)
    _lib.check_tensor("items", sched.items, torch.int32, (3, n_items), dev)
    _lib.check_tensor("pieces", sched.pieces, torch.int32, (2, n_pieces), dev)
    _lib.check_tensor("empty", sched.empty, torch.int32, (n_empty,), dev)
    _lib.check_tensor("fold_seg", sched.fold_seg, torch.int32, (n_split,), dev)
    _lib.check_tensor("fold_start", sched.fold_start, torch.int32, (n_split + 1,), dev)
    lib = _lib.load_library()
    out = torch.empty((81, n_out), dtype=torch.float32, device=dev)
    partial = torch.empty((81, max(n_pieces, 1)), dtype=torch.float32, device=dev)
    status = lib.tba_pair_blocks(packed.data_ptr(), lam.data_ptr(), sched.items.data_ptr(),
                                 n_items, sched.pieces.data_ptr(), n_pieces,
                                 sched.empty.data_ptr(), n_empty, sched.fold_seg.data_ptr(),
                                 sched.fold_start.data_ptr(), n_split, partial.data_ptr(),
                                 out.data_ptr(), Np, n_out, sched.group_log2, float(diag_floor),
                                 float(diag_ceil), _lib.stream_ptr(packed))
    _lib.count("pairblocks", roofline.pairblocks_bytes(Np, n_out))
    _lib.check_status("pairblocks", status)
    return out
