"""K7: damped pair products reduced by compact covisibility segment.

Replaces the Pallas kernel ``tpu_ba/kernels/pairblocks.py:fused_pair_blocks``.
For every enumerated covisibility pair (i, j, p) the 9×9 block
``W_i (V_p + λ·clip(diag V_p))⁻¹ W_jᵀ`` is formed and summed by the pair's
sorted segment id into ``(81, n_out)``. The CUDA kernel
(``tpu_ba_torch/csrc/pairblocks.cu``) takes CSR segment starts in place of the
reference's one-hot work list; its pair products never reach memory.

Also here, shared by the plain versions of K5 and K6: the damped 3×3 inverse
and the per-column block product on lane-major rows.
"""

from __future__ import annotations

import torch

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


def fused_pair_blocks_plain(packed, pair_seg, lam, n_out: int, seg_start=None, *, dc: int = 9,
                            diag_floor: float, diag_ceil: float):
    """Plain PyTorch version of K7: the pair products written out, then a
    sorted segment sum. Padding pairs land in their trash segment
    ``n_out − 1``, which the caller zeroes."""
    Wi, Wj, V = packed[:3 * dc], packed[3 * dc:6 * dc], packed[6 * dc:6 * dc + 9]
    vals = block_products_rows(Wi, damped_vinv_rows(V, lam, diag_floor, diag_ceil), Wj, dc)
    return sorted_segment_sum_t_plain(vals, pair_seg, n_out)


def pair_group_log2(n_pairs: int, n_out: int) -> int:
    """log2 of the lanes per segment: the mean pairs per segment rounded up
    to a power of two between 1 and 32."""
    mean = n_pairs / max(n_out, 1)
    g = 0
    while g < 5 and (1 << g) < mean:
        g += 1
    return g


def fused_pair_blocks(packed, pair_seg, lam, n_out: int, seg_start=None, *, dc: int = 9,
                      diag_floor: float, diag_ceil: float):
    """blk (81, n_out) = Σ_pairs W_i V_λ⁻¹ W_jᵀ by compact segment id.

    ``packed`` (63, Np) is the λ-free pair gather of
    ``solver/pairs.py:precompute_pair_data``, ``pair_seg`` the sorted segment
    ids, ``lam`` a 0-dim tensor. A CPU tensor takes the plain version. A CUDA
    tensor launches K7, which walks ``seg_start`` (``n_out + 1`` int32 CSR
    starts of the real pairs: the padding pairs lie past the last run, so
    their trash segment comes out zero where the plain version sums them;
    the caller zeroes that column either way)."""
    if packed.device.type == "cpu":
        return fused_pair_blocks_plain(packed, pair_seg, lam, n_out, dc=dc,
                                       diag_floor=diag_floor, diag_ceil=diag_ceil)
    if dc != 9:
        raise ValueError(f"fused_pair_blocks: the kernel takes 9-parameter cameras, got dc={dc}")
    if seg_start is None:
        raise ValueError("fused_pair_blocks on CUDA needs seg_start "
                         "(build_pair_plan(..., with_kernel_plans=True))")
    dev = packed.device
    Np = packed.shape[1]
    _lib.check_tensor("packed", packed, torch.float32, (63, Np), dev)
    _lib.check_tensor("seg_start", seg_start, torch.int32, (n_out + 1,), dev)
    _lib.check_tensor("lam", lam, torch.float32, (), dev)
    lib = _lib.load_library()
    out = torch.empty((81, n_out), dtype=torch.float32, device=dev)
    status = lib.tba_pair_blocks(packed.data_ptr(), seg_start.data_ptr(), lam.data_ptr(),
                                 out.data_ptr(), Np, n_out, pair_group_log2(Np, n_out),
                                 float(diag_floor), float(diag_ceil), _lib.stream_ptr(packed))
    _lib.launches["pairblocks"] += 1
    _lib.check_status("pairblocks", status)
    return out
