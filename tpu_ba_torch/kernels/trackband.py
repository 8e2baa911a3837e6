"""K5: band blocks of the consecutive-camera tracks.

Replaces the Pallas kernel ``tpu_ba/kernels/trackband.py:fused_track_blocks``.
For a tracked point with start camera c0 and slots a ≤ b the block
``W_a (V_p + λ·clip(diag V_p))⁻¹ W_bᵀ`` is added to band offset b−a at row
c0+a, giving ``(dmax·81, c_pad)``, or added straight into the band under
assembly, whose first dmax offsets are 0..dmax−1. The CUDA kernel
(``tpu_ba_torch/csrc/trackband.cu``) runs one block per tile of 4 band rows
over the contiguous runs of points that write them, read from
``layout.key_start``, staging each point once per tile.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.bench import roofline
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.pairblocks import block_products_rows, damped_vinv_rows
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t_plain


def fused_track_blocks_plain(Wt, Vt, lam, layout, *, dc: int = 9, diag_floor: float,
                             diag_ceil: float, segment_sum=sorted_segment_sum_t_plain):
    """Plain PyTorch version of K5 (the reference's ``track_blocks_jnp``):
    per slot pair the products of all points, summed by start camera + a.
    ``segment_sum`` (values, keys, n_out) takes the sums: the solver passes
    ``segment_sum_t``, whose order is fixed on the card."""
    d2 = dc * dc
    Vinv = damped_vinv_rows(Vt, lam, diag_floor, diag_ceil)
    out = torch.zeros((layout.dmax * d2, layout.n_out), dtype=Wt.dtype, device=Wt.device)
    Wm = [Wt[:, a, :] * layout.slot_mask[a].to(Wt.dtype)[None, :] for a in range(layout.dmax)]
    for a in range(layout.dmax):
        keys = layout.keys + a
        for b in range(a, layout.dmax):
            vals = block_products_rows(Wm[a], Vinv, Wm[b], dc)
            off = b - a
            out[off * d2:(off + 1) * d2] += segment_sum(vals, keys, layout.n_out)
    return out


def fused_track_blocks(Wt, Vt, lam, layout, *, dc: int = 9, diag_floor: float,
                       diag_ceil: float, out=None):
    """Band-row contributions of the tracked points at damping ``lam`` (a
    0-dim tensor). Wt (27, dmax, Pt), Vt (9, Pt) from
    ``solver/tracks.py:gather_track_data``. Without ``out``: a fresh
    (dmax·81, c_pad), row g·81 + e holding entry e of band offset g. With
    ``out`` (81, ≥ dmax·c_pad), the band under assembly: cell (offset g,
    entry e, row r) is added to ``out[e, g·c_pad + r]`` in place and ``out``
    is returned. A CPU tensor takes the plain version; a CUDA tensor launches
    K5."""
    dmax, c_pad = layout.dmax, layout.n_out
    d2 = dc * dc
    if out is not None and (out.dim() != 2 or out.shape[0] != d2 or out.shape[1] < dmax * c_pad):
        raise ValueError(f"fused_track_blocks: out of shape {tuple(out.shape)}, expected "
                         f"({d2}, >= {dmax * c_pad})")
    if Wt.device.type == "cpu":
        res = fused_track_blocks_plain(Wt, Vt, lam, layout, dc=dc, diag_floor=diag_floor,
                                       diag_ceil=diag_ceil)
        if out is None:
            return res
        out[:, :dmax * c_pad] += res.reshape(dmax, d2, c_pad).transpose(0, 1).reshape(d2, -1)
        return out
    if dc != 9:
        raise ValueError(f"fused_track_blocks: the kernel takes 9-parameter cameras, got dc={dc}")
    if layout.key_start is None:
        raise ValueError("fused_track_blocks on CUDA needs layout.key_start "
                         "(build the layout with with_kernel_plans=True)")
    dev = Wt.device
    pt = layout.pt_pad
    _lib.check_tensor("Wt", Wt, torch.float32, (27, dmax, pt), dev)
    _lib.check_tensor("Vt", Vt, torch.float32, (9, pt), dev)
    _lib.check_tensor("slot_mask", layout.slot_mask, torch.float32, (dmax, pt), dev)
    _lib.check_tensor("key_start", layout.key_start, torch.int32, (c_pad + 1,), dev)
    _lib.check_tensor("lam", lam, torch.float32, (), dev)
    grid = out
    if grid is None:
        grid = torch.zeros((81, dmax * c_pad), dtype=torch.float32, device=dev)
    else:
        _lib.check_tensor("out", out, torch.float32, tuple(out.shape), dev)
    lib = _lib.load_library()
    status = lib.tba_track_blocks(Wt.data_ptr(), Vt.data_ptr(), layout.slot_mask.data_ptr(),
                                  layout.key_start.data_ptr(), lam.data_ptr(), grid.data_ptr(),
                                  dmax, pt, c_pad, grid.shape[1], float(diag_floor),
                                  float(diag_ceil), _lib.stream_ptr(Wt))
    _lib.count("trackband", roofline.trackband_bytes(layout))
    _lib.check_status("trackband", status)
    if out is not None:
        return out
    return grid.reshape(81, dmax, c_pad).transpose(0, 1).reshape(dmax * 81, c_pad)
