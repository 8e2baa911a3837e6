"""K5: band blocks of the consecutive-camera tracks.

Replaces the Pallas kernel ``tpu_ba/kernels/trackband.py:fused_track_blocks``.
For a tracked point with start camera c0 and slots a ≤ b the block
``W_a (V_p + λ·clip(diag V_p))⁻¹ W_bᵀ`` is added to band offset b−a at row
c0+a, giving ``(dmax·81, c_pad)``. The CUDA kernel
(``tpu_ba_torch/csrc/trackband.cu``) runs one block per band column over the
contiguous run of points that write it, read from ``layout.key_start``.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.pairblocks import block_products_rows, damped_vinv_rows
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t_plain


def fused_track_blocks_plain(Wt, Vt, lam, layout, *, dc: int = 9, diag_floor: float,
                             diag_ceil: float):
    """Plain PyTorch version of K5 (the reference's ``track_blocks_jnp``):
    per slot pair the products of all points, summed by start camera + a."""
    d2 = dc * dc
    Vinv = damped_vinv_rows(Vt, lam, diag_floor, diag_ceil)
    out = torch.zeros((layout.dmax * d2, layout.n_out), dtype=Wt.dtype, device=Wt.device)
    Wm = [Wt[:, a, :] * layout.slot_mask[a].to(Wt.dtype)[None, :] for a in range(layout.dmax)]
    for a in range(layout.dmax):
        keys = layout.keys + a
        for b in range(a, layout.dmax):
            vals = block_products_rows(Wm[a], Vinv, Wm[b], dc)
            off = b - a
            out[off * d2:(off + 1) * d2] += sorted_segment_sum_t_plain(vals, keys, layout.n_out)
    return out


def fused_track_blocks(Wt, Vt, lam, layout, *, dc: int = 9, diag_floor: float,
                       diag_ceil: float):
    """Band-row contributions (dmax·81, c_pad) of the tracked points at
    damping ``lam`` (a 0-dim tensor). Wt (27, dmax, Pt), Vt (9, Pt) from
    ``solver/tracks.py:gather_track_data``. A CPU tensor takes the plain
    version; a CUDA tensor launches K5."""
    if Wt.device.type == "cpu":
        return fused_track_blocks_plain(Wt, Vt, lam, layout, dc=dc, diag_floor=diag_floor,
                                        diag_ceil=diag_ceil)
    if dc != 9:
        raise ValueError(f"fused_track_blocks: the kernel takes 9-parameter cameras, got dc={dc}")
    if layout.key_start is None:
        raise ValueError("fused_track_blocks on CUDA needs layout.key_start "
                         "(build the layout with with_kernel_plans=True)")
    dev = Wt.device
    dmax, pt, c_pad = layout.dmax, layout.pt_pad, layout.n_out
    _lib.check_tensor("Wt", Wt, torch.float32, (27, dmax, pt), dev)
    _lib.check_tensor("Vt", Vt, torch.float32, (9, pt), dev)
    _lib.check_tensor("slot_mask", layout.slot_mask, torch.float32, (dmax, pt), dev)
    _lib.check_tensor("key_start", layout.key_start, torch.int32, (c_pad + 1,), dev)
    _lib.check_tensor("lam", lam, torch.float32, (), dev)
    lib = _lib.load_library()
    out = torch.empty((dmax * 81, c_pad), dtype=torch.float32, device=dev)
    status = lib.tba_track_blocks(Wt.data_ptr(), Vt.data_ptr(), layout.slot_mask.data_ptr(),
                                  layout.key_start.data_ptr(), lam.data_ptr(), out.data_ptr(),
                                  dmax, pt, c_pad, float(diag_floor), float(diag_ceil),
                                  _lib.stream_ptr(Wt))
    _lib.launches["trackband"] += 1
    _lib.check_status("trackband", status)
    return out
