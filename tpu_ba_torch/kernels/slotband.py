"""K6: band blocks of the slot-major points (short tracks with gaps).

Replaces the Pallas kernel ``tpu_ba/kernels/slotband.py:fused_slot_blocks``
and the fold ``slot_band_blocks`` chains behind it. For a point of a degree
bucket and slots a ≤ b with cameras cam_a ≤ cam_b the block
``W_a (V_p + λ·clip(diag V_p))⁻¹ W_bᵀ`` is added to band cell
``off_idx[cam_b − cam_a]·c_pad + cam_a`` of the off-major ``(81, k_band)``
grid. The CUDA kernel (``tpu_ba_torch/csrc/slotband.cu``) accumulates straight
into the band, one launch per bucket and one block per band row over the
row's (point, slot) incidences (``layout.inc_start``, ``layout.inc``), where
the reference reduced into tile-local grids and folded those with a second,
host-sorted segment sum.
"""

from __future__ import annotations

import torch

from tpu_ba_torch.bench import roofline
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.pairblocks import block_products_rows, damped_vinv_rows
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t_plain


def slot_band_blocks_plain(Ws, Vs, lam, layout, *, dc: int = 9, diag_floor: float,
                           diag_ceil: float, segment_sum=sorted_segment_sum_t_plain):
    """Plain PyTorch version of K6 (the reference's ``slot_blocks_jnp``):
    per bucket and slot pair the products of all points, summed into
    tile-local grids, then folded into the band by the host-sorted keys.
    ``segment_sum`` (values, keys, n_out, perm) takes every sum: the solver
    passes ``segment_sum_t``, whose order is fixed on the card."""
    d2 = dc * dc
    parts = []
    for k, d in enumerate(layout.degrees):
        Wt, Vt = Ws[k], Vs[k]
        mask = layout.slot_mask[k].to(Wt.dtype)
        cam = layout.slot_cam[k].long()
        width, tile = layout.widths[k], layout.tiles[k]
        Vinv = damped_vinv_rows(Vt, lam, diag_floor, diag_ceil)
        Pk = Wt.shape[-1]
        n_tiles = Pk // tile
        base = torch.repeat_interleave(layout.tile_base[k].long(), tile)
        tix = torch.arange(Pk, device=Wt.device) // tile
        out_k = torch.zeros((d2, n_tiles * width), dtype=Wt.dtype, device=Wt.device)
        Wm = [Wt[:, a, :] * mask[a][None, :] for a in range(d)]
        for a in range(d):
            for b in range(a, d):
                vals = block_products_rows(Wm[a], Vinv, Wm[b], dc)
                # a masked pair may fall outside the tile grid; its value is
                # zero, so its key is clamped into range
                local = torch.clamp((cam[a] - base) * layout.n_off_loc + (cam[b] - cam[a]),
                                    0, width - 1)
                out_k += segment_sum(vals, tix * width + local, n_tiles * width)
        parts.append(out_k)
    l1 = torch.cat(parts, dim=1)
    l1 = torch.nn.functional.pad(l1, (0, layout.l2_len - l1.shape[1]))
    out = segment_sum(l1, layout.l2_keys, layout.n_out + 1, layout.l2_perm)
    return out[:, :layout.n_out]


def slot_band_blocks(Ws, Vs, lam, layout, *, dc: int = 9, diag_floor: float, diag_ceil: float,
                     out=None):
    """Band-grid contributions (81, k_band) of the slot-major points at
    damping ``lam`` (a 0-dim tensor). ``Ws``/``Vs`` from
    ``solver/slots.py:gather_slot_data``. With ``out`` (81, ≥ k_band), the
    band under assembly, the contributions are added to its first k_band
    columns in place and ``out`` is returned; without it they come in a
    fresh grid. CPU tensors take the plain version; CUDA tensors launch K6
    once per degree bucket."""
    n_out = layout.n_out
    if out is not None and (out.dim() != 2 or out.shape[0] != dc * dc or out.shape[1] < n_out):
        raise ValueError(f"slot_band_blocks: out of shape {tuple(out.shape)}, expected "
                         f"({dc * dc}, >= {n_out})")
    if Ws[0].device.type == "cpu":
        res = slot_band_blocks_plain(Ws, Vs, lam, layout, dc=dc, diag_floor=diag_floor,
                                     diag_ceil=diag_ceil)
        if out is None:
            return res
        out[:, :n_out] += res
        return out
    if dc != 9:
        raise ValueError(f"slot_band_blocks: the kernel takes 9-parameter cameras, got dc={dc}")
    if layout.inc_start is None:
        raise ValueError("slot_band_blocks on CUDA needs layout.inc_start and layout.inc "
                         "(build the layout with with_kernel_plans=True)")
    dev = Ws[0].device
    c_pad = layout.c_pad
    _lib.check_tensor("off_idx", layout.off_idx, torch.int32, (layout.n_off_loc,), dev)
    _lib.check_tensor("lam", lam, torch.float32, (), dev)
    for k, d in enumerate(layout.degrees):
        pk = layout.pt_pad[k]
        _lib.check_tensor(f"Ws[{k}]", Ws[k], torch.float32, (27, d, pk), dev)
        _lib.check_tensor(f"Vs[{k}]", Vs[k], torch.float32, (9, pk), dev)
        _lib.check_tensor(f"slot_cam[{k}]", layout.slot_cam[k], torch.int32, (d, pk), dev)
        _lib.check_tensor(f"slot_mask[{k}]", layout.slot_mask[k], torch.float32, (d, pk), dev)
        _lib.check_tensor(f"inc_start[{k}]", layout.inc_start[k], torch.int32, (c_pad + 1,), dev)
        _lib.check_tensor(f"inc[{k}]", layout.inc[k], torch.int32, tuple(layout.inc[k].shape), dev)
    if out is None:
        out = torch.zeros((81, n_out), dtype=torch.float32, device=dev)
    else:
        _lib.check_tensor("out", out, torch.float32, tuple(out.shape), dev)
    lib = _lib.load_library()
    n_bytes = roofline.slotband_bytes(layout)
    for k, d in enumerate(layout.degrees):
        status = lib.tba_slot_blocks(
            Ws[k].data_ptr(), layout.slot_cam[k].data_ptr(), layout.slot_mask[k].data_ptr(),
            Vs[k].data_ptr(), layout.inc_start[k].data_ptr(), layout.inc[k].data_ptr(),
            layout.off_idx.data_ptr(), lam.data_ptr(), out.data_ptr(), d, layout.pt_pad[k],
            c_pad, out.shape[1], float(diag_floor), float(diag_ceil), _lib.stream_ptr(out))
        _lib.count("slotband", n_bytes[k])
        _lib.check_status("slotband", status)
    return out
