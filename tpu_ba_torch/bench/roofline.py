"""Bytes and operations of the port's kernels, and the whole solve's roofline.

Counterpart of ``bench.py:_roofline``, with the bytes counted from the
port's own kernels (``tpu_ba_torch/csrc/``) and the plans they walk: each
input read once, each output written once, and the operations the work needs
on these inputs. ``chip_smoke.py`` takes each kernel's bound from here, and
each kernel's wrapper its bytes at each launch (``kernels/_lib.py:count``),
which ``tpu_ba_torch/bench/harness.py`` sums over a timed solve
(``solve_roofline``). The plain PyTorch glue between the kernels is not
counted. Nothing here reads a device tensor but the operation counts of K5,
K6 and K7 (their slot masks and pair keys).

The peaks are an H100's published ones (NVIDIA's H100 SXM data sheet, at its
700 W power limit): device memory at 3.35 TB/s, f32 at 67 TFLOP/s outside
the tensor cores. A card set below 700 W (``nvidia-smi`` ``power.limit``)
runs slower under load, so a share is stated beside that limit.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
F32 = 4


def bound(n_bytes, n_ops):
    """(least ms the card could take, what bounds it): the larger of the
    bytes moved over the memory rate and the operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def segsum_counts(rows: int, n_obs: int, n_out: int, perm: bool = False,
                  itemsize: int = F32):
    """K1's (bytes, operations) for one call, (rows, n_obs) → (rows, n_out)
    of values of ``itemsize`` bytes (4: f32, 8: f64): the values, the int32
    CSR starts and ``perm`` read once, the sums written once; one add a
    value. Its keys are not read: the starts name the segments."""
    index = (n_obs if perm else 0) + n_out + 1
    return itemsize * rows * (n_obs + n_out) + F32 * index, rows * n_obs


def lin_counts(n_cameras: int, n_points: int, n_obs: int, sched):
    """(K2's, K3's) (bytes, operations) for one call over ``sched``
    (``LinSchedule``): cameras, points, observations, point index, mask and
    the schedule read once; K2 writes U, gc and 40 rows an observation in
    about 600 operations each (projection, Jacobians, W/VtV/gp products, U/gc
    sums), K3 a scalar in about 100. K3 reads no camera index: its pieces
    name the camera."""
    C, P, O = n_cameras, n_points, n_obs
    n_pieces = sched.pieces.shape[1]
    inputs = F32 * (9 * C + 3 * P + 2 * O + O) + O
    k2_reads = inputs + F32 * (3 * n_pieces + C + 1 + sched.empty.shape[0])
    return ((k2_reads + F32 * (81 * C + 9 * C + 40 * O), 600 * O),
            (inputs + F32 * 3 * n_pieces + F32, 100 * O))


def _pair_ops(deg) -> float:
    """Operations of the damped products of points with ``deg`` slots (a
    tensor of slot counts): the 3×3 inverse (60), W_a·V⁻¹ for each slot (135)
    and a 9×9 block with its accumulation for each slot pair a ≤ b (486)."""
    return float((60 * (deg > 0) + 135 * deg + 486 * deg * (deg + 1) / 2).sum())


def pairblocks_bytes(n_pairs: int, n_out: int) -> int:
    """K7's bytes for one call of ``n_pairs`` packed pairs into ``n_out``
    segments: packed pairs, segment ids and λ read once, the (81, n_out)
    blocks written once."""
    return F32 * (63 * n_pairs + n_out + 1 + 1 + 81 * n_out)


def pairblocks_counts(plan):
    """K7's (bytes, operations) for one call on ``plan`` (``PairPlan``);
    681 operations a real pair (one slot pair of a point)."""
    C = plan.n_cameras
    n_real = int((plan.pair_key < C * C).sum())
    return pairblocks_bytes(plan.n_pairs, plan.k_pad), n_real * (60 + 135 + 486)


def trackband_bytes(layout) -> int:
    """K5's bytes for one call over the track layout ``layout``: W and the
    mask, V, key_start and λ read once; the band cells of its ``dmax``
    offsets read and written."""
    dmax, pt, c_pad = layout.dmax, layout.pt_pad, layout.n_out
    return F32 * ((27 + 1) * dmax * pt + 9 * pt + c_pad + 2 + 2 * 81 * dmax * c_pad)


def trackband_counts(plan):
    """K5's (bytes, operations) for one call on ``plan``."""
    return trackband_bytes(plan.track), _pair_ops(plan.track.slot_mask.sum(0))


def slotband_bytes(layout) -> list:
    """K6's bytes for each of its launches in one call over the slot layout
    ``layout``, one a degree bucket: the bucket's W, camera index and mask,
    V and incidence plan (``inc_start``, ``inc``) read once; the first
    launch also carries what the call reads and writes once, the offsets'
    index, λ and the band."""
    per = [F32 * ((27 + 2) * d * pk + 9 * pk + layout.c_pad + 1 + inc.numel())
           for d, pk, inc in zip(layout.degrees, layout.pt_pad, layout.inc)]
    per[0] += F32 * (layout.n_off_loc + 1 + 81 * layout.n_out)
    return per


def slotband_counts(plan):
    """K6's (bytes, operations) for one call on ``plan``, all its buckets."""
    sl = plan.slot
    return sum(slotband_bytes(sl)), sum(_pair_ops(m.sum(0)) for m in sl.slot_mask)


def _band_cells(plan) -> int:
    C = plan.n_cameras
    return sum(2 * max(C - o, 0) if o else C for o in plan.band_offsets)


def _band_bytes(plan) -> int:
    """The band's blocks, with the off-band leftover blocks and their lists
    where ``plan`` has them, and b, x0 and x: what either PCG kernel reads
    and writes once a call besides its diagonal blocks and preconditioner."""
    C = plan.n_cameras
    n_left = max(plan.n_segments - plan.k_band, 0)
    left = 81 * n_left + 2 * (C + 1) + 3 * n_left if n_left else 0
    return F32 * (81 * plan.k_band + left + 3 * 9 * C)


def pcg_band_bytes(plan) -> int:
    """K4's bytes for one call on ``plan``: the band, U_t, b, x0, λ and the
    tolerance read once, x written once. Once a call whatever its CG
    iterations: the resident form holds its slice of the band in shared
    memory for the whole solve; the streaming form's re-reads are its own
    cost, not the work's."""
    return _band_bytes(plan) + F32 * (81 * plan.c_pad + 2)


def pcg_band_counts(plan, iterations: int):
    """K4's (bytes, operations) for one call of ``iterations`` CG
    iterations: ``pcg_band_bytes``; per iteration a 9×9 product for each
    camera (U_λ, M⁻¹) and each valid band cell, forward and transposed, plus
    the vector updates; the prologue's 9×9 Gauss–Jordan."""
    C = plan.n_cameras
    n_ops = ((iterations + 1) * (162 * (_band_cells(plan) + 2 * C) + 12 * 9 * C)
             + 2 * 9 * 9 * 18 * C)
    return pcg_band_bytes(plan), n_ops


def pcg_band_given_bytes(plan, levels: int) -> int:
    """K8's bytes for one call with ``levels`` PCR levels (0: block-Jacobi
    with M⁻¹ given): K4's band and vectors, Ul, P, Q, D⁻¹ (or M⁻¹) as (C, 9,
    9) blocks and the tolerance read once, x written once."""
    return _band_bytes(plan) + F32 * (81 * plan.n_cameras * (2 + 2 * levels) + 1)


def pcg_band_given_counts(plan, levels: int, iterations: int):
    """K8's (bytes, operations) for one call of ``iterations`` CG
    iterations: ``pcg_band_given_bytes``; per iteration K4's products and,
    per PCR level, two 9×9 products a camera, then the last block
    diagonal."""
    C = plan.n_cameras
    n_ops = (iterations + 1) * (162 * (_band_cells(plan) + C) + 162 * C * (2 * levels + 1)
                                + 12 * 9 * C)
    return pcg_band_given_bytes(plan, levels), n_ops


def solve_roofline(bytes_by_kernel: dict, iterations: int, run_s: float,
                   power_limit_w) -> dict:
    """The whole solve's share of the memory roofline: the bytes its kernels
    must move (``_lib.bytes_moved`` over one timed solve: each wrapper adds
    its launch's bytes from this module's counts where it launches) over the
    published 3.35 TB/s, divided by the measured ``run_s``."""
    total = sum(bytes_by_kernel.values())
    return {
        "source": "tpu_ba_torch/bench/roofline.py counts, added by each kernel's wrapper at "
                  "each launch in one timed solve (kernels/_lib.py:bytes_moved): inputs read "
                  "once and outputs written once a launch, K4 and K8 once a call whatever "
                  "their CG iterations; the plain PyTorch glue between the kernels is not "
                  "counted",
        "bytes_by_kernel": bytes_by_kernel,
        "bytes_total": total,
        "bytes_per_lm_iter": total / max(iterations, 1),
        "achieved_gbps": total / run_s / 1e9,
        "peak_gbps": PEAK_BYTES_S / 1e9,
        "peak_source": "NVIDIA H100 SXM data sheet, at a 700 W power limit",
        "power_limit_w": power_limit_w,
        "share_of_peak": total / PEAK_BYTES_S / run_s,
    }
