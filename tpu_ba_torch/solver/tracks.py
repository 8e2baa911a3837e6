"""Track-major layout: band assembly for consecutive-camera tracks.

Counterpart of ``tpu_ba/solver/tracks.py``. The covisibility pairs of a
point whose cameras form a consecutive run are fixed by the run's start
camera c0 and length: the pair (slot a, slot b), a ≤ b, is exactly the band
block (offset b−a, row c0+a). So W is laid out track-major once per
linearization, one O-sized permutation gather into ``(27, dmax, Pt)`` slot
order, and the per-λ build (``tpu_ba_torch/kernels/trackband.py``) forms
every pair product from slices of it.

All planning is host numpy. In place of the reference's one-hot work list
(``plan``) the layout carries ``key_start``, the CSR starts of the sorted
start-camera ``keys``: the points that write band column c are the
contiguous run with keys in [c−dmax+1, c], which is all the CUDA kernel
needs. ``shard_track_layout`` gives one rank of a sharded solve its
contiguous run of the tracked points (the reference's
``shard_stack_track_layout`` and ``unstack_track_layout``: one process per
rank, so nothing is stacked).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ba_torch.core import _round_up, device_of, to_host

TRACK_ARRAYS = ("slot_idx", "slot_mask", "vperm", "keys")


@dataclasses.dataclass(frozen=True)
class TrackLayout:
    """Static track-major schedule for the band build.

    ``slot_idx[a, p]`` is the observation index of the a-th (camera-order)
    observation of tracked point p (points sorted by start camera);
    ``slot_mask[a, p]`` is 1.0 where a < track length (0.0 ⇒ the slot's W
    counts as zero); ``vperm[p]`` is the original point id (for the V
    gather); ``keys[p]`` is the start camera (ascending; padding points
    carry n_cameras−1 with an all-zero mask). ``key_start`` (n_out + 1) are
    the CSR starts of the real points' ``keys`` (the padding points lie past
    the last run, so the kernel never visits them; None ⇒ the plain version
    runs).
    """

    slot_idx: torch.Tensor    # (dmax, Pt_pad) int32
    slot_mask: torch.Tensor   # (dmax, Pt_pad) float32
    vperm: torch.Tensor       # (Pt_pad,) int32
    keys: torch.Tensor        # (Pt_pad,) int32, sorted
    key_start: torch.Tensor | None   # (n_out + 1,) int32
    dmax: int
    n_tracked: int
    pt_pad: int
    n_out: int                # c_pad, the width of one band row


def split_tracks(cam_idx, pt_idx, n_obs: int, n_points: int, *, dmax_cap: int = 8):
    """Classify points: tracked (consecutive cameras, length ≤ dmax_cap) or
    legacy. Returns (tracked_mask (P,), order, starts, deg): ``order`` sorts
    observations stably by point and ``starts``/``deg`` index each point's
    run in that order."""
    ci = to_host(cam_idx)[:n_obs].astype(np.int64)
    pi = to_host(pt_idx)[:n_obs].astype(np.int64)
    order = np.argsort(pi, kind="stable").astype(np.int64)
    deg = np.bincount(pi[order], minlength=n_points)
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
    # the span test below (cam_last − cam_first == deg−1 ⇔ consecutive) is
    # sound only when observations are camera-sorted within each point, which
    # the global camera sort of make_problem guarantees. Unsorted input (an
    # order like [1,3,2,4] would pass) tracks nothing.
    if ci.size and not np.all(np.diff(ci) >= 0):
        return np.zeros(n_points, bool), order, starts, deg
    cis = ci[order]
    has = deg > 0
    cam_first = np.zeros(n_points, np.int64)
    cam_last = np.zeros(n_points, np.int64)
    cam_first[has] = cis[starts[has]]
    cam_last[has] = cis[starts[has] + deg[has] - 1]
    # ascending cameras within a point: distinct cameras and span == deg−1
    # ⇔ consecutive (a repeated camera shrinks the span below deg−1)
    tracked = has & (deg <= dmax_cap) & (cam_last - cam_first == deg - 1)
    return tracked, order, starts, deg


def track_layout_from_numpy(arrays: dict, *, dmax: int, n_tracked: int, pt_pad: int,
                            n_out: int, with_kernel_plans: bool = True,
                            device=None) -> TrackLayout:
    """The port's TrackLayout from the reference's fields given as numpy
    arrays (``slot_idx, slot_mask, vperm, keys``) and ints."""
    device = device_of(None, device)
    keys = np.asarray(arrays["keys"]).astype(np.int64)
    if keys.size and np.any(np.diff(keys) < 0):
        raise ValueError("track keys must be sorted ascending")
    key_start = None
    if with_kernel_plans:
        key_start = torch.as_tensor(
            np.searchsorted(keys[:n_tracked], np.arange(n_out + 1),
                            side="left").astype(np.int32),
            device=device)
    return TrackLayout(
        slot_idx=torch.as_tensor(np.asarray(arrays["slot_idx"]).astype(np.int32), device=device),
        slot_mask=torch.as_tensor(np.asarray(arrays["slot_mask"]).astype(np.float32),
                                  device=device),
        vperm=torch.as_tensor(np.asarray(arrays["vperm"]).astype(np.int32), device=device),
        keys=torch.as_tensor(keys.astype(np.int32), device=device),
        key_start=key_start, dmax=int(dmax), n_tracked=int(n_tracked), pt_pad=int(pt_pad),
        n_out=int(n_out))


def build_track_layout(cam_idx, pt_idx, n_obs: int, n_cameras: int, n_points: int,
                       c_pad: int, *, dmax_cap: int = 8, tile: int = 2048,
                       with_kernel_plans: bool = True, device=None):
    """Build the TrackLayout (or None if no point is tracked). ``tile`` is
    the point-axis padding multiple, kept at the reference's value so both
    packages lay the same arrays out."""
    device = device_of(cam_idx, device)
    cam_idx, pt_idx = to_host(cam_idx), to_host(pt_idx)
    tracked, order, starts, deg = split_tracks(cam_idx, pt_idx, n_obs, n_points,
                                               dmax_cap=dmax_cap)
    ptids = np.nonzero(tracked)[0]
    if ptids.size == 0:
        return None
    ci = cam_idx[:n_obs].astype(np.int64)
    c0 = ci[order[starts[ptids]]]
    sort = np.argsort(c0, kind="stable")
    ptids = ptids[sort]
    c0 = c0[sort]
    d = deg[ptids]
    dmax = int(d.max())
    if n_cameras + dmax > c_pad:
        raise ValueError(f"c_pad {c_pad} too small for the key shift: need ≥ "
                         f"{n_cameras + dmax} (build the band grid with margin)")

    nt = int(ptids.size)
    pt_pad = _round_up(nt, tile)
    pad = pt_pad - nt
    slot_idx = np.zeros((dmax, pt_pad), np.int64)
    slot_mask = np.zeros((dmax, pt_pad), np.float32)
    base = starts[ptids]
    for a in range(dmax):
        ok = d > a
        slot_idx[a, :nt][ok] = order[base[ok] + a]
        slot_mask[a, :nt][ok] = 1.0
    keys = np.concatenate([c0, np.full(pad, n_cameras - 1, np.int64)])
    vperm = np.concatenate([ptids, np.zeros(pad, np.int64)])
    return track_layout_from_numpy(
        dict(slot_idx=slot_idx, slot_mask=slot_mask, vperm=vperm, keys=keys),
        dmax=dmax, n_tracked=nt, pt_pad=pt_pad, n_out=int(c_pad),
        with_kernel_plans=with_kernel_plans, device=device)


def shard_track_layout(layout: TrackLayout, n_dev: int, rank: int, *, tile: int = 2048,
                       with_kernel_plans: bool = True) -> TrackLayout:
    """Rank ``rank``'s part of a global layout split over ``n_dev`` ranks: the
    contiguous columns [rank·nd, (rank+1)·nd) of the start-sorted tracked
    points, nd = ceil(n_tracked / n_dev), padded to a multiple of ``tile``.
    The tracked points are sorted by start camera, so the part is a
    contiguous band-row range and its band partial sums with the other
    ranks' (and the pair blocks') in the sharded solve's one all-reduce.
    ``slot_idx`` keeps GLOBAL observation ids: the sharded solve gathers from
    the all-gathered W. The padding columns (mask 0) repeat the part's last
    key (or the layout's last, for an empty part), so the keys stay sorted;
    ``key_start`` covers the part's real columns, whose count is the part's
    ``n_tracked``."""
    nt = layout.n_tracked
    nd = -(-max(nt, 1) // n_dev)
    pt_pad = _round_up(nd, tile)
    lo, hi = rank * nd, min((rank + 1) * nd, nt)
    w = max(hi - lo, 0)
    keys = to_host(layout.keys)
    fill = int(keys[hi - 1]) if w else int(keys[max(nt - 1, 0)])

    def part(a):
        a = to_host(a)[..., lo:lo + w]
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pt_pad - w)])

    return track_layout_from_numpy(
        dict(slot_idx=part(layout.slot_idx), slot_mask=part(layout.slot_mask),
             vperm=part(layout.vperm),
             keys=np.concatenate([keys[lo:lo + w], np.full(pt_pad - w, fill, keys.dtype)])),
        dmax=layout.dmax, n_tracked=w, pt_pad=pt_pad, n_out=layout.n_out,
        with_kernel_plans=with_kernel_plans, device=layout.slot_idx.device)


def gather_track_data(W, V, layout: TrackLayout):
    """λ-free per-linearization pack: W into slot order (one O-sized
    permutation gather), V into start-sorted point order. Returns
    (Wt (27, dmax, Pt_pad), Vt (9, Pt_pad)), both contiguous."""
    Wt = W[:, layout.slot_idx]
    Vt = V[:, layout.vperm]
    return Wt, Vt
