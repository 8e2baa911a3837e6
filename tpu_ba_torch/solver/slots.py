"""Slot-major layout: band assembly for arbitrary short tracks.

Counterpart of ``tpu_ba/solver/slots.py``. The track-major path
(``solver/tracks.py``) covers points whose cameras form a consecutive run;
slot-major drops that requirement. Any point whose ascending camera set
spans ≤ SLOT_SPAN_CAP indices, has degree ≤ SLOT_DEG_CAP and distinct
cameras is packed into degree-bucketed dense slot arrays

    W_b (27, d, P_b)   cam_b (d, P_b)   V_b (9, P_b)

with one O-sized permutation gather per linearization; the per-λ build
forms every pair product W_a V_λ⁻¹ W_cᵀ from slices and adds it to band
cell (cam_a, cam_c − cam_a). Tracks and slots compose: consecutive points
keep the track path, slots take the remaining eligible points, enumerated
pairs the rest.

Bucket acceptance is behaviour, not plumbing: a bucket is accepted only if
some tile size keeps its tile-local grid within WIDTH_BUDGET, and that
decides which points leave the pair enumeration. So ``tiles``, ``widths``,
``tile_base``, ``l2_perm`` and ``l2_keys`` are computed as the reference
computes them (the plain version reduces through them, like the
reference's oracle). The reference's level-2 ``SegsumPlan`` is replaced by
what the CUDA kernel (``tpu_ba_torch/kernels/slotband.py``) needs: per
bucket the unmasked (point, slot) incidences listed band row by band row
(a CSR by the slot's camera), and the table from a local offset to its
band slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ba_torch.core import _round_up, device_of, to_host

SLOT_SPAN_CAP = 16    # max (cam_last − cam_first) of an eligible point
SLOT_DEG_CAP = 16     # max track length of an eligible point
WIDTH_BUDGET = 1280   # max tile-local grid width
TILE_OPTS = (2048, 1024, 512)

# degree-bucket upper edges: a point of degree d lands in the smallest
# bucket ≥ d (extra slots masked)
BUCKET_EDGES = (2, 3, 4, 5, 6, 8, 12, 16)


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Static slot-major schedule for the band build.

    Per accepted bucket k (degree edge d = degrees[k], tile size tiles[k],
    local width widths[k]):
      slot_idx[k]  (d, Pk)  observation index of slot a (points sorted by
                            start camera; padding points repeat the last)
      slot_cam[k]  (d, Pk)  camera id per slot (int32)
      slot_mask[k] (d, Pk)  1.0 where slot < true degree
      vperm[k]     (Pk,)    original point id (V gather)
      tile_base[k] (Tk,)    per-tile base row (min camera of the tile)
      inc_start[k] (c_pad+1,) CSR starts into inc[k] by band row (None ⇒
                            the plain version runs)
      inc[k]       (n_inc,) the unmasked incidences (p, a) as p·16 + a,
                            sorted by slot_cam[k][a, p], then by p
      spans[k]              max (camera − start camera) over the bucket
    Shared:
      n_off_loc    dense local offset count (SLOT_SPAN_CAP + 1)
      off_idx      (n_off_loc,) band slot of local offset o, −1 if none
      l2_perm      (L,) permutation of the concatenated tile grids into
                   global-band-key-sorted order
      l2_keys      (L,) sorted global keys (off_idx·c_pad + row; trash =
                   n_out for dead local cells)
      n_out        k_band
    """

    slot_idx: tuple
    slot_cam: tuple
    slot_mask: tuple
    vperm: tuple
    tile_base: tuple
    inc_start: tuple | None
    inc: tuple | None
    off_idx: torch.Tensor
    l2_perm: torch.Tensor
    l2_keys: torch.Tensor
    degrees: tuple
    tiles: tuple
    widths: tuple
    pt_pad: tuple
    spans: tuple
    n_off_loc: int
    n_tracked: int
    l2_len: int
    n_out: int
    c_pad: int


def slot_eligible(cam_idx, pt_idx, n_obs: int, n_points: int):
    """Classify points for the slot path. Returns (mask (P,), order, starts,
    deg, span): mask True where degree ≤ SLOT_DEG_CAP, camera span ≤
    SLOT_SPAN_CAP and all cameras distinct (duplicate (cam, pt)
    observations stay enumerated: the symmetric pair orientation relies on
    distinct cameras). Needs globally camera-sorted observations; otherwise
    nothing is eligible."""
    ci = to_host(cam_idx)[:n_obs].astype(np.int64)
    pi = to_host(pt_idx)[:n_obs].astype(np.int64)
    order = np.argsort(pi, kind="stable").astype(np.int64)
    deg = np.bincount(pi[order], minlength=n_points)
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
    if ci.size and not np.all(np.diff(ci) >= 0):
        return (np.zeros(n_points, bool), order, starts, deg, np.zeros(n_points, np.int64))
    cis = ci[order]
    has = deg > 0
    span = np.zeros(n_points, np.int64)
    dup = np.zeros(n_points, bool)
    for d in np.unique(deg):
        if d == 0:
            continue
        pts = np.nonzero(deg == d)[0]
        mat = cis[starts[pts][:, None] + np.arange(d)[None, :]]
        span[pts] = mat.max(axis=1) - mat.min(axis=1)
        if d > 1:
            dup[pts] = (np.diff(mat, axis=1) == 0).any(axis=1)
    ok = has & (deg <= SLOT_DEG_CAP) & (span <= SLOT_SPAN_CAP) & ~dup
    return ok, order, starts, deg, span


@dataclasses.dataclass
class SlotBuckets:
    """Host-side phase-a output: accepted bucket arrays (numpy), before the
    band layout (offsets, c_pad) is known."""

    accepted_pts: np.ndarray     # (P,) bool, the points the slot path owns
    degrees: list
    tiles: list
    widths: list
    sidx: list
    scam: list
    smask: list
    vperm: list
    tile_base: list
    pt_pad: list
    span_max: int
    n_tracked: int


def select_slot_buckets(cam_idx, pt_idx, n_obs: int, n_points: int, *,
                        elig=None, candidate_mask=None) -> SlotBuckets | None:
    """Phase a: bucket the slot-candidate points by degree and build the
    dense slot arrays. A bucket is accepted only if some tile size in
    TILE_OPTS keeps its tile-local width ≤ WIDTH_BUDGET; the points of a
    rejected bucket stay on the pair path."""
    if elig is None:
        elig = slot_eligible(cam_idx, pt_idx, n_obs, n_points)
    ok, order, starts, deg, span = elig
    if candidate_mask is not None:
        ok = ok & candidate_mask
    ptids_all = np.nonzero(ok)[0]
    if ptids_all.size == 0:
        return None
    ci = to_host(cam_idx)[:n_obs].astype(np.int64)
    n_off_loc = SLOT_SPAN_CAP + 1

    bidx = np.searchsorted(np.asarray(BUCKET_EDGES), deg[ptids_all])
    out = SlotBuckets(
        accepted_pts=np.zeros(n_points, bool), degrees=[], tiles=[], widths=[], sidx=[],
        scam=[], smask=[], vperm=[], tile_base=[], pt_pad=[], span_max=0, n_tracked=0)
    for k, d_edge in enumerate(BUCKET_EDGES):
        pts = ptids_all[bidx == k]
        if pts.size == 0:
            continue
        d = int(d_edge)
        c0 = ci[order[starts[pts]]]
        srt = np.argsort(c0, kind="stable")
        pts, c0 = pts[srt], c0[srt]
        nt = pts.size
        base = starts[pts]
        dp = deg[pts]
        cmax = np.zeros(nt, np.int64)      # row reach per point, for the width
        sidx = np.zeros((d, nt), np.int64)
        scam = np.zeros((d, nt), np.int64)
        smask = np.zeros((d, nt), np.float32)
        for a in range(d):
            have = dp > a
            rows = order[base[have] + a]
            sidx[a, have] = rows
            scam[a, have] = ci[rows]
            smask[a, have] = 1.0
            # masked slots reuse the point's first camera: keys stay in range
            # and the mask kills the contribution exactly
            sidx[a, ~have] = order[base[~have]]
            scam[a, ~have] = c0[~have]
            cmax = np.maximum(cmax, scam[a])
        tile_b = width_b = None
        for t in TILE_OPTS:
            pp = _round_up(nt, t)
            n_tiles = pp // t
            c0p = np.concatenate([c0, np.full(pp - nt, c0[-1])])
            cmaxp = np.concatenate([cmax, np.full(pp - nt, cmax[-1])])
            tb = c0p.reshape(n_tiles, t).min(axis=1)
            spread = cmaxp.reshape(n_tiles, t).max(axis=1) - tb + 1
            w = _round_up(int(spread.max()) * n_off_loc, 128)
            if w <= WIDTH_BUDGET:
                tile_b, width_b = t, w
                break
        if tile_b is None:
            continue                       # too sparse to localize: stays on pairs
        pp = _round_up(nt, tile_b)
        pad = pp - nt
        if pad:
            sidx = np.concatenate([sidx, np.broadcast_to(sidx[:, -1:], (d, pad))], axis=1)
            scam = np.concatenate([scam, np.broadcast_to(scam[:, -1:], (d, pad))], axis=1)
            smask = np.concatenate([smask, np.zeros((d, pad), np.float32)], axis=1)
        # slot 0 of a point is its minimum camera, so the minimum over slot 0
        # of a tile bounds every slot row of the tile from below
        tb = scam[0].reshape(pp // tile_b, tile_b).min(axis=1)
        out.accepted_pts[pts] = True
        out.degrees.append(d)
        out.tiles.append(tile_b)
        out.widths.append(width_b)
        out.sidx.append(sidx)
        out.scam.append(scam)
        out.smask.append(smask)
        out.vperm.append(np.concatenate([pts, np.zeros(pad, np.int64)]))
        out.tile_base.append(tb)
        out.pt_pad.append(pp)
        out.span_max = max(out.span_max, int(span[pts].max()))
        out.n_tracked += nt
    if not out.degrees:
        return None
    return out


def slot_incidences(scam, smask, c_pad: int):
    """The CSR K6 walks: (starts (c_pad + 1,), codes (n_inc,)) of a bucket's
    unmasked (point p, slot a) incidences, listed by the slot's camera (the
    band row) and within a row by ascending p, each coded p·16 + a."""
    d, pk = scam.shape
    if d > 16 or pk >= 1 << 27:
        raise ValueError(f"slot incidences: degree {d} or {pk} points do not fit p·16 + a in int32")
    a, p = np.nonzero(smask > 0)
    row = scam[a, p]
    order = np.lexsort((p, row))
    starts = np.searchsorted(row[order], np.arange(c_pad + 1), side="left")
    return starts, p[order] * 16 + a[order]


def slot_layout_from_numpy(arrays: dict, *, degrees, tiles, widths, pt_pad, n_off_loc: int,
                           n_tracked: int, l2_len: int, n_out: int, band_offsets: tuple,
                           c_pad: int, with_kernel_plans: bool = True,
                           device=None) -> SlotLayout:
    """The port's SlotLayout from the reference's fields given as numpy
    arrays (per-bucket sequences ``slot_idx, slot_cam, slot_mask, vperm,
    tile_base`` and ``l2_perm, l2_keys``) and ints, plus the band layout
    (``band_offsets``, ``c_pad``) it was finalized for."""
    device = device_of(None, device)

    def t(a, dt):
        return torch.as_tensor(np.asarray(a).astype(dt), device=device)

    off_idx = np.full(n_off_loc, -1, np.int64)
    for i, off in enumerate(band_offsets):
        if off < n_off_loc:
            off_idx[off] = i
    scams = [np.asarray(s).astype(np.int64) for s in arrays["slot_cam"]]
    smasks = [np.asarray(m) for m in arrays["slot_mask"]]
    inc_start = inc = None
    if with_kernel_plans:
        plans = [slot_incidences(s, m, c_pad) for s, m in zip(scams, smasks)]
        inc_start = tuple(t(st, np.int32) for st, _ in plans)
        inc = tuple(t(code, np.int32) for _, code in plans)
    spans = tuple(int(((s - s[0:1]) * (m > 0)).max()) if s.size else 0
                  for s, m in zip(scams, smasks))
    return SlotLayout(
        slot_idx=tuple(t(s, np.int32) for s in arrays["slot_idx"]),
        slot_cam=tuple(t(s, np.int32) for s in scams),
        slot_mask=tuple(t(m, np.float32) for m in smasks),
        vperm=tuple(t(v, np.int32) for v in arrays["vperm"]),
        tile_base=tuple(t(b, np.int32) for b in arrays["tile_base"]),
        inc_start=inc_start, inc=inc, off_idx=t(off_idx, np.int32),
        l2_perm=t(arrays["l2_perm"], np.int32), l2_keys=t(arrays["l2_keys"], np.int32),
        degrees=tuple(int(d) for d in degrees), tiles=tuple(int(x) for x in tiles),
        widths=tuple(int(w) for w in widths), pt_pad=tuple(int(p) for p in pt_pad),
        spans=spans, n_off_loc=int(n_off_loc), n_tracked=int(n_tracked), l2_len=int(l2_len),
        n_out=int(n_out), c_pad=int(c_pad))


def finalize_slot_layout(b: SlotBuckets, band_offsets: tuple, c_pad: int, *,
                         with_kernel_plans: bool = True, device=None) -> SlotLayout:
    """Phase b: the band keys of every tile-local cell, once the band layout
    is known. ``build_pair_plan`` protects offsets 0..span_max through the
    32-offset cap, so every slot offset has a band slot by construction."""
    n_off_loc = SLOT_SPAN_CAP + 1
    n_out = len(band_offsets) * c_pad
    off_to_idx = np.full(max(max(band_offsets), n_off_loc - 1) + 1, -1, np.int64)
    off_to_idx[np.asarray(band_offsets)] = np.arange(len(band_offsets))
    keys_parts = []
    for k in range(len(b.degrees)):
        width = b.widths[k]
        tb = b.tile_base[k]
        loc = np.arange(width)
        r_loc, off = loc // n_off_loc, loc % n_off_loc
        oi = off_to_idx[off]                               # −1 ⇒ no band slot
        row = tb[:, None] + r_loc[None, :]                 # (Tk, width)
        key = np.where((oi[None, :] >= 0) & (row < c_pad),
                       oi[None, :] * c_pad + row, n_out)   # trash = n_out
        keys_parts.append(key.reshape(-1))
    keys_flat = np.concatenate(keys_parts)
    L = keys_flat.shape[0]
    l2_perm = np.argsort(keys_flat, kind="stable")
    l2_keys = keys_flat[l2_perm]
    L_pad = _round_up(L, 1024)
    if L_pad != L:
        # padding columns repeat the last column under the trash key n_out ≥
        # every real key: sortedness holds and they reduce to the dropped
        # trash segment
        l2_perm = np.concatenate([l2_perm, np.full(L_pad - L, L - 1)])
        l2_keys = np.concatenate([l2_keys, np.full(L_pad - L, n_out)])
    return slot_layout_from_numpy(
        dict(slot_idx=b.sidx, slot_cam=b.scam, slot_mask=b.smask, vperm=b.vperm,
             tile_base=b.tile_base, l2_perm=l2_perm, l2_keys=l2_keys),
        degrees=b.degrees, tiles=b.tiles, widths=b.widths, pt_pad=b.pt_pad,
        n_off_loc=n_off_loc, n_tracked=b.n_tracked, l2_len=L_pad, n_out=n_out,
        band_offsets=band_offsets, c_pad=c_pad,
        with_kernel_plans=with_kernel_plans, device=device)


def gather_slot_data(W, V, layout: SlotLayout):
    """λ-free per-linearization pack: W into slot order (one O-sized
    permutation gather per bucket), V into start-sorted point order.
    Returns ([(27, d, Pk)], [(9, Pk)])."""
    Ws = [W[:, si] for si in layout.slot_idx]
    Vs = [V[:, vp] for vp in layout.vperm]
    return Ws, Vs
