"""Block-sparse explicit Schur complement via a static covisibility-pair plan.

Counterpart of ``tpu_ba/solver/pairs.py``. The reduced camera system
S = U_λ − W V_λ⁻¹ Wᵀ is kept as its nonzero 9×9 blocks: a host-built plan
enumerates, for every point and every pair (i, j) of its observations, the
contribution W_i V_λ,p⁻¹ W_jᵀ to camera block (cam_i, cam_j). All λ-dependent
work then happens in pair space with no gathers:

  per linearization (λ-free): gather W and V into pair, track and slot order
      (``precompute_pair_data``);
  per λ-retry: damp and invert the 3×3 point blocks in place, form the pair
      products, reduce them into the compact blocks (``_compact_blocks``:
      K7 for enumerated pairs, K5 for consecutive tracks, K6 for short
      tracks with gaps), then PCG on the blocks (``solve_schur_sparse``):
      on a banded plan the whole solve in one kernel when the kernel is asked
      for (K4 with the block-Jacobi preconditioner, K8 with the
      block-tridiagonal one of ``solver/tridiag.py``), else the host loop of
      ``solver/pcg.py`` over ``make_banded_matvec``; on a non-banded plan
      the host loop over the generic compact matvec (gather, block·vector,
      K1 by row camera, and the transposed pass by column camera).

With ``symmetric=True`` only the ci ≤ cj half is stored; ``banded`` lays the
first ``k_band`` segments out as a dense (offset, camera) grid, segment
o·c_pad + c holding block T_{c, c+band_offsets[o]}. Points whose track
exceeds ``max_degree`` are not pair-enumerated: their term of S is applied
matrix-free (``_heavy_operator``). A non-symmetric plan also serves the dense
reduced system (``build_schur_t``, ``solve_schur_dense``).

The planning is host numpy and follows the reference branch for branch, so
the structure can be held against it array for array.

Sharded (``group``): ``shard_pair_plan`` gives each rank a contiguous slice
of the seg-sorted pairs and its part of the track layout; each rank reduces
its slice into the full compact segment space, and ONE all-reduce of the
(dc², k_pad) blocks per λ-retry replicates S, after which the CG runs on
every rank with no communication (the reference's keyframe partition).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpu_ba_torch.core import _round_up, device_of, to_host
from tpu_ba_torch.kernels.pairblocks import (PairSchedule, block_products_rows,
                                             damped_vinv_rows, fused_pair_blocks, pair_schedule)
from tpu_ba_torch.kernels.pcg_band import pcg_banded
from tpu_ba_torch.kernels.segsum import segment_sum_t, sorted_segment_sum_t
from tpu_ba_torch.kernels.slotband import slot_band_blocks, slot_band_blocks_plain
from tpu_ba_torch.kernels.trackband import fused_track_blocks, fused_track_blocks_plain
from tpu_ba_torch.solver import slots as slots_mod
from tpu_ba_torch.solver import tracks as tracks_mod
from tpu_ba_torch.solver.batched_linalg import inv_spd_small
from tpu_ba_torch.solver.collective import all_reduce
from tpu_ba_torch.solver.normal import BlockSystem, damp_blocks
from tpu_ba_torch.solver.pcg import pcg
from tpu_ba_torch.solver.plans import longest_segment
from tpu_ba_torch.solver.schur import (_matmul_rows_33, _w_dot, _wt_dot, back_substitute,
                                       inv3x3_rows, schur_rhs, w_vinv_wt_diag)
from tpu_ba_torch.solver.tridiag import pcr_apply, pcr_factor, tridiag_from_band

PAIR_ARRAYS = ("pair_i", "pair_j", "pair_pt", "pair_key", "pair_seg", "seg_ci", "seg_cj",
               "diag_pos", "heavy_obs", "heavy_cam", "heavy_seg", "heavy_pt_ids")
PAIR_OPTIONAL_ARRAYS = ("seg_perm_cj", "cj_keys", "nondiag")
PAIR_META = ("n_pairs", "n_cameras", "max_degree", "n_segments", "k_pad", "n_heavy_obs",
             "n_heavy_pts", "symmetric", "banded", "band_offsets", "c_pad", "k_band")


class LeftoverLists(NamedTuple):
    """The off-band leftover segments of a capped band (compact segments
    k_band … n_segments−1, numbered from 0 here), as the PCG kernel walks
    them: by row camera in segment order, and by column camera through a
    stable permutation. All int32."""

    row_start: torch.Tensor  # (C+1,) CSR starts by row camera ci
    row_cj: torch.Tensor     # (L,) column camera of each leftover segment
    col_start: torch.Tensor  # (C+1,) CSR starts by column camera cj
    col_seg: torch.Tensor    # (L,) leftover segments in cj-sorted order
    col_ci: torch.Tensor     # (L,) their row cameras


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """Static covisibility-pair schedule, tensors on one device.

    Padding pairs carry key == C² and segment k_pad−1 (a trash segment the
    caller zeroes after the reduction). ``pair_seg`` maps each pair to its
    compact segment (ascending); ``seg_ci``/``seg_cj`` give each segment's
    camera pair (padding segments carry ci == C); ``diag_pos`` locates camera
    c's (c, c) block. ``seg_start`` (k_pad + 1 int32, the CSR starts of the
    real pairs' ``pair_seg``; None ⇒ the plain versions run) and
    ``pair_sched``, the pair kernel's schedule built from it, take the place
    of the reference's ``seg_plan``. With them come,
    on a non-banded plan, ``ci_start`` / ``cj_start`` (C + 2 CSR starts of
    ``seg_ci`` and ``cj_keys``, keys 0 … C) for K1 in the compact matvec, in
    place of the reference's ``ci_plan`` / ``cj_plan``, and ``ci_longest`` /
    ``cj_longest``, the longest segment of each (K1 picks its schedule from
    it); on a banded plan with leftover segments, ``left``. ``shard`` is
    (rank, world) on a rank's part of a plan (``shard_pair_plan``), whose
    pair arrays and ``n_pairs`` are its slice and whose track layout is its
    part; every other field is the global plan's.
    """

    pair_i: torch.Tensor     # (Np,) int32, observation of the row side
    pair_j: torch.Tensor     # (Np,) int32, observation of the column side
    pair_pt: torch.Tensor    # (Np,) int32, the shared point
    pair_key: torch.Tensor   # (Np,) int32, ci·C + cj; C² on padding
    pair_seg: torch.Tensor   # (Np,) int32, compact segment id, ascending
    seg_ci: torch.Tensor     # (k_pad,) int32, row camera per segment; C on pad
    seg_cj: torch.Tensor     # (k_pad,) int32, column camera per segment; 0 on pad
    diag_pos: torch.Tensor   # (C,) int32, segment of block (c, c); k_pad−1 if absent
    # points whose track exceeds max_degree are not pair-enumerated
    heavy_obs: torch.Tensor     # (Oh,) int32
    heavy_cam: torch.Tensor     # (Oh,) int32
    heavy_seg: torch.Tensor     # (Oh,) int32
    heavy_pt_ids: torch.Tensor  # (Ph,) int32
    n_pairs: int             # padded pair count
    n_cameras: int
    max_degree: int
    n_segments: int          # K, the true number of covisible camera pairs
    k_pad: int               # padded segment count
    n_heavy_obs: int
    n_heavy_pts: int
    seg_start: torch.Tensor | None = None
    pair_sched: PairSchedule | None = None
    symmetric: bool = False
    seg_perm_cj: torch.Tensor | None = None   # (k_pad,) permutation: cj-sorted
    cj_keys: torch.Tensor | None = None       # (k_pad,) seg_cj[perm]; C on padding
    nondiag: torch.Tensor | None = None       # (k_pad,) 1.0 off-diagonal, 0.0 diagonal
    banded: bool = False
    band_offsets: tuple = ()    # ascending, band_offsets[0] == 0 when banded
    band_offsets_t: torch.Tensor | None = None   # the same, (n_off,) int32 on the device
    c_pad: int = 0              # camera padding of the band grid
    k_band: int = 0             # len(band_offsets) · c_pad
    track: tracks_mod.TrackLayout | None = None
    slot: slots_mod.SlotLayout | None = None
    ci_start: torch.Tensor | None = None
    cj_start: torch.Tensor | None = None
    ci_longest: int | None = None
    cj_longest: int | None = None
    left: LeftoverLists | None = None
    shard: tuple = ()           # (rank, world) of a rank's part (shard_pair_plan)


def _leftover_lists(seg_ci: np.ndarray, seg_cj: np.ndarray, n_cameras: int):
    """The five arrays of ``LeftoverLists`` from the leftover segments' camera
    pairs (sorted by row camera, as the planner emits them)."""
    if seg_ci.size and np.any(np.diff(seg_ci) < 0):
        raise ValueError("leftover segments must be sorted by row camera")
    edges = np.arange(n_cameras + 1)
    perm = np.argsort(seg_cj, kind="stable")
    return (np.searchsorted(seg_ci, edges, side="left"), seg_cj,
            np.searchsorted(seg_cj[perm], edges, side="left"), perm, seg_ci[perm])


def pair_plan_from_numpy(arrays: dict, *, track=None, slot=None, with_kernel_plans: bool = False,
                         device=None, **meta) -> PairPlan:
    """The port's PairPlan from the reference's fields given as numpy arrays
    (``PAIR_ARRAYS``, optionally ``PAIR_OPTIONAL_ARRAYS``) and the ints,
    bools and ``band_offsets`` tuple of ``PAIR_META``; ``track`` and
    ``slot`` are the port's layouts or None."""
    device = device_of(None, device)

    def t(a, dt=np.int32):
        return torch.as_tensor(np.asarray(a).astype(dt), device=device)

    missing = [k for k in PAIR_ARRAYS if k not in arrays] + [k for k in PAIR_META if k not in meta]
    if missing:
        raise KeyError(f"pair plan fields missing: {missing}")
    seg = np.asarray(arrays["pair_seg"]).astype(np.int64)
    if seg.size and np.any(np.diff(seg) < 0):
        raise ValueError("pair_seg must be sorted ascending")
    C, k_pad = int(meta["n_cameras"]), int(meta["k_pad"])
    band_offsets = tuple(int(o) for o in meta["band_offsets"])
    opt = {k: arrays.get(k) for k in PAIR_OPTIONAL_ARRAYS}
    seg_start = pair_sched = ci_start = cj_start = ci_longest = cj_longest = left = None
    if with_kernel_plans:
        n_real = int((np.asarray(arrays["pair_key"]).astype(np.int64) < C * C).sum())
        starts = np.searchsorted(seg[:n_real], np.arange(k_pad + 1), side="left")
        seg_start, pair_sched = t(starts), pair_schedule(starts, device=device)
        seg_ci = np.asarray(arrays["seg_ci"]).astype(np.int64)
        seg_cj = np.asarray(arrays["seg_cj"]).astype(np.int64)
        k_band, K = int(meta["k_band"]), int(meta["n_segments"])
        if not meta["banded"]:
            if np.any(np.diff(seg_ci) < 0):
                raise ValueError("seg_ci of a non-banded plan must be sorted ascending")
            starts = np.searchsorted(seg_ci, np.arange(C + 2), side="left")
            ci_start, ci_longest = t(starts), longest_segment(starts)
            if opt["cj_keys"] is not None:
                starts = np.searchsorted(np.asarray(opt["cj_keys"]).astype(np.int64),
                                         np.arange(C + 2), side="left")
                cj_start, cj_longest = t(starts), longest_segment(starts)
        elif K > k_band:
            left = LeftoverLists(*[t(a) for a in _leftover_lists(seg_ci[k_band:K],
                                                                 seg_cj[k_band:K], C)])
    return PairPlan(
        **{k: t(arrays[k]) for k in PAIR_ARRAYS},
        n_pairs=int(meta["n_pairs"]), n_cameras=C, max_degree=int(meta["max_degree"]),
        n_segments=int(meta["n_segments"]), k_pad=k_pad, n_heavy_obs=int(meta["n_heavy_obs"]),
        n_heavy_pts=int(meta["n_heavy_pts"]), seg_start=seg_start, pair_sched=pair_sched,
        symmetric=bool(meta["symmetric"]),
        seg_perm_cj=None if opt["seg_perm_cj"] is None else t(opt["seg_perm_cj"]),
        cj_keys=None if opt["cj_keys"] is None else t(opt["cj_keys"]),
        nondiag=None if opt["nondiag"] is None else t(opt["nondiag"], np.float32),
        banded=bool(meta["banded"]), band_offsets=band_offsets,
        band_offsets_t=t(np.asarray(band_offsets, np.int64)) if band_offsets else None,
        c_pad=int(meta["c_pad"]), k_band=int(meta["k_band"]), track=track, slot=slot,
        ci_start=ci_start, cj_start=cj_start, ci_longest=ci_longest, cj_longest=cj_longest,
        left=left)


def build_pair_plan(cam_idx, pt_idx, n_obs: int, n_cameras: int, n_points: int, *,
                    max_degree: int = 64, pad_multiple: int = 2048,
                    with_kernel_plans: bool = False, symmetric: bool = False,
                    banded: bool = True, tracks: bool | None = None,
                    slots: bool | None = None, device=None) -> PairPlan:
    """Host-side plan: enumerate observation pairs sharing a point, sorted by
    camera-pair key. Points whose track exceeds ``max_degree`` are split off
    as *heavy* (recorded, not enumerated; ``_heavy_operator`` applies them).

    ``symmetric`` enumerates only the ci ≤ cj half. ``banded`` (symmetric
    only) lays the segments out as a dense (offset, ci) grid when the band
    would cover most pairs. ``tracks``/``slots`` hand the consecutive and the
    short gapped tracks to their own layouts (``solver/tracks.py``,
    ``solver/slots.py``) instead of enumerating them. ``with_kernel_plans``
    also builds what the CUDA kernels walk (CSR starts of the pairs and the
    pair kernel's schedule, CSR starts of the compact matvec's keys, of a
    capped band's leftovers). The plan's tensors
    live on ``device`` (default: that of ``cam_idx``)."""
    device = device_of(cam_idx, device)
    cam_idx, pt_idx = to_host(cam_idx), to_host(pt_idx)
    ci = cam_idx[:n_obs].astype(np.int64)
    pi = pt_idx[:n_obs].astype(np.int64)

    order = np.argsort(pi, kind="stable").astype(np.int64)
    pi_sorted = pi[order]
    deg = np.bincount(pi_sorted, minlength=n_points)
    dmax = int(deg.max()) if deg.size else 0
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]

    # track-major split: points whose cameras form a consecutive run skip
    # pair enumeration; zeroing their degree removes them from both the heavy
    # set and the pair loop
    if tracks is None:
        tracks = bool(symmetric and banded)
    # an explicit slots=True engages regardless of size; the default applies
    # a minimum so tiny problems keep to pairs
    slot_min = 0 if slots is True else 4096
    if slots is None:
        slots = tracks      # tracks=False is the "pure pair enumeration" switch
    trk_mask = None
    trk_dmax = 0
    covered_obs = 0
    if tracks and symmetric and banded:
        tm, _, _, _ = tracks_mod.split_tracks(cam_idx, pt_idx, n_obs, n_points)
        # a handful of coincidentally consecutive tracks on an unstructured
        # problem must not force the banded layout: engage from 5% of the
        # observations
        trk_obs = int(deg[tm].sum()) if tm.any() else 0
        trk_min = int(0.05 * max(n_obs, 1))
        if tm.any() and trk_obs >= max(trk_min, 1):
            trk_mask = tm
            trk_dmax = int(deg[tm].max())
            covered_obs += trk_obs
            deg = deg.copy()
            deg[tm] = 0

    # slot-major split: composes with tracks, taking the remaining eligible
    # points
    slot_buckets = None
    slot_span_max = 0
    if slots and symmetric and banded:
        elig = slots_mod.slot_eligible(cam_idx, pt_idx, n_obs, n_points)
        if (elig[0] & (deg > 0)).sum() >= max(slot_min, 1):
            sb = slots_mod.select_slot_buckets(cam_idx, pt_idx, n_obs, n_points, elig=elig,
                                               candidate_mask=deg > 0)
            if sb is not None and sb.n_tracked >= slot_min:
                slot_buckets = sb
                slot_span_max = sb.span_max
                covered_obs += int(deg[sb.accepted_pts].sum())
                deg = deg.copy()
                deg[sb.accepted_pts] = 0

    # heavy points: excluded from pair enumeration
    heavy_mask = deg > max_degree
    heavy_pt_ids = np.nonzero(heavy_mask)[0].astype(np.int64)
    n_heavy_pts = int(heavy_pt_ids.shape[0])
    if n_heavy_pts:
        is_heavy_obs = heavy_mask[pi_sorted]
        heavy_obs = order[is_heavy_obs]
        heavy_seg = np.searchsorted(heavy_pt_ids, pi_sorted[is_heavy_obs])
        csort = np.argsort(ci[heavy_obs], kind="stable")     # camera-sorted
        heavy_obs, heavy_seg = heavy_obs[csort], heavy_seg[csort]
        oh = heavy_obs.shape[0]
        pad_h = _round_up(oh, 256) - oh
        # padding repeats the last observation (keys stay sorted) under the
        # trash heavy segment n_heavy_pts
        heavy_obs = np.concatenate([heavy_obs, np.full(pad_h, heavy_obs[-1], np.int64)])
        heavy_seg = np.concatenate([heavy_seg, np.full(pad_h, n_heavy_pts, np.int64)])
        heavy_cam = ci[heavy_obs]
        n_heavy_obs = oh
    else:
        heavy_obs = np.zeros(0, np.int64)
        heavy_seg = np.zeros(0, np.int64)
        heavy_cam = np.zeros(0, np.int64)
        n_heavy_obs = 0

    light_dmax = int(deg[~heavy_mask].max()) if (~heavy_mask).any() else 0
    chunks_i, chunks_j, chunks_p = [], [], []
    for d in range(1, light_dmax + 1):
        pts = np.nonzero(deg == d)[0]
        if pts.size == 0:
            continue
        base = starts[pts]
        obsmat = order[base[:, None] + np.arange(d)[None, :]]     # (n_d, d)
        if symmetric:
            # unordered pairs with the diagonal, oriented so ci(ii) ≤ ci(jj)
            iu, ju = np.triu_indices(d)
            oa = obsmat[:, iu].reshape(-1)
            ob = obsmat[:, ju].reshape(-1)
            swap = ci[oa] > ci[ob]
            ii = np.where(swap, ob, oa)
            jj = np.where(swap, oa, ob)
            pp = np.broadcast_to(pts[:, None], (pts.size, iu.size)).reshape(-1)
        else:
            ii = np.broadcast_to(obsmat[:, :, None], (pts.size, d, d)).reshape(-1)
            jj = np.broadcast_to(obsmat[:, None, :], (pts.size, d, d)).reshape(-1)
            pp = np.broadcast_to(pts[:, None, None], (pts.size, d, d)).reshape(-1)
        chunks_i.append(ii)
        chunks_j.append(jj)
        chunks_p.append(pp)

    pair_i = np.concatenate(chunks_i) if chunks_i else np.zeros(0, np.int64)
    pair_j = np.concatenate(chunks_j) if chunks_j else np.zeros(0, np.int64)
    pair_p = np.concatenate(chunks_p) if chunks_p else np.zeros(0, np.int64)
    np_real = pair_i.shape[0]

    use_banded = bool(symmetric and banded
                      and (np_real or trk_mask is not None or slot_buckets is not None))
    # band-coverage admission, unless track and slot layouts already cover
    # most observations (their structure is in-band by construction)
    if use_banded and np_real and covered_obs < 0.5 * max(n_obs, 1):
        # band only when the capped band would cover most off-diagonal pairs
        # (the diagonal is stored either way and would mask a useless band)
        off_all = ci[pair_j] - ci[pair_i]
        off_nz = off_all[off_all > 0]
        _, cnt_all = np.unique(off_nz, return_counts=True)
        top32 = np.sort(cnt_all)[::-1][:32].sum()
        if off_nz.size and top32 < 0.5 * off_nz.size:
            use_banded = False
            if trk_mask is not None or slot_buckets is not None:
                # partially engaged layouts need the band grid; without it
                # their points go back to pair enumeration
                return build_pair_plan(
                    cam_idx, pt_idx, n_obs, n_cameras, n_points, max_degree=max_degree,
                    pad_multiple=pad_multiple, with_kernel_plans=with_kernel_plans,
                    symmetric=symmetric, banded=False, tracks=False, slots=False, device=device)
    band_list: tuple = ()
    c_pad = k_band = 0
    np_pad = _round_up(max(np_real, 1), pad_multiple)
    pad = np_pad - np_real
    fill_obs = max(n_obs - 1, 0)
    if use_banded:
        # every populated offset cj − ci when there are ≤ 32 of them (a fully
        # banded plan lets the whole PCG loop run as one kernel); with more,
        # the 32 heaviest by pair count, the rest off-band
        cip = ci[pair_i]
        cjp = ci[pair_j]
        off = cjp - cip                                   # ≥ 0 (ci ≤ cj)
        u_off, n_pairs_per_off = np.unique(off, return_counts=True)
        # the window offsets the track and slot builds write are mandatory
        # band slots: protect them through the 32-offset cap
        protect = max(trk_dmax, slot_span_max + 1 if slot_buckets is not None else 0)
        if protect:
            extra = np.setdiff1d(np.arange(protect), u_off)
            u_off = np.concatenate([u_off, extra])
            n_pairs_per_off = np.concatenate(
                [n_pairs_per_off.astype(np.int64), np.full(extra.shape, 1 << 60, np.int64)])
            srt = np.argsort(u_off)
            u_off, n_pairs_per_off = u_off[srt], n_pairs_per_off[srt]
            n_pairs_per_off = np.where(u_off < protect, 1 << 60, n_pairs_per_off)
        band_mask = np.ones(u_off.shape[0], bool)
        if u_off.shape[0] > 32:                           # cap the band width
            order_cnt = np.argsort(-n_pairs_per_off)
            keep = set(u_off[order_cnt[:32]].tolist()) | {0}
            band_mask = np.array([o in keep for o in u_off])
        band_arr = u_off[band_mask]
        if 0 not in band_arr:
            band_arr = np.concatenate([[0], band_arr])
        band_list = tuple(int(o) for o in band_arr)
        # +trk_dmax margin: the track keys start+a ≤ (C−1)+(dmax−1) must stay
        # inside one band row
        c_pad = _round_up(n_cameras + trk_dmax, 128)
        k_band = len(band_list) * c_pad

        off_to_idx = np.full(int(u_off.max()) + 1, -1, np.int64)
        off_to_idx[band_arr] = np.arange(len(band_list))
        oi = off_to_idx[off]
        in_band = oi >= 0
        seg_real = np.empty(np_real, np.int64)
        seg_real[in_band] = oi[in_band] * c_pad + cip[in_band]
        left_key = cip[~in_band] * n_cameras + cjp[~in_band]
        u_left = np.unique(left_key)
        seg_real[~in_band] = k_band + np.searchsorted(u_left, left_key)
        K = k_band + int(u_left.shape[0])
        k_pad = _round_up(K + 1, pad_multiple)

        perm = np.argsort(seg_real, kind="stable")
        pair_i, pair_j, pair_p = pair_i[perm], pair_j[perm], pair_p[perm]
        seg_real = seg_real[perm]
        key = ci[pair_i] * n_cameras + ci[pair_j]
        pair_seg = np.concatenate([seg_real, np.full(pad, k_pad - 1, np.int64)])

        # segment → camera pair (band slots: absent ⇒ trash row C)
        seg_ci = np.full(k_pad, n_cameras, np.int64)
        seg_cj = np.zeros(k_pad, np.int64)
        slot_c = np.arange(k_band) % c_pad
        slot_off = np.asarray(band_list)[np.arange(k_band) // c_pad]
        slot_ok = (slot_c < n_cameras) & (slot_c + slot_off < n_cameras)
        seg_ci[:k_band] = np.where(slot_ok, slot_c, n_cameras)
        seg_cj[:k_band] = np.where(slot_ok, slot_c + slot_off, 0)
        seg_ci[k_band:K] = u_left // n_cameras
        seg_cj[k_band:K] = u_left % n_cameras
        diag_pos = np.arange(n_cameras)                   # slot (0, c) = c
    else:
        key = ci[pair_i] * n_cameras + ci[pair_j]
        perm = np.argsort(key, kind="stable")
        pair_i, pair_j, pair_p, key = pair_i[perm], pair_j[perm], pair_p[perm], key[perm]
        # compact segments: rank the K distinct real keys; padding pairs land
        # in the trash segment k_pad−1
        uniq, inv = np.unique(key, return_inverse=True)
        K = int(uniq.shape[0])
        k_pad = _round_up(K + 1, pad_multiple)
        pair_seg = np.concatenate([inv.reshape(-1), np.full(pad, k_pad - 1, np.int64)])
        seg_ci = np.full(k_pad, n_cameras, np.int64)
        seg_cj = np.zeros(k_pad, np.int64)
        seg_ci[:K] = uniq // n_cameras
        seg_cj[:K] = uniq % n_cameras
        diag_key = np.arange(n_cameras) * (n_cameras + 1)
        diag_pos = np.minimum(np.searchsorted(uniq, diag_key), max(K - 1, 0))
        hit = uniq[diag_pos] == diag_key if K else np.zeros(n_cameras, bool)
        diag_pos = np.where(hit, diag_pos, k_pad - 1)
    pair_i = np.concatenate([pair_i, np.full(pad, fill_obs, np.int64)])
    pair_j = np.concatenate([pair_j, np.full(pad, fill_obs, np.int64)])
    pair_p = np.concatenate([pair_p, np.zeros(pad, np.int64)])
    key = np.concatenate([key, np.full(pad, n_cameras * n_cameras, np.int64)])

    seg_perm_cj = cj_keys = nondiag = None
    if symmetric and not use_banded:
        # transposed-pass schedule: segments permuted into cj-sorted order
        # (padding segments → trash camera C, so sortedness holds)
        cj_eff = np.where(seg_ci == n_cameras, n_cameras, seg_cj)
        seg_perm_cj = np.argsort(cj_eff, kind="stable").astype(np.int64)
        cj_keys = cj_eff[seg_perm_cj]
        nondiag = (seg_ci != seg_cj).astype(np.float32)

    track_layout = None
    if trk_mask is not None:
        track_layout = tracks_mod.build_track_layout(
            cam_idx, pt_idx, n_obs, n_cameras, n_points, c_pad,
            with_kernel_plans=with_kernel_plans, device=device)
    slot_layout = None
    if slot_buckets is not None and use_banded:
        slot_layout = slots_mod.finalize_slot_layout(
            slot_buckets, band_list, c_pad, with_kernel_plans=with_kernel_plans, device=device)

    return pair_plan_from_numpy(
        dict(pair_i=pair_i, pair_j=pair_j, pair_pt=pair_p, pair_key=key, pair_seg=pair_seg,
             seg_ci=seg_ci, seg_cj=seg_cj, diag_pos=diag_pos, heavy_obs=heavy_obs,
             heavy_cam=heavy_cam, heavy_seg=heavy_seg, heavy_pt_ids=heavy_pt_ids,
             seg_perm_cj=seg_perm_cj, cj_keys=cj_keys, nondiag=nondiag),
        track=track_layout, slot=slot_layout, with_kernel_plans=with_kernel_plans,
        device=device, n_pairs=np_pad, n_cameras=n_cameras, max_degree=dmax, n_segments=K,
        k_pad=k_pad, n_heavy_obs=n_heavy_obs, n_heavy_pts=n_heavy_pts, symmetric=symmetric,
        banded=use_banded, band_offsets=band_list, c_pad=c_pad, k_band=k_band)


SHARD_PAIR_ARRAYS = ("pair_i", "pair_j", "pair_pt", "pair_key", "pair_seg")


def shard_pair_plan(plan: PairPlan, n_dev: int, rank: int, *,
                    with_kernel_plans: bool = False) -> PairPlan:
    """Rank ``rank``'s part of ``plan`` for a solve sharded over ``n_dev``
    ranks (the reference's ``solve_sharded`` pair plan,
    ``tpu_ba/sharding/distributed.py``): the contiguous slice
    [rank·n, (rank+1)·n), n = n_pairs / n_dev, of the seg-sorted pair arrays,
    whose segment ids stay sorted and global, with its own K7 schedule over
    the global k_pad where ``with_kernel_plans``; the track layout's part
    (``tracks.shard_track_layout``). Pair and slot indices are global
    observation ids. The plan must have no slot layout (build it with
    slots=False, as the reference does: its degree buckets have no sharded
    form) and a pair count divisible by ``n_dev`` (build it with
    pad_multiple a multiple of ``n_dev``)."""
    if plan.n_pairs % n_dev:
        raise ValueError(f"pair count {plan.n_pairs} not divisible by mesh size {n_dev}; "
                         f"use a power-of-two mesh or adjust pad_multiple")
    if plan.slot is not None:
        raise ValueError("a sharded pair plan takes no slot layout: build it with slots=False")
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} outside [0, {n_dev})")
    n = plan.n_pairs // n_dev
    part = {k: getattr(plan, k)[rank * n:(rank + 1) * n].contiguous() for k in SHARD_PAIR_ARRAYS}
    seg_start = pair_sched = None
    if with_kernel_plans:
        seg = to_host(part["pair_seg"]).astype(np.int64)
        n_real = int((to_host(part["pair_key"]).astype(np.int64)
                      < plan.n_cameras * plan.n_cameras).sum())
        starts = np.searchsorted(seg[:n_real], np.arange(plan.k_pad + 1), side="left")
        device = plan.pair_seg.device
        seg_start = torch.as_tensor(starts.astype(np.int32), device=device)
        pair_sched = pair_schedule(starts, device=device)
    track = None
    if plan.track is not None:
        track = tracks_mod.shard_track_layout(plan.track, n_dev, rank,
                                              with_kernel_plans=with_kernel_plans)
    return dataclasses.replace(plan, **part, n_pairs=n, seg_start=seg_start,
                               pair_sched=pair_sched, track=track, shard=(rank, n_dev))


class PairData(NamedTuple):
    """λ-free per-linearization gathers, reused across λ-retries.

    ``packed`` (2·3dc+9, Np) lane-major: rows 0..3dc−1 are W[pair_i], rows
    3dc..6dc−1 W[pair_j], the last 9 rows V[pair_pt]."""

    packed: torch.Tensor
    heavy_W: torch.Tensor | None = None  # (3dc, Oh) W at the heavy observations
    heavy_V: torch.Tensor | None = None  # (9, Ph) V at the heavy points
    # track-major pack: W in (27, dmax, Pt) slot order, V in start-sorted order
    trk_W: torch.Tensor | None = None
    trk_V: torch.Tensor | None = None
    # slot-major pack: per degree bucket (27, d, Pk) / (9, Pk)
    slot_W: tuple | None = None
    slot_V: tuple | None = None
    # undamped lane-major camera blocks (dc², c_pad) for the fold-damp PCG
    # prologue (λ-free; damped and inverted per retry inside K4)
    U_t: torch.Tensor | None = None


def precompute_pair_data(B: BlockSystem, pairs: PairPlan, W=None) -> PairData:
    """λ-free per-linearization gathers into pair, track and slot order. The
    BlockSystem is lane-major ((3dc, O) / (9, P)), so these are gathers along
    the last axis. ``W`` stands in for ``B.W`` where that is a rank's
    observation shard: the sharded solve passes the all-gathered W, since
    pair and slot indices are global observation ids."""
    W = B.W if W is None else W
    packed = torch.cat([W[:, pairs.pair_i], W[:, pairs.pair_j], B.V[:, pairs.pair_pt]], dim=0)
    trk_W = trk_V = None
    if pairs.track is not None:
        trk_W, trk_V = tracks_mod.gather_track_data(W, B.V, pairs.track)
    slot_W = slot_V = None
    if pairs.slot is not None:
        slot_W, slot_V = slots_mod.gather_slot_data(W, B.V, pairs.slot)
        slot_W, slot_V = tuple(slot_W), tuple(slot_V)
    U_t = None
    if pairs.banded:
        dc = B.U.shape[-1]
        C = pairs.n_cameras
        U_t = torch.zeros((dc * dc, pairs.c_pad), dtype=B.U.dtype, device=B.U.device)
        U_t[:, :C] = B.U.permute(1, 2, 0).reshape(dc * dc, C)
    heavy_W = heavy_V = None
    if pairs.n_heavy_pts:
        heavy_W, heavy_V = W[:, pairs.heavy_obs], B.V[:, pairs.heavy_pt_ids]
    return PairData(packed, heavy_W, heavy_V, trk_W=trk_W, trk_V=trk_V, slot_W=slot_W,
                    slot_V=slot_V, U_t=U_t)


def _heavy_operator(pair_data: PairData, lam, pairs: PairPlan, dc: int, diag_floor: float,
                    diag_ceil: float):
    """Matrix-free term of S for the heavy tracks at damping λ.

    Returns (term, diag_h): ``term(x)`` (C, dc) → (C, dc) applies
    [W V_λ⁻¹ Wᵀ]_heavy, ``diag_h`` (C, dc, dc) is its exact camera block
    diagonal (for the preconditioner). Padding observations touch only the
    trash column of V_λ⁻¹, which is zero."""
    Wh = pair_data.heavy_W
    C, Ph = pairs.n_cameras, pairs.n_heavy_pts
    Vinv = damped_vinv_rows(pair_data.heavy_V, lam, diag_floor, diag_ceil)      # (9, Ph)
    Vinv = torch.cat([Vinv, Vinv.new_zeros((9, 1))], dim=1)                     # trash column 0
    heavy_cam, heavy_seg = pairs.heavy_cam.long(), pairs.heavy_seg.long()

    def term(x):
        wtx = _wt_dot(Wh, x.T[:, heavy_cam], dc)                     # (3, Oh)
        t = segment_sum_t(wtx, heavy_seg, Ph + 1)                    # (3, Ph+1); keys unsorted
        u = _matmul_rows_33(Vinv, t)
        z = _w_dot(Wh, u[:, heavy_seg], dc)                          # (dc, Oh)
        return segment_sum_t(z, heavy_cam, C, sorted_keys=True).T

    diag_h = w_vinv_wt_diag(Wh, Vinv, heavy_cam, heavy_seg, C)
    return term, diag_h


def _pair_products_t(packed, lam, dc: int, diag_floor: float, diag_ceil: float):
    """vals_t (dc², Np): the per-pair blocks W_i V_λ⁻¹ W_jᵀ, lane-major, the
    3×3 damped inverse recomputed per pair."""
    Wi, Wj, V = packed[:3 * dc], packed[3 * dc:6 * dc], packed[6 * dc:6 * dc + 9]
    return block_products_rows(Wi, damped_vinv_rows(V, lam, diag_floor, diag_ceil), Wj, dc)


def _reduce_pairs_t(vals_t, pair_key, n_cameras: int):
    """T_t (dc², C²): segment sum of the pair blocks by camera-pair key (the
    trailing trash segment C² collects the padding)."""
    C2 = n_cameras * n_cameras
    return segment_sum_t(vals_t, pair_key, C2 + 1, sorted_keys=True)[:, :C2]


def build_schur_t(B: BlockSystem, lam, pairs: PairPlan, pair_data: PairData,
                  diag_floor: float, diag_ceil: float):
    """The reduced camera system in T-major layout, from a non-symmetric plan.

    Returns (Ul, T4, diag_S): Ul (C, dc, dc) the damped camera blocks, T4
    (dc, dc, C, C) = Σ_p W V_λ⁻¹ Wᵀ, diag_S (C, dc, dc) the exact block
    diagonal of S = U_λ − T. The matvec never forms S:
    y = Ul·x − einsum("ijcd,dj->ci", T4, x)."""
    if pairs.symmetric:
        raise ValueError("build_schur_t needs a full (non-symmetric) pair plan; build with "
                         "symmetric=False")
    C = pairs.n_cameras
    dc = B.U.shape[-1]
    Ul, _ = damp_blocks(B, lam, diag_floor, diag_ceil)
    vals_t = _pair_products_t(pair_data.packed, lam, dc, diag_floor, diag_ceil)
    T4 = _reduce_pairs_t(vals_t, pairs.pair_key, C).reshape(dc, dc, C, C)
    diag_S = Ul - torch.diagonal(T4, dim1=2, dim2=3).permute(2, 0, 1)
    return Ul, T4, diag_S


def build_dense_schur(B: BlockSystem, lam, pairs: PairPlan, pair_data: PairData,
                      diag_floor: float, diag_ceil: float):
    """S = U_λ − W V_λ⁻¹ Wᵀ as a (dc·C, dc·C) matrix plus its exact block
    diagonal (C, dc, dc): the test oracle. The solver stays in T-major layout
    (``build_schur_t``) and never forms this matrix."""
    if pairs.n_heavy_pts:
        raise ValueError("build_dense_schur does not fold in heavy tracks; build the plan with "
                         "a larger max_degree")
    C = pairs.n_cameras
    dc = B.U.shape[-1]
    Ul, T4, diag_S = build_schur_t(B, lam, pairs, pair_data, diag_floor, diag_ceil)
    S4 = -T4.permute(2, 0, 3, 1).clone()                              # (C, dc, C, dc)
    idx = torch.arange(C, device=S4.device)
    S4[idx, :, idx, :] += Ul
    return S4.reshape(C * dc, C * dc), diag_S


def solve_schur_dense(B: BlockSystem, lam, pairs: PairPlan, pair_data: PairData | None = None,
                      *, cg_max_iters: int, cg_tol, cg_x0=None, diag_floor: float,
                      diag_ceil: float):
    """Linear solve on the explicit dense reduced camera system: block-Jacobi
    PCG (host loop) over the T-major matvec. Returns (δ_cameras, δ_points,
    cg_iters, ok), the contract of ``solve_schur_pcg``."""
    if pair_data is None:
        pair_data = precompute_pair_data(B, pairs)
    dc = B.U.shape[-1]
    Ul, T4, diag_S = build_schur_t(B, lam, pairs, pair_data, diag_floor, diag_ceil)
    heavy_term = None
    if pairs.n_heavy_pts:
        heavy_term, diag_h = _heavy_operator(pair_data, lam, pairs, dc, diag_floor, diag_ceil)
        diag_S = diag_S - diag_h
    _, Vl_pts = damp_blocks(B, lam, diag_floor, diag_ceil)
    Vinv_pts = inv3x3_rows(Vl_pts)
    b = schur_rhs(B, Vinv_pts)
    Minv = inv_spd_small(diag_S)

    def matvec(x):
        y = torch.einsum("cij,cj->ci", Ul, x) - torch.einsum("ijcd,dj->ci", T4, x)
        return y if heavy_term is None else y - heavy_term(x)

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    dx_cam, cg_iters, ok = pcg(matvec, b, precond, max_iters=cg_max_iters, tol=cg_tol, x0=cg_x0)
    return dx_cam, back_substitute(B, Vinv_pts, dx_cam), cg_iters, ok


def _compact_blocks(B: BlockSystem, lam, pairs: PairPlan, pair_data: PairData,
                    diag_floor: float, diag_ceil: float):
    """blk (dc², k_pad): the K nonzero (dc×dc) blocks of T = W V_λ⁻¹ Wᵀ in
    compact segment order (blk[dc·i+j, k] = T_{seg_ci[k], seg_cj[k]}[i, j]);
    columns ≥ K are exact zeros. A plan built with kernel plans goes through
    the K7/K5/K6 wrappers (K5 and K6 adding into blk in place), any other
    through the plain versions."""
    dc = B.U.shape[-1]
    kw = dict(dc=dc, diag_floor=diag_floor, diag_ceil=diag_ceil)
    if pairs.pair_sched is not None:
        blk = fused_pair_blocks(pair_data.packed, pairs.pair_seg, lam, pairs.k_pad,
                                pairs.pair_sched, **kw)
    else:       # K7's plain version with its sum in a fixed order
        blk = segment_sum_t(_pair_products_t(pair_data.packed, lam, dc, diag_floor, diag_ceil),
                            pairs.pair_seg, pairs.k_pad, sorted_keys=True)
    # only the trash column k_pad−1 receives padding pairs: zero it so reads
    # of absent diagonals through diag_pos are exact zeros
    blk[:, -1] = 0.0

    if pairs.track is not None:
        # slot pair (a, b) of a track starting at c0 is band block
        # (offset b−a, row c0+a), added on top of the enumerated pairs
        tl = pairs.track
        if tl.key_start is not None:
            # build_pair_plan puts the track offsets 0..dmax−1 first in the
            # band, so the kernel's grid is the band's first dmax·c_pad columns
            assert pairs.band_offsets[:tl.dmax] == tuple(range(tl.dmax))
            assert tl.n_out == pairs.c_pad
            fused_track_blocks(pair_data.trk_W, pair_data.trk_V, lam, tl, out=blk, **kw)
        else:
            tout = fused_track_blocks_plain(pair_data.trk_W, pair_data.trk_V, lam, tl,
                                            segment_sum=segment_sum_t, **kw)
            d2 = dc * dc
            cp = pairs.c_pad
            for g in range(tl.dmax):
                pos = pairs.band_offsets.index(g) * cp
                blk[:, pos:pos + cp] += tout[g * d2:(g + 1) * d2, :cp]

    if pairs.slot is not None:
        # the slot build works on the off-major band grid itself, the layout
        # of blk[:, :k_band]: the kernel adds into blk in place
        sl = pairs.slot
        if sl.inc_start is not None:
            slot_band_blocks(pair_data.slot_W, pair_data.slot_V, lam, sl, out=blk, **kw)
        else:
            blk[:, :pairs.k_band] += slot_band_blocks_plain(pair_data.slot_W, pair_data.slot_V,
                                                            lam, sl, segment_sum=segment_sum_t,
                                                            **kw)
    return blk


def make_banded_matvec(blk, Ul, pairs: PairPlan, dc: int, heavy_term=None):
    """S·x for the banded symmetric layout. The band region of ``blk`` is a
    dense (offset, ci) grid, so applying T is shifts and products with no
    gathers: forward y_c −= Σ_off T_{c,c+off} x_{c+off} and, for off > 0, the
    transposed y_{c+off} −= T_{c,c+off}ᵀ x_c. The lanes a circular shift
    wraps into hold zero band blocks (cj = c+off ≥ C has no segment).
    Off-band leftover segments (a few ring wrap-arounds or loop closures when
    the band is capped) go through gathers on their small slice;
    ``heavy_term`` is the matrix-free term of the heavy tracks."""
    C = pairs.n_cameras
    Bn = len(pairs.band_offsets)
    Cp = pairs.c_pad
    Sb = blk[:, :pairs.k_band].reshape(dc, dc, Bn, Cp)
    have_left = pairs.n_segments > pairs.k_band
    if have_left:
        lblk = blk[:, pairs.k_band:].reshape(dc, dc, -1)
        lci = pairs.seg_ci[pairs.k_band:].long()
        lcj = pairs.seg_cj[pairs.k_band:].long()
        lci_in = torch.clamp(lci, max=C - 1)

    def matvec(x):
        y = torch.einsum("cij,cj->ci", Ul, x)
        x_t = torch.zeros((dc, Cp), dtype=x.dtype, device=x.device)
        x_t[:, :C] = x.T
        Xs = torch.stack([torch.roll(x_t, -off, dims=1) for off in pairs.band_offsets])
        t = torch.einsum("mnoc,onc->mc", Sb, Xs)
        if Bn > 1:
            u = torch.einsum("mnoc,mc->onc", Sb[:, :, 1:], x_t)     # (B−1, dc, Cp)
            for oi, off in enumerate(pairs.band_offsets[1:]):
                t = t + torch.roll(u[oi], off, dims=1)
        y = y - t[:, :C].T
        if have_left:
            zl = torch.einsum("mnl,nl->ml", lblk, x.T[:, lcj])      # T x by row camera
            zl2 = torch.einsum("mnl,ml->nl", lblk, x.T[:, lci_in])  # Tᵀ x by column camera
            tl = segment_sum_t(zl, lci, C + 1, sorted_keys=True)
            tl2 = segment_sum_t(zl2, lcj, C + 1)
            y = y - tl[:, :C].T - tl2[:, :C].T
        return y if heavy_term is None else y - heavy_term(x)

    return matvec


def make_compact_matvec(blk, Ul, pairs: PairPlan, dc: int, heavy_term=None):
    """S·x for a non-banded plan: gather x by column camera, block·vector per
    segment, sum by row camera; a symmetric plan adds the transposed pass
    y_cj −= T_{ci,cj}ᵀ x_ci over the off-diagonal blocks, summed by column
    camera through the plan's cj-sorted permutation (which K1 reads through:
    no permuted copy). With kernel plans the
    two keyed sums go through the K1 wrapper (keys 0 … C, padding segments
    under the trash camera C, whose blocks are exact zeros); without, through
    plain PyTorch."""
    C = pairs.n_cameras
    blk3 = blk.reshape(dc, dc, -1)
    seg_cj = pairs.seg_cj.long()
    seg_ci_in = torch.clamp(pairs.seg_ci.long(), max=C - 1)
    nondiag = perm = None
    if pairs.symmetric:
        nondiag = pairs.nondiag.to(blk.dtype)
        if pairs.cj_start is not None:
            perm = pairs.seg_perm_cj      # int32: K1 gathers through it as it reads

    def matvec(x):
        y = torch.einsum("cij,cj->ci", Ul, x)
        z = (blk3 * x.T[:, seg_cj][None, :, :]).sum(dim=1)              # (dc, k_pad)
        if pairs.ci_start is not None:
            t = sorted_segment_sum_t(z, pairs.seg_ci, C + 1, pairs.ci_start,
                                     longest=pairs.ci_longest)
        else:
            t = segment_sum_t(z, pairs.seg_ci, C + 1, sorted_keys=True)
        y = y - t[:, :C].T
        if pairs.symmetric:
            z2 = (blk3 * x.T[:, seg_ci_in][:, None, :]).sum(dim=0) * nondiag[None, :]
            if perm is not None:
                t2 = sorted_segment_sum_t(z2, pairs.cj_keys, C + 1, pairs.cj_start, perm=perm,
                                          longest=pairs.cj_longest)
            else:
                t2 = segment_sum_t(z2, seg_cj, C + 1)                  # unsorted keys
            y = y - t2[:, :C].T
        return y if heavy_term is None else y - heavy_term(x)

    return matvec


def solve_schur_sparse(B: BlockSystem, lam, pairs: PairPlan, pair_data: PairData | None = None,
                       *, cg_max_iters: int, cg_tol, cg_x0=None, diag_floor: float,
                       diag_ceil: float, plans=None, group=None,
                       pcg_kernel: bool | None = None, precond: str = "jacobi"):
    """Linear solve on the block-sparse explicit reduced camera system.

    Returns (δ_cameras, δ_points, cg_iters, ok), the contract of
    ``solve_schur_pcg``; on the kernel route ``cg_iters`` is a 0-dim device
    tensor.

    ``precond="tridiag"`` preconditions with the PCR-factored
    block-tridiagonal part of S (``solver/tridiag.py``), factored once per
    call. It engages on a banded plan without heavy points whose second band
    offset is 1; any other plan is preconditioned with block-Jacobi, silently,
    as in the reference.

    ``pcg_kernel`` (default: whether the plan carries kernel plans) asks for
    the whole solve in the PCG kernel, which takes a banded plan (off-band
    leftover segments included) without heavy points: K4 with block-Jacobi,
    where it damps U and inverts the block diagonal itself, K8 with
    ``precond="tridiag"``, where Ul and the factors are computed here. Heavy
    points and non-banded plans go to the host-loop PCG of ``solver/pcg.py``
    by the reference's own conditions; nothing else gives way to it. On the
    CPU the kernel route is the plain version of the kernel in f32 and the
    host loop in f64, as the reference's f64 is; f64 on the card is refused
    by the kernel's wrapper.

    Sharded (``group``, ``solver/collective.py``): ``pairs`` is the rank's
    part (``shard_pair_plan``) and ``pair_data`` its gathers from the
    all-gathered W; B's U, V, g are replicated, its W and index maps the
    rank's shard. The blocks are all-reduced once, right after the rank's
    pair and track partials are reduced into them and before anything
    replicated enters them; the right-hand side and the back-substitution
    all-reduce their observation sums; the CG runs replicated."""
    if group is not None and group.world > 1 and not pairs.shard:
        raise ValueError("a sharded solve needs each rank's part of the pair plan "
                         "(shard_pair_plan): the whole plan's blocks on every rank would be "
                         "summed world-size times")
    if precond not in ("jacobi", "tridiag"):
        raise ValueError(f"precond must be 'jacobi' or 'tridiag', got {precond!r}")
    if pair_data is None:
        pair_data = precompute_pair_data(B, pairs)
    C = pairs.n_cameras
    dc = B.U.shape[-1]
    want_kernel = pcg_kernel if pcg_kernel is not None else pairs.seg_start is not None
    use_kernel = (pairs.banded and want_kernel and pairs.n_heavy_pts == 0
                  and (B.U.dtype == torch.float32 or B.U.device.type == "cuda"))

    blk = all_reduce(_compact_blocks(B, lam, pairs, pair_data, diag_floor, diag_ceil), group)
    Ul, Vl_pts = damp_blocks(B, lam, diag_floor, diag_ceil)
    Vinv_pts = inv3x3_rows(Vl_pts)
    b = schur_rhs(B, Vinv_pts, plans, group)

    if use_kernel and precond == "jacobi":
        # fold-damp route: K4 takes the undamped U_t and computes the damped
        # Ul and the block-Jacobi M⁻¹ in its prologue
        dx_cam, cg_iters, ok = pcg_banded(
            blk, None, None, b, pairs, max_iters=cg_max_iters, tol=cg_tol, x0=cg_x0,
            U_t=pair_data.U_t, lam=lam, diag_floor=diag_floor, diag_ceil=diag_ceil)
        return dx_cam, back_substitute(B, Vinv_pts, dx_cam, plans, group), cg_iters, ok

    # the diagonal of T: on a banded plan band slot (offset 0, c), a plain slice
    diag_T = blk[:, :C] if pairs.banded else blk[:, pairs.diag_pos.long()]
    diag_S = Ul - diag_T.reshape(dc, dc, C).permute(2, 0, 1)
    heavy_term = None
    if pairs.n_heavy_pts:
        heavy_term, diag_h = _heavy_operator(pair_data, lam, pairs, dc, diag_floor, diag_ceil)
        diag_S = diag_S - diag_h
    Minv = inv_spd_small(diag_S)

    pcr = None
    if (precond == "tridiag" and pairs.banded and pairs.n_heavy_pts == 0
            and len(pairs.band_offsets) > 1 and pairs.band_offsets[1] == 1):
        pcr = pcr_factor(*tridiag_from_band(blk, diag_S, pairs, dc))

    if use_kernel:
        dx_cam, cg_iters, ok = pcg_banded(blk, Ul, Minv, b, pairs, max_iters=cg_max_iters,
                                          tol=cg_tol, x0=cg_x0, tridiag=pcr)
        return dx_cam, back_substitute(B, Vinv_pts, dx_cam, plans, group), cg_iters, ok

    if pairs.banded:
        matvec = make_banded_matvec(blk, Ul, pairs, dc, heavy_term)
    else:
        matvec = make_compact_matvec(blk, Ul, pairs, dc, heavy_term)

    if pcr is not None:
        def apply_minv(r):
            return pcr_apply(*pcr, r)
    else:
        def apply_minv(r):
            return torch.einsum("cij,cj->ci", Minv, r)

    dx_cam, cg_iters, ok = pcg(matvec, b, apply_minv, max_iters=cg_max_iters, tol=cg_tol,
                               x0=cg_x0, group=group)
    return dx_cam, back_substitute(B, Vinv_pts, dx_cam, plans, group), cg_iters, ok
