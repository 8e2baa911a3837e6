"""The port's host planners against the reference's, array for array:
``build_pair_plan`` with its track and slot layouts, and the classifiers
``split_tracks``, ``slot_eligible``, ``select_slot_buckets``.

Both packages get the same numpy index maps. Also here, for the other
``test_torch_*`` files of the sparse tier: the problem makers and the
numpy bridge from a reference plan to the port's."""

import numpy as np
import pytest
import torch

from tpu_ba.core import make_problem as ref_make_problem
from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba.solver import pairs as ref_pairs
from tpu_ba.solver import slots as ref_slots
from tpu_ba.solver import tracks as ref_tracks
from tpu_ba_torch.solver import pairs as port_pairs
from tpu_ba_torch.solver import slots as port_slots
from tpu_ba_torch.solver import tracks as port_tracks

torch.set_num_threads(1)

SLOT_BUCKET_ARRAYS = ("slot_idx", "slot_cam", "slot_mask", "vperm", "tile_base")
SLOT_META = ("degrees", "tiles", "widths", "pt_pad", "n_off_loc", "n_tracked", "l2_len", "n_out")


# ---- problems: (ref BAProblem f64, n_cameras, n_points), from a numpy seed ----

def _with_incidence(n_cams, n_pts, ci, pi, seed, sort=True):
    base, _ = ref_synthetic(n_cams, n_pts, obs_per_point=3, pixel_noise=0.5, seed=seed,
                            dtype=np.float64, pad_multiple=8)
    obs = np.random.default_rng(seed + 100).normal(0.0, 50.0, (ci.shape[0], 2))
    return ref_make_problem(np.asarray(base.cameras), np.asarray(base.points), obs,
                            ci.astype(np.int32), pi.astype(np.int32), dtype=np.float64,
                            pad_multiple=8, sort=sort)


def ring_problem(n_cams=24, n_pts=240, seed=5):
    """Every point seen by 4 consecutive cameras of a ring: tracks engage,
    the wrapped points stay enumerated pairs."""
    c0 = np.repeat(np.arange(n_cams), n_pts // n_cams)
    ci = ((c0[:, None] + np.arange(4)[None, :]) % n_cams).reshape(-1)
    return _with_incidence(n_cams, n_pts, ci, np.repeat(np.arange(n_pts), 4), seed)


def gappy_problem(n_cams=40, pts_per_cam=12, seed=3, drop_share=1.0):
    """Windowed visibility with dropouts: 4 cameras of a 6-wide window, so
    most tracks have gaps (the slot path's points); ``drop_share`` < 1 keeps
    some tracks consecutive (then tracks and slots both engage)."""
    rng = np.random.default_rng(seed)
    n_pts = n_cams * pts_per_cam
    rows = []
    for p in range(n_pts):
        win = (p // pts_per_cam + np.arange(6)) % n_cams
        take = np.sort(rng.choice(6, 4, replace=False)) if rng.random() < drop_share \
            else np.arange(4)
        rows.append(np.sort(win[take]))
    return _with_incidence(n_cams, n_pts, np.concatenate(rows), np.repeat(np.arange(n_pts), 4),
                           seed)


def leftover_problem(n_cams=40, n_pts=200, seed=13):
    """A ring window plus one far camera per point over many offsets: more
    than 32 offsets, so the band is capped and off-band segments are left."""
    rng = np.random.default_rng(seed)
    c0 = np.repeat(np.arange(n_cams), 5)[:n_pts]
    win = np.stack([c0, (c0 + 1) % n_cams, (c0 + 2) % n_cams], -1)
    far = (c0 + 3 + rng.integers(0, n_cams - 3, n_pts)) % n_cams
    ci = np.concatenate([win, far[:, None]], axis=1).reshape(-1)
    return _with_incidence(n_cams, n_pts, ci, np.repeat(np.arange(n_pts), 4), seed)


def community_problem(n_cams=150, n_pts=400, seed=21):
    """Cameras drawn by popularity with no spatial order: ~C distinct
    offsets, so band admission refuses the band."""
    rng = np.random.default_rng(seed)
    pop = (1.0 + np.arange(n_cams)) ** -0.9
    pop = rng.permutation(pop / pop.sum())
    rows = np.stack([rng.choice(n_cams, 4, replace=False, p=pop) for _ in range(n_pts)])
    return _with_incidence(n_cams, n_pts, rows.reshape(-1), np.repeat(np.arange(n_pts), 4), seed)


def unsorted_problem():
    """The ring, observations left in reversed (not camera-sorted) order."""
    p = ring_problem()
    n = p.n_obs
    return _with_incidence(24, 240, np.asarray(p.cam_idx)[:n][::-1].copy(),
                           np.asarray(p.pt_idx)[:n][::-1].copy(), 5, sort=False)


CASES = {
    # name: (problem maker, build_pair_plan keywords)
    "ring_tracks": (ring_problem, dict(symmetric=True)),
    "ring_pairs_only": (ring_problem, dict(symmetric=True, tracks=False, slots=False)),
    "ring_not_banded": (ring_problem, dict(symmetric=True, banded=False)),
    "ring_full_enumeration": (ring_problem, dict(symmetric=False)),
    "gappy_slots": (gappy_problem, dict(symmetric=True, slots=True, tracks=False)),
    "gappy_tracks_and_slots": (lambda: gappy_problem(drop_share=0.5),
                               dict(symmetric=True, slots=True)),
    "heavy_point": (ring_problem, dict(symmetric=True, max_degree=3, tracks=False,
                                       slots=False)),
    "community_refuses_band": (community_problem, dict(symmetric=True)),
    "community_tracks_fall_back": (community_problem, dict(symmetric=True, slots=True)),
    "leftover_segments": (leftover_problem, dict(symmetric=True)),
    "unsorted_input": (unsorted_problem, dict(symmetric=True, slots=True)),
}


def index_maps(p):
    return np.asarray(p.cam_idx), np.asarray(p.pt_idx), p.n_obs, p.cameras.shape[0], \
        p.points.shape[0]


# ---- the numpy bridge: a reference plan, as numpy arrays and ints, to the port ----

def track_to_port(tl, with_kernel_plans=False):
    if tl is None:
        return None
    return port_tracks.track_layout_from_numpy(
        {k: np.asarray(getattr(tl, k)) for k in port_tracks.TRACK_ARRAYS}, dmax=tl.dmax,
        n_tracked=tl.n_tracked, pt_pad=tl.pt_pad, n_out=tl.n_out,
        with_kernel_plans=with_kernel_plans, device="cpu")


def slot_to_port(sl, band_offsets, c_pad, with_kernel_plans=False):
    if sl is None:
        return None
    arrays = {k: [np.asarray(a) for a in getattr(sl, k)] for k in SLOT_BUCKET_ARRAYS}
    arrays.update(l2_perm=np.asarray(sl.l2_perm), l2_keys=np.asarray(sl.l2_keys))
    return port_slots.slot_layout_from_numpy(
        arrays, **{k: getattr(sl, k) for k in SLOT_META}, band_offsets=band_offsets,
        c_pad=c_pad, with_kernel_plans=with_kernel_plans, device="cpu")


def plan_to_port(plan, with_kernel_plans=False):
    arrays = {k: np.asarray(getattr(plan, k)) for k in port_pairs.PAIR_ARRAYS}
    for k in port_pairs.PAIR_OPTIONAL_ARRAYS:
        if getattr(plan, k) is not None:
            arrays[k] = np.asarray(getattr(plan, k))
    return port_pairs.pair_plan_from_numpy(
        arrays, track=track_to_port(plan.track, with_kernel_plans),
        slot=slot_to_port(plan.slot, plan.band_offsets, plan.c_pad, with_kernel_plans),
        with_kernel_plans=with_kernel_plans, device="cpu",
        **{k: getattr(plan, k) for k in port_pairs.PAIR_META})


# ---- comparisons ----

def _same(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def assert_same_track(port, ref):
    assert (port is None) == (ref is None)
    if ref is None:
        return
    for k in port_tracks.TRACK_ARRAYS:
        _same(getattr(port, k), getattr(ref, k), f"track.{k}")
    for k in ("dmax", "n_tracked", "pt_pad", "n_out"):
        assert getattr(port, k) == getattr(ref, k), k


def assert_same_slot(port, ref):
    assert (port is None) == (ref is None)
    if ref is None:
        return
    for k in SLOT_META:
        assert getattr(port, k) == getattr(ref, k), k
    for k in SLOT_BUCKET_ARRAYS:
        assert len(getattr(port, k)) == len(getattr(ref, k)), k
        for i, (a, b) in enumerate(zip(getattr(port, k), getattr(ref, k))):
            _same(a, b, f"slot.{k}[{i}]")
    _same(port.l2_perm, ref.l2_perm, "slot.l2_perm")
    _same(port.l2_keys, ref.l2_keys, "slot.l2_keys")


def assert_same_plan(port, ref):
    for k in port_pairs.PAIR_META:
        assert getattr(port, k) == getattr(ref, k), k
    for k in port_pairs.PAIR_ARRAYS:
        _same(getattr(port, k), getattr(ref, k), k)
    for k in port_pairs.PAIR_OPTIONAL_ARRAYS:
        assert (getattr(port, k) is None) == (getattr(ref, k) is None), k
        if getattr(ref, k) is not None:
            _same(getattr(port, k), getattr(ref, k), k)
    assert_same_track(port.track, ref.track)
    assert_same_slot(port.slot, ref.slot)


# ---- tests ----

@pytest.mark.parametrize("case", sorted(CASES))
def test_build_pair_plan_matches_reference(case):
    make, kw = CASES[case]
    ci, pi, n_obs, C, P = index_maps(make())
    kw = dict(kw, pad_multiple=16)
    ref = ref_pairs.build_pair_plan(ci, pi, n_obs, C, P, **kw)
    port = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, device="cpu", **kw)
    assert_same_plan(port, ref)
    # each case engages the branch it is named for
    want = {
        "ring_tracks": ref.track is not None and ref.banded and ref.n_segments <= ref.k_band,
        "ring_pairs_only": ref.track is None and ref.slot is None and ref.banded,
        "ring_not_banded": not ref.banded and ref.seg_perm_cj is not None,
        "ring_full_enumeration": not ref.symmetric and not ref.banded,
        "gappy_slots": ref.slot is not None and ref.track is None,
        "gappy_tracks_and_slots": ref.slot is not None and ref.track is not None,
        "heavy_point": ref.n_heavy_pts > 0,
        "community_refuses_band": not ref.banded,
        "community_tracks_fall_back": not ref.banded and ref.slot is None,
        "leftover_segments": ref.banded and len(ref.band_offsets) == 32
        and ref.n_segments > ref.k_band,
        "unsorted_input": ref.track is None and ref.slot is None,
    }[case]
    assert want, case


def test_kernel_plans_are_csr_starts_of_the_real_entries():
    """What the CUDA kernels walk: CSR starts that cover every real pair,
    tracked point and slot point, and none of the padding."""
    ci, pi, n_obs, C, P = index_maps(gappy_problem(drop_share=0.5))
    plan = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, symmetric=True, slots=True,
                                      pad_multiple=16, with_kernel_plans=True, device="cpu")
    assert port_pairs.build_pair_plan(ci, pi, n_obs, C, P, symmetric=True, slots=True,
                                      pad_multiple=16, device="cpu").seg_start is None
    seg, start = plan.pair_seg.numpy(), plan.seg_start.numpy()
    n_real = int((plan.pair_key.numpy() < C * C).sum())
    assert start.shape == (plan.k_pad + 1,) and start[0] == 0 and start[-1] == n_real
    for k in np.unique(seg[:n_real]):
        assert np.all(seg[start[k]:start[k + 1]] == k)
    tl, sl = plan.track, plan.slot
    ks = tl.key_start.numpy()
    assert ks.shape == (plan.c_pad + 1,) and ks[-1] == tl.n_tracked
    keys = tl.keys.numpy()
    assert all(np.all(keys[ks[c]:ks[c + 1]] == c) for c in range(C))
    assert tl.slot_mask.numpy()[:, tl.n_tracked:].sum() == 0
    for k, st in enumerate(sl.inc_start):
        cam, mask = sl.slot_cam[k].numpy(), sl.slot_mask[k].numpy()
        assert st.numpy()[-1] == int((mask > 0).sum()) and st.shape == (plan.c_pad + 1,)
        assert sl.spans[k] == ((cam - cam[0]) * (mask > 0)).max() <= port_slots.SLOT_SPAN_CAP
    off_idx = sl.off_idx.numpy()
    for o in range(sl.n_off_loc):
        assert off_idx[o] == (plan.band_offsets.index(o) if o in plan.band_offsets else -1)
    assert plan.band_offsets_t.tolist() == list(plan.band_offsets)


@pytest.mark.parametrize("make", [ring_problem, gappy_problem, community_problem,
                                  unsorted_problem], ids=lambda f: f.__name__)
def test_classifiers_match_reference(make):
    ci, pi, n_obs, C, P = index_maps(make())
    for a, b in zip(port_tracks.split_tracks(ci, pi, n_obs, P),
                    ref_tracks.split_tracks(ci, pi, n_obs, P)):
        _same(a, b, "split_tracks")
    elig_p = port_slots.slot_eligible(ci, pi, n_obs, P)
    elig_r = ref_slots.slot_eligible(ci, pi, n_obs, P)
    for a, b in zip(elig_p, elig_r):
        _same(a, b, "slot_eligible")
    sb_p = port_slots.select_slot_buckets(ci, pi, n_obs, P, elig=elig_p)
    sb_r = ref_slots.select_slot_buckets(ci, pi, n_obs, P, elig=elig_r)
    assert (sb_p is None) == (sb_r is None)
    if sb_r is not None:
        _same(sb_p.accepted_pts, sb_r.accepted_pts, "accepted_pts")
        for k in ("degrees", "tiles", "widths", "pt_pad", "span_max", "n_tracked"):
            assert getattr(sb_p, k) == getattr(sb_r, k), k
        for k in ("sidx", "scam", "smask", "vperm", "tile_base"):
            for a, b in zip(getattr(sb_p, k), getattr(sb_r, k)):
                _same(a, b, k)


def test_track_and_slot_layouts_match_reference_standalone():
    ci, pi, n_obs, C, P = index_maps(gappy_problem(drop_share=0.5))
    c_pad = 128
    assert_same_track(
        port_tracks.build_track_layout(ci, pi, n_obs, C, P, c_pad, with_kernel_plans=False,
                                       device="cpu"),
        ref_tracks.build_track_layout(ci, pi, n_obs, C, P, c_pad, with_kernel_plans=False))
    band = (0, 1, 2, 3, 5, 38)          # offset 4 has no band slot: its cells are trash
    sb_p = port_slots.select_slot_buckets(ci, pi, n_obs, P)
    sb_r = ref_slots.select_slot_buckets(ci, pi, n_obs, P)
    assert_same_slot(
        port_slots.finalize_slot_layout(sb_p, band, c_pad, with_kernel_plans=False, device="cpu"),
        ref_slots.finalize_slot_layout(sb_r, band, c_pad, with_kernel_plans=False))
    with pytest.raises(ValueError, match="c_pad"):
        port_tracks.build_track_layout(ci, pi, n_obs, C, P, C, device="cpu")


def _incidences_brute_force(cam, mask, c_pad):
    """The (p, a) of every unmasked slot, row by row, in ascending p."""
    starts, codes = [0], []
    for r in range(c_pad):
        for p in range(cam.shape[1]):
            codes += [p * 16 + a for a in range(cam.shape[0])
                      if mask[a, p] > 0 and cam[a, p] == r]
        starts.append(len(codes))
    return np.asarray(starts), np.asarray(codes, np.int64)


def wide_degree_problem(n_cams=30, seed=17):
    """Points of degree 2–9 over a window of 12 cameras, and cameras 0–1 and
    the last that no slot reaches: buckets of degree > 4, rows with no
    incidence, masked slots."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(2, n_cams - 12):
        for deg in (2, 3, 5, 6, 7, 9):
            rows.append(np.sort(c + rng.choice(12, deg, replace=False)))
    return _with_incidence(n_cams, len(rows), np.concatenate(rows),
                           np.repeat(np.arange(len(rows)), [len(r) for r in rows]), seed)


@pytest.mark.parametrize("case", ["gappy_slots", "gappy_tracks_and_slots", "unsorted_input",
                                  "wide_degrees"])
def test_slot_incidences_match_a_brute_force_enumeration(case):
    """K6's CSR: every unmasked (point, slot) once, under the row of its
    camera, in ascending point order, on every slot-bearing plan."""
    if case == "wide_degrees":
        make, kw = wide_degree_problem, dict(symmetric=True, slots=True, tracks=False)
    else:
        make, kw = CASES[case]
    ci, pi, n_obs, C, P = index_maps(make())
    plan = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, pad_multiple=16,
                                      with_kernel_plans=True, device="cpu", **kw)
    if plan.slot is None:
        assert case == "unsorted_input"       # nothing is slot-eligible there
        return
    sl = plan.slot
    for k in range(len(sl.degrees)):
        cam, mask = sl.slot_cam[k].numpy(), sl.slot_mask[k].numpy()
        starts, codes = _incidences_brute_force(cam, mask, plan.c_pad)
        _same(sl.inc_start[k], starts, f"inc_start[{k}]")
        _same(sl.inc[k], codes, f"inc[{k}]")
    if case == "wide_degrees":
        assert max(sl.degrees) > 4 and len(sl.degrees) > 1
        assert any((m.numpy() == 0).any() for m in sl.slot_mask)      # masked slots
        empty = np.diff(sl.inc_start[0].numpy()[:C + 1]) == 0
        assert empty[0] and empty[C - 1]                              # rows with no incidence


def test_bridge_round_trip():
    """A reference plan carried over as numpy equals the port's own."""
    ci, pi, n_obs, C, P = index_maps(gappy_problem(drop_share=0.5))
    kw = dict(symmetric=True, slots=True, pad_multiple=16)
    ref = ref_pairs.build_pair_plan(ci, pi, n_obs, C, P, **kw)
    own = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, with_kernel_plans=True, device="cpu",
                                     **kw)
    carried = plan_to_port(ref, with_kernel_plans=True)
    assert_same_plan(carried, ref)
    _same(carried.seg_start, own.seg_start.numpy(), "seg_start")
    _same(carried.track.key_start, own.track.key_start.numpy(), "key_start")
    for a, b in zip(carried.slot.inc_start, own.slot.inc_start):
        _same(a, b.numpy(), "inc_start")
    for a, b in zip(carried.slot.inc, own.slot.inc):
        _same(a, b.numpy(), "inc")
    assert carried.slot.spans == own.slot.spans
    _same(carried.slot.off_idx, own.slot.off_idx.numpy(), "off_idx")
    with pytest.raises(KeyError):
        port_pairs.pair_plan_from_numpy({}, device="cpu")
