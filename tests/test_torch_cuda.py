"""The CUDA kernels on the card against their plain PyTorch versions.

Every test here needs a CUDA card and nvcc: they carry the ``cuda`` marker
and skip, with a reason, where there is no card. The file imports no JAX, so
on a machine without JAX it runs without the repository's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs are f32 on the card; the reference is the plain version in f64 on the
same inputs. Errors are max|kernel − ref| / max|ref| per output array, held
to the tolerances ``chip_smoke.py`` states and explains: 1e-5 for sums and
the cost, 1e-4 for the linearization without a robust loss and 5e-3 with
one. The band builds (K5–K7) invert ill-conditioned 3×3 point blocks at
small λ, where any f32 result is far from f64 and two orders of evaluation
differ by a few times in their largest error: row by row of the output (a
block entry over all cameras or segments, on its own scale) the worst is held
to 1e-5 or ten times the worst row of the plain version run in f32, whichever
is larger.
``test_torch_kernels.py``, ``test_torch_bandblocks.py`` and
``test_torch_pcg_band.py`` hold the plain versions against the reference's
Pallas kernels on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_ba_torch.checkpoint import load_checkpoint, save_checkpoint
from tpu_ba_torch.core import LMConfig, make_problem
from tpu_ba_torch.io.bal import load_bal, make_bal_like_problem, save_bal
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.jacobians import jacobian_blocks_bal, jacobian_blocks_bal_autodiff
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.linearize import (fused_cost, fused_cost_plain,
                                            fused_linearize_assemble,
                                            fused_linearize_assemble_plain, linearize_schedule)
from tpu_ba_torch.kernels.pairblocks import (fused_pair_blocks, fused_pair_blocks_plain,
                                             pair_schedule)
from tpu_ba_torch.kernels import pcg_band as pcg_band_mod
from tpu_ba_torch.kernels.pcg_band import fold_damp_prologue, pcg_banded, pcg_banded_plain
from tpu_ba_torch.kernels.segsum import (BLOCK_LOG2, group_log2, segment_sum_t,
                                         sorted_segment_sum_t, sorted_segment_sum_t_plain)
from tpu_ba_torch.kernels.slotband import slot_band_blocks, slot_band_blocks_plain
from tpu_ba_torch.kernels.trackband import fused_track_blocks, fused_track_blocks_plain
from tpu_ba_torch.solver import pairs as pairs_mod
from tpu_ba_torch.solver import pcg as pcg_mod
from tpu_ba_torch.solver import slots as slots_mod
from tpu_ba_torch.solver.batched_linalg import inv_spd_small
from tpu_ba_torch.solver.lm import build_solver_plans, solve
from tpu_ba_torch.solver.normal import assemble, damp_blocks
from tpu_ba_torch.solver.plans import build_plans, pt_segsum_t
from tpu_ba_torch.solver.schur import inv3x3_rows, schur_rhs
from tpu_ba_torch.solver.tridiag import pcr_factor, tridiag_from_band

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(their plain versions are tested in test_torch_kernels.py)")
    return torch.device("cuda")


def _rel_err(out, ref):
    return (out.double() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-300)


@pytest.mark.parametrize("O,N,D,skew", [
    (4096, 37, 12, False),     # camera-like: few long segments (a full warp each)
    (4096, 1500, 3, False),    # point-like: many short segments
    (8192, 300, 81, True),     # skewed lengths, wide D
    (1000, 1, 1, False),       # one segment
    (777, 2000, 9, False),     # more segments than observations: many empty
    (20000, 3, 9, False),      # runs of thousands: longer than a block's stride of 512
    (4099, 40, 4, True),       # rows of 4,099 floats: every row's runs start unaligned
    (3000, 700, 7, False),     # a row count that only 1 divides
])
def test_segsum_kernel_matches_plain(dev, O, N, D, skew):
    rng = np.random.default_rng(O + N)
    if skew:
        sizes = rng.integers(1, 10, N).astype(np.float64)
        sizes[: max(N // 50, 1)] *= 100
        keys = np.sort(rng.choice(N, O, p=sizes / sizes.sum()))
    else:
        keys = np.sort(rng.integers(0, N, O))
    starts = np.searchsorted(keys, np.arange(N + 1)).astype(np.int32)
    vals = torch.tensor(rng.standard_normal((D, O)), dtype=torch.float32, device=dev)
    keys_t = torch.tensor(keys, dtype=torch.int64, device=dev)
    before = _lib.launches["segsum"]
    out = sorted_segment_sum_t(vals, keys_t, N, torch.tensor(starts, device=dev))
    torch.cuda.synchronize()
    assert _lib.launches["segsum"] == before + 1
    ref = sorted_segment_sum_t_plain(vals.double(), keys_t, N)
    assert _rel_err(out, ref) <= 1e-5
    empty = np.diff(starts) == 0
    assert torch.all(out[:, torch.tensor(empty, device=dev)] == 0)


@pytest.mark.parametrize("schedule", [0, 1, 3, 5, BLOCK_LOG2])
@pytest.mark.parametrize("with_perm", [False, True], ids=["sorted", "perm"])
def test_segsum_kernel_schedules_agree(dev, schedule, with_perm):
    """Every schedule (lanes per segment, or a block per segment) on runs of
    0 to ~900 observations that start at any alignment, with and without the
    fused gather: each within 1e-5 of f64, empty segments exactly 0, the same
    bits on a second run."""
    rng = np.random.default_rng(11)
    N, D = 150, 6
    lens = rng.integers(0, 40, N)
    lens[::17] = rng.integers(300, 900, len(lens[::17]))
    lens[5] = 0
    O = int(lens.sum())
    keys = np.repeat(np.arange(N), lens)
    starts = torch.tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32), device=dev)
    vals = torch.tensor(rng.standard_normal((D, O)), dtype=torch.float32, device=dev)
    keys_t = torch.tensor(keys, dtype=torch.int32, device=dev)
    perm = torch.tensor(rng.permutation(O).astype(np.int32), device=dev) if with_perm else None
    out = sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm, schedule=schedule)
    ref = sorted_segment_sum_t_plain(vals.double(), keys_t, N, perm=perm)
    assert _rel_err(out, ref) <= 1e-5
    assert torch.all(out[:, torch.tensor(lens == 0, device=dev)] == 0)
    assert torch.equal(out, sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm,
                                                 schedule=schedule))


@pytest.mark.parametrize("stretch,want", [(394, 5), (60000, BLOCK_LOG2)], ids=["even", "skewed"])
@pytest.mark.parametrize("with_perm", [False, True], ids=["sorted", "perm"])
def test_segsum_kernel_schedule_from_longest(dev, stretch, want, with_perm):
    """The wrapper's schedule from the plan's longest segment: even camera
    runs of 394 take a warp each, one run of 60,000 among them brings blocks;
    either way the sums are those of the plain version."""
    N, D = 1723, 9
    lens = np.full(N, 394)
    lens[800] = stretch
    O = int(lens.sum())
    assert group_log2(O, N, D, int(lens.max()), gathered=with_perm) == want
    rng = np.random.default_rng(stretch)
    starts = torch.tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32), device=dev)
    keys_t = torch.tensor(np.repeat(np.arange(N), lens).astype(np.int32), device=dev)
    vals = torch.tensor(rng.standard_normal((D, O)), dtype=torch.float32, device=dev)
    perm = torch.tensor(rng.permutation(O).astype(np.int32), device=dev) if with_perm else None
    out = sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm, longest=int(lens.max()))
    forced = sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm, schedule=want)
    assert torch.equal(out, forced)
    assert _rel_err(out, sorted_segment_sum_t_plain(vals.double(), keys_t, N, perm=perm)) <= 1e-5


@pytest.mark.parametrize("D,O,N", [(3, 678912, 156502), (12, 678912, 156502),
                                   (9, 665600, 1779)],
                         ids=["back_substitution", "point_blocks", "compact_matvec_by_cj"])
def test_segsum_kernel_gathers_through_perm(dev, D, O, N):
    """The fused gather at the main paths' shapes: the point-keyed sums of
    ladybug-1723's camera-sorted observations, and the column-camera sum of
    venice-1778-community's compact matvec. One launch, no gathered copy; the
    bits of the old route (index, then the kernel on the copy) where a group
    of lanes walks a run either way; a block reads a gathered run by scalars
    and a contiguous one by 16-byte loads, another order of the same sum."""
    rng = np.random.default_rng(D)
    keys_unsorted = rng.integers(0, N, O)
    perm = np.argsort(keys_unsorted, kind="stable")
    keys = keys_unsorted[perm]
    starts = torch.tensor(np.searchsorted(keys, np.arange(N + 1)).astype(np.int32), device=dev)
    keys_t = torch.tensor(keys, dtype=torch.int32, device=dev)
    perm_t = torch.tensor(perm.astype(np.int32), device=dev)
    vals = torch.tensor(rng.standard_normal((D, O)), dtype=torch.float32, device=dev)
    before = _lib.launches["segsum"]
    out = sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm_t)
    assert _lib.launches["segsum"] == before + 1
    ref = sorted_segment_sum_t_plain(vals.double(), keys_t, N, perm=perm_t)
    assert out.shape == (D, N) and _rel_err(out, ref) <= 1e-5
    old_route = sorted_segment_sum_t(vals[:, perm_t.long()], keys_t, N, starts)
    if group_log2(O, N, D) != BLOCK_LOG2:
        assert torch.equal(out, old_route)
    assert _rel_err(out, old_route.double()) <= 1e-6
    with pytest.raises(TypeError):          # an int64 permutation: the kernel reads int32
        sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm_t.long())
    with pytest.raises(ValueError):         # a permutation of another length
        sorted_segment_sum_t(vals, keys_t, N, starts, perm=perm_t[:-1])


def test_point_keyed_sum_is_one_kernel(dev):
    """``pt_segsum_t`` on the card: K1 once, reading through ``perm_pt``,
    and no other device kernel (no ``index`` gather before it)."""
    p, C = _problem(dev)
    plans = build_plans(p.cam_idx, p.pt_idx, C, p.n_points)
    vals = torch.randn((12, p.obs_2d.shape[0]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4))
    pt_segsum_t(plans, vals, p.pt_idx, p.n_points)      # builds and loads the library
    torch.cuda.synchronize()
    before = _lib.launches["segsum"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = pt_segsum_t(plans, vals, p.pt_idx, p.n_points)
        torch.cuda.synchronize()
    assert _lib.launches["segsum"] == before + 1
    ops = [e.key for e in prof.key_averages() if e.key.startswith("aten::")]
    assert not any("index" in k or "gather" in k for k in ops), ops
    ref = sorted_segment_sum_t_plain(vals.double(), p.pt_idx, p.n_points)
    assert _rel_err(out, ref) <= 1e-5


def _problem(dev, n_cameras=8):
    """Synthetic problem, 160 observations padded to 256, with two cameras
    that nothing observes (empty segments in the kernel's camera walk)."""
    p, _ = make_synthetic_problem(6, 40, obs_per_point=4, pixel_noise=0.5, seed=12,
                                  pad_multiple=128, device=dev)
    cams = torch.cat([p.cameras, p.cameras[:n_cameras - 6]])
    return p.with_params(cams, p.points), n_cameras


@pytest.mark.parametrize("robust,case", [
    (0, "plain"), (1, "plain"), (2, "plain"), (3, "plain"),
    (1, "frozen"), (0, "theta0"), (3, "theta_under"), (2, "theta_over"),
])
def test_linearize_and_cost_kernels_match_plain(dev, robust, case):
    p, C = _problem(dev)
    if case.startswith("theta"):
        t2 = {"theta0": 0.0, "theta_under": 0.99e-12, "theta_over": 1.01e-12}[case]
        cams = p.cameras.clone()
        cams[:, 0:3] = float(np.sqrt(t2 / 3.0))
        p = p.with_params(cams, p.points)
    freeze = (7, 8) if case == "frozen" else ()
    kw = dict(robust_kind=robust, robust_scale=2.0)
    args = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    args64 = (p.cameras.double(), p.points.double(), p.obs_2d.double()) + args[3:]
    plans = build_plans(p.cam_idx, p.pt_idx, C, p.n_points)
    out = fused_linearize_assemble(*args, plans.cam_start, sched=plans.lin_sched,
                                   freeze_cols=freeze, **kw)
    ref = fused_linearize_assemble_plain(*args64, freeze_cols=freeze, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if robust == 0 else 5e-3
    for name, o, r in zip(("U", "gc", "W", "pt_vals"), out, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape, name
        assert _rel_err(o, r) <= tol, name
    U, gc, W, pt_vals = out
    assert torch.all(U[6:] == 0) and torch.all(gc[6:] == 0)   # unobserved cameras
    pad = ~p.mask
    assert torch.all(W[:, pad] == 0) and torch.all(pt_vals[:, pad] == 0)
    if freeze:
        assert torch.all(U[:, 7:9, :] == 0) and torch.all(U[:, :, 7:9] == 0)
        assert torch.all(gc[:, 7:9] == 0)
    cost = fused_cost(*args, sched=plans.lin_sched, **kw)
    assert cost.shape == () and cost.dtype == torch.float32
    assert abs(cost.item() - fused_cost_plain(*args64, **kw).item()) <= \
        1e-5 * abs(fused_cost_plain(*args64, **kw).item())


def _lin_layout(dev, pad):
    """Observations of a 6-camera synthetic problem dealt to 10 cameras,
    each a copy of a base camera: cameras 1, 5 and 9 (the last) empty,
    camera 2 holds base camera 0's observations 40 times over (~8,000, more
    than ten pieces), camera 3 base camera 1's three times (two pieces);
    each repeat with fresh pixel noise. With ``pad`` the rows are padded to
    a multiple of 128 (mask 0, the last observed camera's and point's index)."""
    base, _ = make_synthetic_problem(6, 300, obs_per_point=4, pixel_noise=0.5, seed=21,
                                     device="cpu")
    n = base.n_obs
    obs, ci, pi = base.obs_2d.numpy()[:n], base.cam_idx.numpy()[:n], base.pt_idx.numpy()[:n]
    src = (0, -1, 0, 1, 2, -1, 3, 4, 5, -1)                  # base camera of each; -1: empty
    reps = {2: 40, 3: 3}
    rng = np.random.default_rng(7)
    parts = []
    for k, b in enumerate(src):
        if b >= 0:
            sel = np.tile(np.flatnonzero(ci == b), reps.get(k, 1))
            parts.append((obs[sel] + rng.normal(0.0, 0.5, (sel.size, 2)).astype(np.float32),
                          np.full(sel.size, k), pi[sel]))
    o, c, q = (np.concatenate(a) for a in zip(*parts))
    return make_problem(base.cameras.numpy()[[max(b, 0) for b in src]], base.points.numpy(), o,
                        c, q, pad_multiple=128 if pad else 1, device=dev)


def _worst_row(out, ref):
    """Worst row's max abs error over that row's max |ref| (a row of U or
    gc: one entry over all cameras); a row whose reference is all zero must
    be exactly zero."""
    d = (out.double() - ref).abs().amax(1)
    scale = ref.abs().amax(1)
    rel = d / scale.clamp_min(1e-300)
    rel[(scale == 0) & (d > 0)] = float("inf")
    rel[(scale == 0) & (d == 0)] = 0.0
    return rel.max().item()


def _rows(t):
    """An output of K2 as rows: U (C,9,9) → (81, C), gc (C,9) → (9, C); W and
    pt_vals are rows already."""
    return t.reshape(t.shape[0], -1).T if t.shape[-1] == 9 else t


@pytest.mark.parametrize("robust,pad,freeze", [
    (0, True, ()), (1, True, (7, 8)), (2, False, ()), (3, False, (0, 6)), (0, False, (3,)),
])
def test_linearize_and_cost_over_pieces(dev, robust, pad, freeze):
    """K2 and K3 over a schedule with empty cameras, one camera of many
    pieces and one of two: each output row against the plain version in
    f64, within ten times the plain f32 version's worst row (1e-5 at
    least); two calls give the same bits; one launch a call."""
    p = _lin_layout(dev, pad)
    C = p.n_cameras
    plans = build_plans(p.cam_idx, p.pt_idx, C, p.n_points)
    sched = plans.lin_sched
    n_pieces = sched.piece_start.diff().cpu()
    assert n_pieces.max() > 10 and n_pieces[3] == 2 and sched.empty.tolist() == [1, 5, 9]
    assert bool((~p.mask).any()) == pad
    kw = dict(robust_kind=robust, robust_scale=2.0)
    args = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    args64 = (p.cameras.double(), p.points.double(), p.obs_2d.double()) + args[3:]
    before = dict(_lib.launches)
    out = fused_linearize_assemble(*args, plans.cam_start, sched=sched, freeze_cols=freeze, **kw)
    again = fused_linearize_assemble(*args, plans.cam_start, sched=sched, freeze_cols=freeze,
                                     **kw)
    cost = fused_cost(*args, sched=sched, **kw)
    cost_again = fused_cost(*args, sched=sched, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["linearize"] == before["linearize"] + 2
    assert _lib.launches["cost"] == before["cost"] + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again)) and torch.equal(cost, cost_again)
    ref = fused_linearize_assemble_plain(*args64, freeze_cols=freeze, **kw)
    plain = fused_linearize_assemble_plain(*args, freeze_cols=freeze, **kw)
    for name, o, r, q in zip(("U", "gc", "W", "pt_vals"), out, ref, plain):
        worst, plain_worst = _worst_row(_rows(o), _rows(r)), _worst_row(_rows(q), _rows(r))
        assert worst <= max(1e-5, 10 * plain_worst), (name, worst, plain_worst)
    U, gc, W, pt_vals = out
    assert torch.all(U[[1, 5, 9]] == 0) and torch.all(gc[[1, 5, 9]] == 0)
    assert torch.all(W[:, ~p.mask] == 0) and torch.all(pt_vals[:, ~p.mask] == 0)
    for col in freeze:
        assert torch.all(U[:, col, :] == 0) and torch.all(U[:, :, col] == 0)
        assert torch.all(gc[:, col] == 0)
    c64 = fused_cost_plain(*args64, **kw).item()
    c32 = fused_cost_plain(*args, **kw).item()
    assert abs(cost.item() - c64) <= max(1e-6, 10 * abs(c32 - c64) / abs(c64)) * abs(c64)


def test_linearize_and_cost_refuse_a_missing_or_foreign_schedule(dev):
    p = _lin_layout(dev, True)
    plans = build_plans(p.cam_idx, p.pt_idx, p.n_cameras, p.n_points)
    args = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    other = linearize_schedule(plans.cam_start[:-1], device=dev)     # one camera fewer
    before = dict(_lib.launches)
    for sched in (None, other):
        with pytest.raises(ValueError, match="linearize schedule"):
            fused_linearize_assemble(*args, plans.cam_start, sched=sched)
        with pytest.raises(ValueError, match="linearize schedule"):
            fused_cost(*args, sched=sched)
    assert _lib.launches == before


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    p, C = _problem(dev)
    plans = build_plans(p.cam_idx, p.pt_idx, C, p.n_points)
    args = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    before = dict(_lib.launches)
    with pytest.raises(TypeError):          # f64 on the card: no quiet plain version
        fused_cost(p.cameras.double(), *args[1:], sched=plans.lin_sched)
    with pytest.raises(ValueError):         # a schedule left on the CPU
        fused_linearize_assemble(*args, plans.cam_start,
                                 sched=linearize_schedule(plans.cam_start))
    with pytest.raises(ValueError):         # a non-contiguous payload
        sorted_segment_sum_t(torch.zeros((p.obs_2d.shape[0], 3), device=dev).T,
                             p.cam_idx, C, plans.cam_start)
    assert _lib.launches == before


def test_solve_on_the_card_matches_the_plain_versions(dev):
    """The whole slice in f32: the kernels on the card against the plain
    versions on the CPU, from the same problem. Summation order differs, so
    the trajectories agree to f32 rounding, not bit for bit: on the CPU the
    two tiers' f32 final costs differ by ~3e-5 relative, from each other and
    from f64, so 5e-4; at λ₀ = 10 the counts do not hinge on rounding."""
    cfg = LMConfig(max_iters=6, init_lambda=10.0, linear_solver="schur_pcg_pallas")
    p_cpu, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device="cpu")
    p_dev, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    _lib.reset_launches()
    res = solve(p_dev, cfg)
    launched = dict(_lib.launches)
    ref = solve(p_cpu, cfg)
    assert all(launched[k] > 0 for k in ("segsum", "linearize", "cost")), launched
    assert _lib.launches == launched        # the CPU solve launched nothing
    assert int(res.iterations) == int(ref.iterations) == 6
    assert int(res.accepted) == int(ref.accepted)
    np.testing.assert_allclose(res.cost.item(), ref.cost.item(), rtol=5e-4)
    assert res.cost.item() < res.initial_cost.item()


# ---- the sparse-Schur tier: K7, K5, K6 (band builds) and K4 (banded PCG) ----

FLOOR, CEIL = 1e-6, 1e32
BAND_KW = dict(dc=9, diag_floor=FLOOR, diag_ceil=CEIL)


def _incidence(case):
    """(n_cameras, points' camera lists) of a small problem that engages the
    named structure."""
    rng = np.random.default_rng(7)
    if case == "ring":            # 23 cameras: consecutive tracks, wrapped points as pairs
        C = 23
        return C, [np.sort((c + np.arange(4)) % C) for c in range(C) for _ in range(5)]
    if case == "line":            # no wrap: tracks of length 2–4, one ends at the last camera
        C = 19
        rows = [np.arange(c, min(c + d, C)) for c in range(C - 1) for d in (2, 3, 4)]
        return C, rows + [np.arange(C - 4, C)]
    if case == "gappy":           # 4 of a 6-wide window: gaps (slots), some consecutive
        C = 37
        rows = []
        for c in range(C):
            for k in range(6):
                take = np.sort(rng.choice(6, 4, replace=False)) if k % 2 else np.arange(4)
                rows.append(np.sort((c + np.arange(6))[take] % C))
        return C, rows
    if case == "wide":            # 200 cameras: the PCG grid has 13 blocks
        C = 200
        return C, [np.sort((c + np.sort(rng.choice(5, 3, replace=False))) % C)
                   for c in range(C) for _ in range(3)]
    if case == "diagonal":        # every point seen once: a band of the one offset 0
        C = 11
        return C, [np.array([c]) for c in range(C) for _ in range(4)]
    if case.startswith("slots"):  # degrees 2–16 in 17-wide windows; cameras 0–2 and the last
        C = 64                    # 8 hold no point; seeded by the case's suffix
        rng = np.random.default_rng(int(case[5:]))
        return C, [np.sort(c + rng.choice(17, deg, replace=False))
                   for c in range(3, C - 8 - 16) for deg in rng.integers(2, 17, 5)]
    if case.startswith("tracks"):  # consecutive tracks of degree 1–8 from 30 cameras: runs of
        C = 30                     # 0–56 points a key, empty keys, a key of 150 (over three
        rng = np.random.default_rng(int(case[6:]))     # chunks); seeded by the case's suffix;
        rows = []                  # under 1,000 points, so that no point repeats (see below)
        for c in range(C):
            n = 150 if c == 5 else (0 if rng.random() < 0.2 else int(rng.integers(0, 57)))
            degs = np.minimum(rng.integers(1, 9, n), C - c)   # tracks end at the last camera
            if c == 5:
                degs[:8] = np.arange(1, 9)
            rows += [np.arange(c, c + d) for d in degs]
        return C, rows
    if case == "long":            # 30,011 cameras: more camera groups than resident PCG blocks
        C = 30011
        return C, [np.arange(c, min(c + 3, C)) for c in range(C)]
    if case == "leftover":        # 36 offsets: the band is capped at 32, the rest is off-band
        C = 40
        return C, [np.array([c, c + k]) for c in range(C) for k in range(1, 36) if c + k < C]
    raise KeyError(case)


def _band_system(dev, case, **plan_kw):
    """A BlockSystem on the card (f32) and its pair plan with kernel plans."""
    C, rows = _incidence(case)
    P = len(rows)
    # the generator walks its cameras one by one: a large case repeats a small scene
    base, _ = make_synthetic_problem(min(C, 200), min(P, 1000), obs_per_point=1, pixel_noise=0.5,
                                     seed=3, device="cpu")
    cams = base.cameras.numpy()[np.arange(C) % base.n_cameras]
    pts = base.points.numpy()[np.arange(P) % base.n_points]
    ci = np.concatenate(rows)
    pi = np.repeat(np.arange(P), [len(r) for r in rows])
    obs = np.random.default_rng(5).normal(0.0, 50.0, (ci.size, 2))
    p = make_problem(cams, pts, obs, ci, pi, pad_multiple=8, device=dev)
    r, Jc, Jp = jacobian_blocks_bal(p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    B = assemble(r, Jc, Jp, p.cam_idx, p.pt_idx, C, P, mask=p.mask)
    B = B._replace(U=B.U.contiguous(), W=B.W.contiguous())
    kw = dict(symmetric=True, pad_multiple=16, with_kernel_plans=True)
    kw.update(plan_kw)
    plan = pairs_mod.build_pair_plan(p.cam_idx, p.pt_idx, p.n_obs, C, P, **kw)
    return B, plan


def _f64(B):
    return B._replace(U=B.U.double(), V=B.V.double(), W=B.W.double(), gc=B.gc.double(),
                      gp=B.gp.double())


def _rel_err_rows(out, ref):
    """The worst row's max|out − ref| / max|ref|, a row being one block entry
    (and band offset) over all cameras or segments: the entries of a 9×9
    block span orders of magnitude, so each is held on its own scale. A row
    whose reference is all zero must be exactly zero."""
    d = (out.double() - ref).abs().amax(1)
    scale = ref.abs().amax(1)
    assert torch.all(d[scale == 0] == 0)
    return (d / scale.clamp_min(1e-300)).max().item()


def _held_to_plain_f32(out, plain32, ref64, what):
    """The kernel's worst row against f64 within 1e-5 or ten times the plain
    f32 version's own worst row."""
    tol = max(1e-5, 10.0 * _rel_err_rows(plain32, ref64))
    assert _rel_err_rows(out, ref64) <= tol, (what, _rel_err_rows(out, ref64), tol)


@pytest.mark.parametrize("case,plan_kw", [
    ("ring", {}), ("line", {}), ("gappy", dict(slots=True)),
    ("gappy", dict(slots=True, tracks=False)), ("wide", dict(slots=True)), ("diagonal", {}),
], ids=["ring", "line", "gappy", "gappy_slots_only", "wide", "diagonal"])
def test_band_build_kernels_match_plain(dev, case, plan_kw):
    B, plan = _band_system(dev, case, **plan_kw)
    B64 = _f64(B)
    pd, pd64 = pairs_mod.precompute_pair_data(B, plan), pairs_mod.precompute_pair_data(B64, plan)
    if case == "gappy":
        assert plan.slot is not None and (plan.track is not None) == ("tracks" not in plan_kw)
        assert any((m == 0).any() for m in plan.slot.slot_mask)       # masked slots
    if case == "line":
        # a track of length 2 starts at the last camera but one and ends at the last
        assert plan.track is not None and \
            plan.track.keys[:plan.track.n_tracked].max() == plan.n_cameras - 2
        assert (plan.track.slot_mask == 0).any()
    before = dict(_lib.launches)
    for lam in (1e-4, 1.0):
        lam32 = torch.tensor(lam, device=dev)
        lam64 = lam32.double()
        out = fused_pair_blocks(pd.packed, plan.pair_seg, lam32, plan.k_pad, plan.pair_sched,
                                **BAND_KW)
        again = fused_pair_blocks(pd.packed, plan.pair_seg, lam32, plan.k_pad, plan.pair_sched,
                                  **BAND_KW)
        assert torch.equal(out, again)                                 # the same bits every run
        ref = fused_pair_blocks_plain(pd64.packed, plan.pair_seg, lam64, plan.k_pad, **BAND_KW)
        plain = fused_pair_blocks_plain(pd.packed, plan.pair_seg, lam32, plan.k_pad, **BAND_KW)
        # the kernel leaves the trash segment of the padding pairs zero
        assert torch.all(out[:, -1] == 0)
        ref[:, -1] = 0
        plain[:, -1] = 0
        if ref.abs().max() > 0:
            _held_to_plain_f32(out, plain, ref, "pairblocks")
        empty = torch.ones(plan.k_pad, dtype=torch.bool, device=dev)
        n_real = int((plan.pair_key < plan.n_cameras ** 2).sum())
        empty[plan.pair_seg[:n_real].long()] = False
        assert torch.all(out[:, empty] == 0)                           # empty segments exact zeros
        if plan.track is not None:
            out = fused_track_blocks(pd.trk_W, pd.trk_V, lam32, plan.track, **BAND_KW)
            assert torch.equal(out, fused_track_blocks(pd.trk_W, pd.trk_V, lam32, plan.track,
                                                       **BAND_KW))
            ref = fused_track_blocks_plain(pd64.trk_W, pd64.trk_V, lam64, plan.track, **BAND_KW)
            plain = fused_track_blocks_plain(pd.trk_W, pd.trk_V, lam32, plan.track, **BAND_KW)
            _held_to_plain_f32(out, plain, ref, "trackband")
            assert torch.all(out[:, ref.abs().sum(0) == 0] == 0)
        if plan.slot is not None:
            out = slot_band_blocks(pd.slot_W, pd.slot_V, lam32, plan.slot, **BAND_KW)
            assert torch.equal(out, slot_band_blocks(pd.slot_W, pd.slot_V, lam32, plan.slot,
                                                     **BAND_KW))
            ref = slot_band_blocks_plain(pd64.slot_W, pd64.slot_V, lam64, plan.slot, **BAND_KW)
            plain = slot_band_blocks_plain(pd.slot_W, pd.slot_V, lam32, plan.slot, **BAND_KW)
            _held_to_plain_f32(out, plain, ref, "slotband")
            assert torch.all(out[:, ref.abs().sum(0) == 0] == 0)
        # the assembled band: kernels against plain versions
        blk = pairs_mod._compact_blocks(B, lam32, plan, pd, FLOOR, CEIL)
        assert torch.equal(blk, pairs_mod._compact_blocks(B, lam32, plan, pd, FLOOR, CEIL))
        bare = pairs_mod.build_pair_plan(
            B.cam_idx, B.pt_idx, int((B.W.abs().sum(0) > 0).sum()), plan.n_cameras,
            B.V.shape[1], **dict(dict(symmetric=True, pad_multiple=16), **plan_kw))
        ref = pairs_mod._compact_blocks(B64, lam64, bare, pd64, FLOOR, CEIL)
        plain = pairs_mod._compact_blocks(B, lam32, bare, pd, FLOOR, CEIL)
        _held_to_plain_f32(blk, plain, ref, "blk")
    torch.cuda.synchronize()
    assert _lib.launches["pairblocks"] == before["pairblocks"] + 8
    assert (_lib.launches["trackband"] > before["trackband"]) == (plan.track is not None)
    assert (_lib.launches["slotband"] > before["slotband"]) == (plan.slot is not None)


def _long_segment_pairs(seed=4):
    """(pair_seg, packed (63, Np) f64, k_pad, n_real): 700 segments of
    heavy-tailed lengths, a fifth of them empty, one of 24,000 pairs (many
    pieces of K7's schedule), and padding pairs in the trash segment."""
    rng = np.random.default_rng(seed)
    k_pad = 700
    lens = np.minimum(rng.zipf(1.7, k_pad), 600)
    lens[rng.random(k_pad) < 0.2] = 0
    lens[350] = 24000
    lens[-1] = 0
    seg = np.repeat(np.arange(k_pad), lens)
    n_real = seg.size
    seg = np.concatenate([seg, np.full(100, k_pad - 1)])
    W = rng.normal(0.0, 1.0, (54, seg.size))
    A = rng.normal(0.0, 1.0, (3, 3, seg.size))
    V = np.einsum("abn,cbn->acn", A, A) + 0.1 * np.eye(3)[:, :, None]
    return seg, np.concatenate([W, V.reshape(9, -1)]), k_pad, n_real


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_pair_kernel_splits_a_long_segment(dev, lam):
    """A segment of 24,000 pairs among hundreds of short and empty ones: the
    kernel works it in pieces and adds them in order, against the plain
    version in f64; the same bits twice; empty and trash segments exactly 0;
    one launch a call; no call without the schedule."""
    seg_np, packed_np, k_pad, n_real = _long_segment_pairs()
    starts = np.searchsorted(seg_np[:n_real], np.arange(k_pad + 1), side="left")
    sched = pair_schedule(starts, device=dev)
    assert sched.pieces.shape[1] > 20 and sched.empty.shape[0] > 100
    seg = torch.as_tensor(seg_np.astype(np.int32), device=dev)
    packed = torch.as_tensor(packed_np, dtype=torch.float32, device=dev)
    lam32 = torch.tensor(lam, device=dev)
    before = _lib.launches["pairblocks"]
    out = fused_pair_blocks(packed, seg, lam32, k_pad, sched, **BAND_KW)
    assert torch.equal(out, fused_pair_blocks(packed, seg, lam32, k_pad, sched, **BAND_KW))
    torch.cuda.synchronize()
    assert _lib.launches["pairblocks"] == before + 2
    ref = fused_pair_blocks_plain(packed.double(), seg, lam32.double(), k_pad, **BAND_KW)
    plain = fused_pair_blocks_plain(packed, seg, lam32, k_pad, **BAND_KW)
    ref[:, -1] = 0
    plain[:, -1] = 0
    assert torch.all(out[:, torch.as_tensor(np.diff(starts) == 0, device=dev)] == 0)
    assert torch.all(out[:, -1] == 0)
    _held_to_plain_f32(out, plain, ref, "pairblocks")
    with pytest.raises(ValueError):
        fused_pair_blocks(packed, seg, lam32, k_pad, None, **BAND_KW)
    assert _lib.launches["pairblocks"] == before + 2


def test_slot_kernel_drops_an_offset_without_a_band_slot(dev):
    """Offset 4 is left out of the band: its products go nowhere, as in the
    plain version, and the other cells are untouched by that."""
    B, plan = _band_system(dev, "gappy", slots=True, tracks=False)
    ci, pi = B.cam_idx.cpu().numpy(), B.pt_idx.cpu().numpy()
    n_obs = int((B.W.abs().sum(0) > 0).sum().item())
    sb = slots_mod.select_slot_buckets(ci, pi, n_obs, B.V.shape[1])
    band = tuple(o for o in plan.band_offsets if o != 4)
    assert 4 in plan.band_offsets
    layout = slots_mod.finalize_slot_layout(sb, band, plan.c_pad, device=dev)
    Ws, Vs = slots_mod.gather_slot_data(B.W, B.V, layout)
    W64, V64 = [w.double() for w in Ws], [v.double() for v in Vs]
    lam = torch.tensor(1e-2, device=dev)
    out = slot_band_blocks(Ws, Vs, lam, layout, **BAND_KW)
    ref = slot_band_blocks_plain(W64, V64, lam.double(), layout, **BAND_KW)
    _held_to_plain_f32(out, slot_band_blocks_plain(Ws, Vs, lam, layout, **BAND_KW), ref, "slot")
    assert out.shape == (81, len(band) * plan.c_pad)


def test_slot_kernel_adds_into_the_band_it_is_given(dev):
    """``out=``: the contributions land on top of what the band holds, in its
    first k_band columns, and the columns behind them are left alone."""
    B, plan = _band_system(dev, "gappy", slots=True)
    pd = pairs_mod.precompute_pair_data(B, plan)
    lam = torch.tensor(1e-2, device=dev)
    fresh = slot_band_blocks(pd.slot_W, pd.slot_V, lam, plan.slot, **BAND_KW)
    band = torch.randn((81, plan.k_pad), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    want = band.clone()
    want[:, :plan.k_band] += fresh
    before = _lib.launches["slotband"]
    got = slot_band_blocks(pd.slot_W, pd.slot_V, lam, plan.slot, out=band, **BAND_KW)
    assert got is band and torch.equal(band, want) and plan.k_pad > plan.k_band
    assert _lib.launches["slotband"] == before + len(plan.slot.degrees)
    with pytest.raises(ValueError):         # a band narrower than the grid
        slot_band_blocks(pd.slot_W, pd.slot_V, lam, plan.slot,
                         out=band[:, :plan.k_band - 1].contiguous(), **BAND_KW)
    with pytest.raises(ValueError):         # a view with gaps between its rows
        slot_band_blocks(pd.slot_W, pd.slot_V, lam, plan.slot, out=band[:, :plan.k_band],
                         **BAND_KW)


@pytest.mark.parametrize("given", [False, True], ids=["fresh", "given"])
@pytest.mark.parametrize("seed", [1, 2])
def test_slot_kernel_on_random_layouts(dev, seed, given):
    """Several buckets up to degree 16, spans up to 16, band rows without
    incidences: K6 per (entry, offset) row against the plain version in f64,
    into a fresh grid or on top of a band it is given, and the same bits on a
    second call."""
    B, plan = _band_system(dev, f"slots{seed}", slots=True, tracks=False)
    sl = plan.slot
    assert len(sl.degrees) > 2 and max(sl.degrees) == 16 and max(sl.spans) == 16
    assert any((m == 0).any() for m in sl.slot_mask)
    assert (sl.inc_start[0][1:] == sl.inc_start[0][:-1]).any()          # a row without incidences
    pd, pd64 = pairs_mod.precompute_pair_data(B, plan), pairs_mod.precompute_pair_data(_f64(B), plan)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for lam in (1e-4, 1.0):
        lam32 = torch.tensor(lam, device=dev)
        ref = slot_band_blocks_plain(pd64.slot_W, pd64.slot_V, lam32.double(), sl, **BAND_KW)
        plain = slot_band_blocks_plain(pd.slot_W, pd.slot_V, lam32, sl, **BAND_KW)
        if given:
            band = ref.abs().max() * torch.randn((81, plan.k_pad), device=dev, generator=gen)
            band = band.float()
            outs = [slot_band_blocks(pd.slot_W, pd.slot_V, lam32, sl, out=band.clone(), **BAND_KW)
                    for _ in range(2)]
            assert torch.equal(outs[0][:, plan.k_band:], band[:, plan.k_band:])
            ref = band[:, :plan.k_band].double() + ref
            plain = band[:, :plan.k_band] + plain
            outs = [o[:, :plan.k_band] for o in outs]
        else:
            outs = [slot_band_blocks(pd.slot_W, pd.slot_V, lam32, sl, **BAND_KW) for _ in range(2)]
            assert torch.all(outs[0][:, ref.abs().sum(0) == 0] == 0)
        assert torch.equal(outs[0], outs[1])
        _held_to_plain_f32(outs[0], plain, ref, f"slotband lam {lam:g}")


@pytest.mark.parametrize("given", [False, True], ids=["fresh", "given"])
@pytest.mark.parametrize("seed", [1, 2])
def test_track_kernel_on_random_layouts(dev, seed, given):
    """Consecutive tracks of degree 1–8 (the kernel's cap), runs of 0 to 150
    points a key (empty keys, a key over three chunks), tracks that end at the
    last camera: K5 per (entry, offset) row against the plain version in f64,
    into a fresh grid or on top of a band it is given, and the same bits on a
    second call. A given band ends as the band plus the fresh output in its
    layout, bit for bit."""
    B, plan = _band_system(dev, f"tracks{seed}")
    tl = plan.track
    assert tl is not None and tl.dmax == 8 and plan.slot is None
    ks = tl.key_start.cpu().numpy()
    runs = np.diff(ks[:plan.n_cameras + 1])
    assert (runs == 0).any() and runs.max() > 96                     # empty keys, a long run
    deg = tl.slot_mask.sum(0)[:tl.n_tracked]
    assert int((tl.keys[:tl.n_tracked] + deg.int()).max()) == plan.n_cameras   # ends at C−1
    assert set(deg.int().tolist()) == set(range(1, 9))
    pd, pd64 = pairs_mod.precompute_pair_data(B, plan), pairs_mod.precompute_pair_data(_f64(B), plan)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cp = plan.c_pad
    for lam in (1e-4, 1.0):
        lam32 = torch.tensor(lam, device=dev)
        ref = fused_track_blocks_plain(pd64.trk_W, pd64.trk_V, lam32.double(), tl, **BAND_KW)
        plain = fused_track_blocks_plain(pd.trk_W, pd.trk_V, lam32, tl, **BAND_KW)
        fresh = fused_track_blocks(pd.trk_W, pd.trk_V, lam32, tl, **BAND_KW)
        assert fresh.shape == (tl.dmax * 81, cp)
        assert torch.equal(fresh, fused_track_blocks(pd.trk_W, pd.trk_V, lam32, tl, **BAND_KW))
        _held_to_plain_f32(fresh, plain, ref, f"trackband lam {lam:g}")
        assert torch.all(fresh[:, ref.abs().sum(0) == 0] == 0)
        if given:
            band = (ref.abs().max() * torch.randn((81, plan.k_pad), device=dev,
                                                  generator=gen)).float()
            want = band.clone()
            want[:, :tl.dmax * cp] += fresh.reshape(tl.dmax, 81, cp).transpose(0, 1).reshape(81, -1)
            outs = [fused_track_blocks(pd.trk_W, pd.trk_V, lam32, tl, out=band.clone(),
                                       **BAND_KW) for _ in range(2)]
            assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want)
    with pytest.raises(ValueError):          # a band narrower than the grid
        fused_track_blocks(pd.trk_W, pd.trk_V, lam32, tl,
                           out=torch.zeros((81, tl.dmax * cp - 1), device=dev), **BAND_KW)


def _pcg_inputs(dev, case, lam=1.0, **plan_kw):
    B, plan = _band_system(dev, case, **plan_kw)
    assert plan.banded and plan.n_segments <= plan.k_band
    pd = pairs_mod.precompute_pair_data(B, plan)
    lam = torch.tensor(lam, device=dev)
    blk = pairs_mod._compact_blocks(B, lam, plan, pd, FLOOR, CEIL)
    _, Vl = damp_blocks(B, lam, FLOOR, CEIL)
    b = schur_rhs(B, inv3x3_rows(Vl)).contiguous()
    return plan, blk, pd.U_t, b, lam


def _pcg_both(plan, blk, U_t, b, lam, **kw):
    kw = dict(dict(U_t=U_t, lam=lam, diag_floor=FLOOR, diag_ceil=CEIL), **kw)
    reads = pcg_mod.host_reads["cg"]
    out = pcg_banded(blk, None, None, b, plan, **kw)
    assert pcg_mod.host_reads["cg"] == reads            # the kernel reads nothing to the host
    return out, pcg_banded_plain(blk, None, None, b, plan, **kw)


@pytest.mark.parametrize("case,plan_kw", [("ring", {}), ("gappy", dict(slots=True)),
                                          ("wide", dict(slots=True)), ("diagonal", {}),
                                          ("long", {})],
                         ids=["ring_wraparound", "gappy", "wide_13_blocks", "one_offset",
                              "more_groups_than_blocks"])
def test_pcg_kernel_matches_plain(dev, case, plan_kw):
    plan, blk, U_t, b, lam = _pcg_inputs(dev, case, **plan_kw)
    if case == "diagonal":
        assert plan.band_offsets == (0,)
    if case == "ring":
        assert max(plan.band_offsets) == plan.n_cameras - 1
    # a fixed number of iterations: the same arithmetic, in another order
    (x, k, ok), (xp, kp, okp) = _pcg_both(plan, blk, U_t, b, lam, max_iters=5, tol=0.0)
    n_fixed = 5 if case != "diagonal" else int(kp)      # block-Jacobi is exact on a diagonal S
    assert int(k) == int(kp) == n_fixed and bool(ok) and bool(okp)
    assert k.dtype == torch.int32 and ok.dtype == torch.bool and x.shape == b.shape
    assert _rel_err(x, xp.double()) <= 1e-4
    # to convergence: the true residual of the kernel's x in f64 meets the tolerance
    tol = torch.tensor(1e-5, device=dev)
    (x, k, ok), (xp, kp, okp) = _pcg_both(plan, blk, U_t, b, lam, max_iters=300, tol=tol)
    assert bool(ok) and bool(okp) and abs(int(k) - int(kp)) <= 2 and int(k) < 300
    Ul, _ = fold_damp_prologue(blk.double(), U_t.double(), lam.double(), plan.n_cameras, 9,
                               FLOOR, CEIL)
    res = b.double() - pairs_mod.make_banded_matvec(blk.double(), Ul, plan, 9)(x.double())
    assert res.norm() <= 2e-5 * b.double().norm()
    assert _rel_err(x, xp.double()) <= 1e-3
    # the same bits every run
    x2, k2, _ = pcg_banded(blk, None, None, b, plan, max_iters=300, tol=tol, U_t=U_t, lam=lam,
                           diag_floor=FLOOR, diag_ceil=CEIL)
    assert torch.equal(x, x2) and int(k) == int(k2)
    # a warm start that already meets the tolerance takes no iteration
    (x3, k3, ok3), (_, kp3, _) = _pcg_both(plan, blk, U_t, b, lam, max_iters=300, tol=1e-3, x0=x)
    assert int(k3) == int(kp3) == 0 and bool(ok3) and torch.equal(x3, x)
    # no budget: x0 comes back
    (x4, k4, _), _ = _pcg_both(plan, blk, U_t, b, lam, max_iters=0, tol=1e-6, x0=x)
    assert int(k4) == 0 and torch.equal(x4, x)


def _forms_operands(dev, case, kind, plan_kw):
    """Arguments of ``pcg_banded`` for the fold-damp form (K4) or K8's two
    forms on a case of ``_incidence``."""
    s = _given_inputs(dev, case, **plan_kw)
    if kind == "fold":
        return s, (s["blk"], None, None, s["b"], s["plan"]), dict(
            U_t=s["U_t"], lam=s["lam"], diag_floor=FLOOR, diag_ceil=CEIL)
    if kind == "given":
        return s, (s["blk"], s["Ul"], s["Minv"], s["b"], s["plan"]), {}
    assert s["pcr"] is not None
    return s, (s["blk"], s["Ul"], None, s["b"], s["plan"]), dict(tridiag=s["pcr"])


@pytest.mark.parametrize("kind", ["fold", "given", "tridiag"])
@pytest.mark.parametrize("case,plan_kw,fits", [
    ("ring", {}, True), ("gappy", dict(slots=True), True), ("wide", dict(slots=True), True),
    ("leftover", {}, True), ("long", {}, False)],
    ids=["ring_wraparound", "gappy", "wide_13_blocks", "leftovers", "30011_cameras"])
def test_pcg_kernel_resident_and_streaming_forms_agree(dev, case, plan_kw, fits, kind):
    """K4 and both forms of K8 in the kernel's resident form (the band in
    shared memory, two exchanges an iteration) and its streaming form: the
    same iteration count, x to 1e-4 of max|x| after 5 fixed iterations (the
    tolerance held against the plain version) and to 1e-3 at convergence,
    each against the plain version, the same bits on a second run. Where the
    band does not fit the card at once, ``resident=True`` raises and the
    default takes the streaming form."""
    s, args, kw = _forms_operands(dev, case, kind, plan_kw)
    plan = s["plan"]
    form = {"fold": 0, "given": 1, "tridiag": 2}[kind]
    cams = pcg_band_mod.resident_cams(form, plan.band_offsets, plan.n_cameras, dev)
    assert (cams > 0) == fits
    if case == "leftover":
        assert cams == 8                       # 63 items: too wide for groups of 16 cameras
    pcg_band_mod.reset_form_launches()
    if not fits:
        with pytest.raises(ValueError, match="does not fit"):
            pcg_banded(*args, max_iters=5, tol=0.0, resident=True, **kw)
        x, k, ok = pcg_banded(*args, max_iters=5, tol=0.0, **kw)
        xs, ks, oks = pcg_banded(*args, max_iters=5, tol=0.0, resident=False, **kw)
        assert pcg_band_mod.form_launches == {"resident": 0, "streaming": 2}
        assert torch.equal(x, xs) and int(k) == int(ks) == 5
        return
    x5, k5, ok5 = pcg_banded(*args, max_iters=5, tol=0.0, resident=True, **kw)
    x5d, _, _ = pcg_banded(*args, max_iters=5, tol=0.0, **kw)        # the default is resident
    x5s, k5s, ok5s = pcg_banded(*args, max_iters=5, tol=0.0, resident=False, **kw)
    assert pcg_band_mod.form_launches == {"resident": 2, "streaming": 1}
    x5p, k5p, ok5p = pcg_banded_plain(*args, max_iters=5, tol=0.0, **kw)
    assert int(k5) == int(k5s) == int(k5p) == 5 and bool(ok5) and bool(ok5s) and bool(ok5p)
    assert torch.equal(x5, x5d)
    assert _rel_err(x5, x5s.double()) <= 1e-4 and _rel_err(x5, x5p.double()) <= 1e-4
    tol = torch.tensor(1e-5, device=dev)
    x, k, ok = pcg_banded(*args, max_iters=300, tol=tol, resident=True, **kw)
    xs, ks, oks = pcg_banded(*args, max_iters=300, tol=tol, resident=False, **kw)
    xp, kp, okp = pcg_banded_plain(*args, max_iters=300, tol=tol, **kw)
    slack = 2 if kind != "tridiag" else max(3, 0.2 * int(kp))
    assert bool(ok) and bool(oks) and bool(okp) and 0 < int(k) < 300
    assert abs(int(k) - int(ks)) <= slack and abs(int(k) - int(kp)) <= slack, (k, ks, kp)
    assert _rel_err(x, xs.double()) <= 1e-3 and _rel_err(x, xp.double()) <= 1e-3
    x2, k2, _ = pcg_banded(*args, max_iters=300, tol=tol, resident=True, **kw)
    assert torch.equal(x, x2) and int(k) == int(k2)
    # a warm start in both forms: no iteration, x0 comes back
    for resident in (True, False):
        x3, k3, ok3 = pcg_banded(*args, max_iters=300, tol=1e-3, x0=x, resident=resident, **kw)
        assert int(k3) == 0 and bool(ok3) and torch.equal(x3, x)
    # from a random start the forms still agree (x0 goes through the first matvec)
    x0 = torch.randn(s["b"].shape, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    xa, ka, _ = pcg_banded(*args, max_iters=5, tol=0.0, x0=x0, resident=True, **kw)
    xb, kb, _ = pcg_banded(*args, max_iters=5, tol=0.0, x0=x0, resident=False, **kw)
    xc, _, _ = pcg_banded_plain(*args, max_iters=5, tol=0.0, x0=x0, **kw)
    assert int(ka) == int(kb) == 5
    # S x0 of a random x0 cancels against b over many orders of magnitude, and
    # five f32 steps amplify the summation order: either form lands 0.9e-4 to
    # 1.2e-4 of max|x| from f64 on the leftover case, varying from run to run
    # (the system is assembled by plain scatter_add_, whose atomics round in
    # any order). A fault in how x0 is staged would move x by its own size:
    # each form is held to the plain version in f64 within 1e-3, the file's
    # tolerance at convergence, or ten times the plain f32 version's own error
    def dbl(v):
        if isinstance(v, tuple):
            return tuple(dbl(t) for t in v)
        return v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v

    xr, _, _ = pcg_banded_plain(*[dbl(v) for v in args], max_iters=5, tol=0.0, x0=x0.double(),
                                **{k: dbl(v) for k, v in kw.items()})
    held = max(1e-3, 10.0 * _rel_err(xc, xr))
    assert _rel_err(xa, xr) <= held and _rel_err(xb, xr) <= held, (
        _rel_err(xa, xr), _rel_err(xb, xr), held)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streaming"])
def test_pcg_kernel_forms_freeze_alike_on_breakdown(dev, resident):
    """A negated U makes S negative definite, a negated D⁻¹ the
    preconditioner: both forms stop not-ok after one counted iteration with x
    at x0, as the plain version does."""
    plan, blk, U_t, b, lam = _pcg_inputs(dev, "ring")
    x0 = torch.randn(b.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    x, k, ok = pcg_banded(blk, None, None, b, plan, max_iters=50, tol=1e-4, x0=x0, U_t=-U_t,
                          lam=lam, diag_floor=FLOOR, diag_ceil=CEIL, resident=resident)
    assert not bool(ok) and int(k) == 1 and torch.equal(x, x0)
    s = _given_inputs(dev, "ring")
    P, Q, D = s["pcr"]
    x, k, ok = pcg_banded(s["blk"], s["Ul"], None, s["b"], s["plan"], max_iters=50, tol=1e-4,
                          x0=x0, tridiag=(P, Q, -D), resident=resident)
    assert not bool(ok) and int(k) == 1 and torch.equal(x, x0)


def test_pcg_kernel_breakdown_freezes_the_iterate(dev):
    plan, blk, U_t, b, lam = _pcg_inputs(dev, "ring")
    x0 = torch.randn(b.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    (x, k, ok), (xp, kp, okp) = _pcg_both(plan, blk, -U_t, b, lam, max_iters=50, tol=1e-4, x0=x0)
    assert not bool(ok) and not bool(okp) and int(k) == int(kp) == 1
    assert torch.equal(x, x0) and torch.equal(xp, x0)


def test_sparse_wrappers_refuse_what_the_kernels_do_not_take(dev):
    B, plan = _band_system(dev, "gappy", slots=True)
    pd = pairs_mod.precompute_pair_data(B, plan)
    lam = torch.tensor(1e-2, device=dev)
    blk = pairs_mod._compact_blocks(B, lam, plan, pd, FLOOR, CEIL)
    b = B.gc.contiguous()
    before = dict(_lib.launches)
    with pytest.raises(TypeError):          # f64 on the card: no quiet plain version
        fused_pair_blocks(pd.packed.double(), plan.pair_seg, lam.double(), plan.k_pad,
                          plan.pair_sched, **BAND_KW)
    with pytest.raises(TypeError):
        fused_track_blocks(pd.trk_W.double(), pd.trk_V.double(), lam.double(), plan.track,
                           **BAND_KW)
    with pytest.raises(TypeError):
        slot_band_blocks([w.double() for w in pd.slot_W], [v.double() for v in pd.slot_V],
                         lam.double(), plan.slot, **BAND_KW)
    with pytest.raises(TypeError):
        pcg_banded(blk.double(), None, None, b.double(), plan, max_iters=5, tol=1e-4,
                   U_t=pd.U_t.double(), lam=lam.double())
    with pytest.raises(ValueError):         # the schedule left on the CPU
        fused_pair_blocks(pd.packed, plan.pair_seg, lam, plan.k_pad,
                          pair_schedule(plan.seg_start.cpu().numpy(), device="cpu"), **BAND_KW)
    with pytest.raises(ValueError):         # CSR starts in place of the schedule
        fused_pair_blocks(pd.packed, plan.pair_seg, lam, plan.k_pad, plan.seg_start, **BAND_KW)
    with pytest.raises(ValueError):         # no kernel plan at all
        fused_pair_blocks(pd.packed, plan.pair_seg, lam, plan.k_pad, None, **BAND_KW)
    with pytest.raises(ValueError):         # a schedule of another plan's segments
        fused_pair_blocks(pd.packed, plan.pair_seg, lam, plan.k_pad + 1, plan.pair_sched,
                          **BAND_KW)
    with pytest.raises(ValueError):         # a non-contiguous payload
        fused_track_blocks(pd.trk_W.permute(0, 2, 1).contiguous().permute(0, 2, 1), pd.trk_V,
                           lam, plan.track, **BAND_KW)
    with pytest.raises(ValueError):         # b as a transposed view
        pcg_banded(blk, None, None, b.T.contiguous().T, plan, max_iters=5, tol=1e-4,
                   U_t=pd.U_t, lam=lam)
    with pytest.raises(TypeError):          # λ as a host float
        pcg_banded(blk, None, None, b, plan, max_iters=5, tol=1e-4, U_t=pd.U_t, lam=1e-2)
    with pytest.raises(ValueError, match="block-Jacobi only"):   # fold-damp with tridiag
        pcg_banded(blk, None, None, b, plan, max_iters=5, tol=1e-4, U_t=pd.U_t, lam=lam,
                   tridiag=(blk, blk, blk))
    with pytest.raises(ValueError):         # Ul given with neither Minv nor tridiag
        pcg_banded(blk, B.U, None, b, plan, max_iters=5, tol=1e-4)
    with pytest.raises(TypeError):          # f64 factors
        pcg_banded(blk, B.U, None, b, plan, max_iters=5, tol=1e-4,
                   tridiag=tuple(t.double() for t in pcr_factor(B.U, B.U)))
    assert _lib.launches == before
    # f64 on the card through the tier: refused, not run in plain PyTorch
    p64, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev,
                                    dtype=torch.float64)
    with pytest.raises(TypeError):
        solve(p64, LMConfig(max_iters=2, linear_solver="schur_sparse_pallas"))


def test_sparse_solve_on_the_card_matches_the_plain_versions(dev):
    """The sparse tier in f32: kernels on the card against plain versions on
    the CPU from the same problem (λ₀ = 10, where the counts do not hinge on
    rounding), every kernel launched, no per-CG-iteration host read, and the
    same cost and CG counts on a second run."""
    cfg = LMConfig(max_iters=6, init_lambda=10.0, linear_solver="schur_sparse_pallas")
    p_cpu, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device="cpu")
    p_dev, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    _lib.reset_launches()
    pcg_mod.reset_host_reads()
    res = solve(p_dev, cfg)
    launched, reads = dict(_lib.launches), dict(pcg_mod.host_reads)
    ref = solve(p_cpu, cfg)
    assert _lib.launches == launched        # the CPU solve launched nothing
    for name in ("segsum", "linearize", "cost", "pairblocks", "trackband", "pcg_band"):
        assert launched[name] > 0, launched
    assert launched["pcg_band"] == 6 and reads == {"cg": 0, "lm": 6, "state": 0}
    assert int(res.iterations) == int(ref.iterations) == 6
    assert int(res.accepted) == int(ref.accepted)
    np.testing.assert_allclose(res.cost.item(), ref.cost.item(), rtol=5e-4)
    assert res.cost.item() < res.initial_cost.item()
    again = solve(p_dev, cfg)
    assert again.cost.item() == res.cost.item()
    assert torch.equal(again.cg_history, res.cg_history)
    plain = solve(p_dev, LMConfig(max_iters=6, init_lambda=10.0, linear_solver="schur_sparse"))
    np.testing.assert_allclose(plain.cost.item(), res.cost.item(), rtol=5e-4)


# ---- K8: the PCG kernel with Ul and the preconditioner given ----

def _given_inputs(dev, case, lam=1.0, **plan_kw):
    """The operands of the non-fold-damp forms, as solve_schur_sparse makes
    them: blk, Ul, the block-Jacobi M⁻¹, the PCR factors, b."""
    B, plan = _band_system(dev, case, **plan_kw)
    C = plan.n_cameras
    pd = pairs_mod.precompute_pair_data(B, plan)
    lam = torch.tensor(lam, device=dev)
    blk = pairs_mod._compact_blocks(B, lam, plan, pd, FLOOR, CEIL)
    Ul, Vl = damp_blocks(B, lam, FLOOR, CEIL)
    b = schur_rhs(B, inv3x3_rows(Vl)).contiguous()
    diag_S = Ul - blk[:, :C].reshape(9, 9, C).permute(2, 0, 1)
    Minv = inv_spd_small(diag_S)
    pcr = None
    if len(plan.band_offsets) > 1 and plan.band_offsets[1] == 1:
        pcr = pcr_factor(*tridiag_from_band(blk, diag_S, plan, 9))
    return dict(plan=plan, blk=blk, Ul=Ul, Minv=Minv, pcr=pcr, b=b, U_t=pd.U_t, lam=lam)


def _f64_args(s, tridiag):
    pcr = tuple(t.double() for t in s["pcr"]) if tridiag else None
    return (s["blk"].double(), s["Ul"].double(), s["Minv"].double(), s["b"].double(),
            s["plan"]), pcr


@pytest.mark.parametrize("case,plan_kw", [("ring", {}), ("gappy", dict(slots=True)),
                                          ("long", {}), ("leftover", {})],
                         ids=["ring_wraparound", "gappy", "more_groups_than_blocks",
                              "leftovers"])
def test_pcg_kernel_with_given_blocks_matches_fold_damp_and_plain(dev, case, plan_kw):
    """K8 with the block-Jacobi M⁻¹ given: the system K4 solves, so the same
    iteration count and x to 1e-5 (M⁻¹ comes from another elimination order);
    and the plain version on the same operands."""
    s = _given_inputs(dev, case, **plan_kw)
    plan, blk, b = s["plan"], s["blk"], s["b"]
    tol = torch.tensor(1e-5, device=dev)
    before = dict(_lib.launches)
    reads = pcg_mod.host_reads["cg"]
    x, k, ok = pcg_banded(blk, s["Ul"], s["Minv"], b, plan, max_iters=300, tol=tol)
    assert pcg_mod.host_reads["cg"] == reads
    assert _lib.launches["pcg_band_given"] == before["pcg_band_given"] + 1
    assert _lib.launches["pcg_band"] == before["pcg_band"]
    x4, k4, ok4 = pcg_banded(blk, None, None, b, plan, max_iters=300, tol=tol, U_t=s["U_t"],
                             lam=s["lam"], diag_floor=FLOOR, diag_ceil=CEIL)
    assert _lib.launches["pcg_band"] == before["pcg_band"] + 1
    xp, kp, okp = pcg_banded_plain(blk, s["Ul"], s["Minv"], b, plan, max_iters=300, tol=tol)
    assert bool(ok) and bool(ok4) and bool(okp) and 0 < int(k) < 300
    assert int(k) == int(k4) and abs(int(k) - int(kp)) <= 2
    assert _rel_err(x, x4.double()) <= 1e-5
    assert _rel_err(x, xp.double()) <= 1e-3
    x2, k2, _ = pcg_banded(blk, s["Ul"], s["Minv"], b, plan, max_iters=300, tol=tol)
    assert torch.equal(x, x2) and int(k) == int(k2)       # the same bits every run
    # a fixed number of iterations against the plain version in f64
    x5, k5, _ = pcg_banded(blk, s["Ul"], s["Minv"], b, plan, max_iters=5, tol=0.0)
    args64, _ = _f64_args(s, False)
    x5r, _, _ = pcg_banded_plain(*args64, max_iters=5, tol=0.0)
    assert int(k5) == 5 and _rel_err(x5, x5r) <= 1e-4


@pytest.mark.parametrize("case,plan_kw", [("ring", {}), ("line", {}), ("wide", dict(slots=True)),
                                          ("long", {}), ("leftover", {})],
                         ids=["ring_wraparound", "line", "wide_13_blocks",
                              "more_groups_than_blocks", "leftovers"])
def test_pcg_kernel_with_tridiag_preconditioner_matches_plain(dev, case, plan_kw):
    """K8 with the PCR-factored block-tridiagonal preconditioner against its
    plain version (``pcr_apply`` in the host loop): a fixed number of
    iterations against f64, then to convergence: iterations within
    max(3, 20%) of the plain run, the true residual in f64 within ten times
    the tolerance, the same bits on a second run."""
    s = _given_inputs(dev, case, **plan_kw)
    plan, blk, b, pcr = s["plan"], s["blk"], s["b"], s["pcr"]
    assert pcr is not None and pcr[0].shape[0] == int(np.ceil(np.log2(plan.n_cameras)))
    (blk64, Ul64, _, b64, _), pcr64 = _f64_args(s, True)
    kw = dict(tridiag=pcr)
    before = _lib.launches["pcg_band_given"]
    reads = pcg_mod.host_reads["cg"]
    x5, k5, ok5 = pcg_banded(blk, s["Ul"], None, b, plan, max_iters=5, tol=0.0, **kw)
    assert pcg_mod.host_reads["cg"] == reads and _lib.launches["pcg_band_given"] == before + 1
    x5p, k5p, ok5p = pcg_banded_plain(blk, s["Ul"], None, b, plan, max_iters=5, tol=0.0, **kw)
    x5r, _, _ = pcg_banded_plain(blk64, Ul64, None, b64, plan, max_iters=5, tol=0.0,
                                 tridiag=pcr64)
    assert int(k5) == int(k5p) == 5 and bool(ok5) and bool(ok5p)
    assert _rel_err(x5, x5r) <= max(1e-4, 10.0 * _rel_err(x5p, x5r))
    tol = 1e-5
    x, k, ok = pcg_banded(blk, s["Ul"], None, b, plan, max_iters=300, tol=tol, **kw)
    xp, kp, okp = pcg_banded_plain(blk, s["Ul"], None, b, plan, max_iters=300, tol=tol, **kw)
    k, kp = int(k), int(kp)
    assert bool(ok) and bool(okp) and k < 300 and abs(k - kp) <= max(3, 0.2 * kp), (k, kp)
    res = b64 - pairs_mod.make_banded_matvec(blk64, Ul64, plan, 9)(x.double())
    assert res.norm() <= 10 * tol * b64.norm()
    x2, k2, _ = pcg_banded(blk, s["Ul"], None, b, plan, max_iters=300, tol=tol, **kw)
    assert torch.equal(x, x2) and k == int(k2)
    # a warm start that already meets the tolerance takes no iteration
    x3, k3, ok3 = pcg_banded(blk, s["Ul"], None, b, plan, max_iters=300, tol=1e-3, x0=x, **kw)
    assert int(k3) == 0 and bool(ok3) and torch.equal(x3, x)


def test_pcg_kernel_freezes_on_an_indefinite_preconditioner(dev):
    """−D⁻¹ in the last PCR step makes M⁻¹ negative definite: r·z ≤ 0 at the
    first step, so ok is False, one iteration is counted and x stays at x0,
    in the kernel as in the plain version."""
    s = _given_inputs(dev, "ring")
    P, Q, D = s["pcr"]
    x0 = torch.randn(s["b"].shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    kw = dict(max_iters=50, tol=1e-4, x0=x0, tridiag=(P, Q, -D))
    x, k, ok = pcg_banded(s["blk"], s["Ul"], None, s["b"], s["plan"], **kw)
    xp, kp, okp = pcg_banded_plain(s["blk"], s["Ul"], None, s["b"], s["plan"], **kw)
    assert not bool(ok) and not bool(okp) and int(k) == int(kp) == 1
    assert torch.equal(x, x0) and torch.equal(xp, x0)


def test_leftover_segments_go_through_the_pcg_kernels(dev):
    """A capped band with off-band leftover segments: K4 and K8 apply them in
    their matvec (each camera walks its own lists), so the sparse solve on the
    card launches the kernel and gives the δ of the host loop over
    ``make_banded_matvec``; without the lists the wrapper raises."""
    B, plan = _band_system(dev, "leftover")
    assert plan.banded and len(plan.band_offsets) == 32 and plan.n_segments > plan.k_band
    n_left = plan.n_segments - plan.k_band
    assert plan.left.row_cj.shape == (n_left,) and plan.left.row_start[-1] == n_left
    lam = torch.tensor(1.0, device=dev)
    kw = dict(cg_max_iters=200, cg_tol=1e-6, diag_floor=FLOOR, diag_ceil=CEIL)
    for precond, counter in (("jacobi", "pcg_band"), ("tridiag", "pcg_band_given")):
        _lib.reset_launches()
        pcg_mod.reset_host_reads()
        dxc, dxp, n_cg, ok = pairs_mod.solve_schur_sparse(B, lam, plan, precond=precond, **kw)
        assert _lib.launches[counter] == 1 and pcg_mod.host_reads["cg"] == 0
        hc, hp, hn, hok = pairs_mod.solve_schur_sparse(B, lam, plan, precond=precond,
                                                       pcg_kernel=False, **kw)
        assert _lib.launches[counter] == 1 and pcg_mod.host_reads["cg"] > 0
        assert bool(ok) and bool(hok) and abs(int(n_cg) - hn) <= max(3, 0.2 * hn)
        assert _rel_err(dxc, hc.double()) <= 1e-3 and _rel_err(dxp, hp.double()) <= 1e-3
    # dropping the leftovers changes the answer: the lists are really applied
    bare = dataclasses.replace(plan, n_segments=plan.k_band, left=None)
    blk = pairs_mod._compact_blocks(B, lam, plan, pairs_mod.precompute_pair_data(B, plan),
                                    FLOOR, CEIL)
    pd = pairs_mod.precompute_pair_data(B, plan)
    pkw = dict(max_iters=200, tol=1e-6, U_t=pd.U_t, lam=lam, diag_floor=FLOOR, diag_ceil=CEIL)
    x_with, _, _ = pcg_banded(blk, None, None, B.gc.contiguous(), plan, **pkw)
    x_without, _, _ = pcg_banded(blk, None, None, B.gc.contiguous(), bare, **pkw)
    assert _rel_err(x_without, x_with.double()) > 1e-3
    with pytest.raises(ValueError, match="leftover"):
        pcg_banded(blk, None, None, B.gc.contiguous(), dataclasses.replace(plan, left=None),
                   **pkw)


def test_segsum_kernel_at_the_compact_matvec_shape(dev):
    """K1 as the non-banded matvec of venice-1778-community calls it: (9,
    665,600) segment values keyed by camera, 0 … C−1 over the real segments
    in runs of very uneven length and the trash camera C over the padding
    tail, into C + 1 sums."""
    C, k_pad, n_real = 1778, 665600, 664321
    rng = np.random.default_rng(3)
    pop = (1.0 + np.arange(C)) ** -0.9
    keys = np.concatenate([np.sort(rng.choice(C, n_real, p=pop / pop.sum())),
                           np.full(k_pad - n_real, C)])
    starts = torch.tensor(np.searchsorted(keys, np.arange(C + 2)).astype(np.int32), device=dev)
    keys_t = torch.tensor(keys, dtype=torch.int32, device=dev)
    vals = torch.tensor(rng.standard_normal((9, k_pad)), dtype=torch.float32, device=dev)
    out = sorted_segment_sum_t(vals, keys_t, C + 1, starts)
    ref = sorted_segment_sum_t_plain(vals.double(), keys_t, C + 1)
    assert out.shape == (9, C + 1) and _rel_err(out, ref) <= 1e-5
    assert torch.equal(out, sorted_segment_sum_t(vals, keys_t, C + 1, starts))


def test_tridiag_solve_on_the_card_matches_the_plain_versions(dev):
    """``precond="tridiag"`` through ``solve``: K8 launched once a retry, no
    per-CG-iteration host read, the CPU run's trajectory to f32 rounding, and
    the same cost and CG counts on a second run."""
    cfg = LMConfig(max_iters=6, init_lambda=10.0, linear_solver="schur_sparse_pallas",
                   precond="tridiag")
    p_cpu, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device="cpu")
    p_dev, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    _lib.reset_launches()
    pcg_mod.reset_host_reads()
    res = solve(p_dev, cfg)
    launched, reads = dict(_lib.launches), dict(pcg_mod.host_reads)
    ref = solve(p_cpu, cfg)
    assert _lib.launches == launched
    assert launched["pcg_band_given"] == 6 and launched["pcg_band"] == 0
    assert reads == {"cg": 0, "lm": 6, "state": 0}
    assert int(res.accepted) == int(ref.accepted)
    np.testing.assert_allclose(res.cost.item(), ref.cost.item(), rtol=5e-4)
    again = solve(p_dev, cfg)
    assert again.cost.item() == res.cost.item() and torch.equal(again.cg_history, res.cg_history)
    jac = solve(p_dev, LMConfig(max_iters=6, init_lambda=10.0,
                                linear_solver="schur_sparse_pallas"))
    assert int(res.cg_history.sum()) < int(jac.cg_history.sum())


def test_non_banded_heavy_and_dense_tiers_on_the_card(dev, tmp_path, monkeypatch):
    """The tiers without a PCG kernel, on the card: a community problem
    (non-banded plan: K7 and K1 launched, K4–K6 and K8 not), a plan with
    heavy points, the dense tiers; each against the same solve on the CPU."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(max_iters=4, init_lambda=10.0)
    p_dev, _ = make_bal_like_problem("trafalgar-257", covis="community", device=dev)
    p_cpu, _ = make_bal_like_problem("trafalgar-257", covis="community", device="cpu")
    _, plan = build_solver_plans(p_dev, LMConfig(linear_solver="schur_sparse_pallas"))
    assert not plan.banded and plan.ci_start is not None and plan.cj_start is not None
    _lib.reset_launches()
    res = solve(p_dev, LMConfig(linear_solver="schur_sparse_pallas", **cfg))
    launched = dict(_lib.launches)
    for name in ("segsum", "linearize", "cost", "pairblocks"):
        assert launched[name] > 0, launched
    for name in ("pcg_band", "pcg_band_given", "trackband", "slotband"):
        assert launched[name] == 0, launched
    ref = solve(p_cpu, LMConfig(linear_solver="schur_sparse_pallas", **cfg))
    np.testing.assert_allclose(res.cost.item(), ref.cost.item(), rtol=5e-4)
    s_dev, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    s_cpu, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device="cpu")
    for tier in ("schur_dense", "schur_dense_pallas", "dense"):
        a = solve(s_dev, LMConfig(linear_solver=tier, **cfg))
        b = solve(s_cpu, LMConfig(linear_solver=tier, **cfg))
        np.testing.assert_allclose(a.cost.item(), b.cost.item(), rtol=5e-4, err_msg=tier)
    # heavy points: every track of 4 is over max_degree=3, so S is applied matrix-free
    B, plan = _band_system(dev, "ring", max_degree=3, tracks=False, slots=False)
    assert plan.n_heavy_pts > 0
    lam = torch.tensor(1.0, device=dev)
    kw = dict(cg_max_iters=200, cg_tol=1e-6, diag_floor=FLOOR, diag_ceil=CEIL)
    dxc, _, _, ok = pairs_mod.solve_schur_sparse(B, lam, plan, **kw)
    Bc = type(B)(*[f.cpu() if isinstance(f, torch.Tensor) else f for f in B])
    plan_c = pairs_mod.build_pair_plan(Bc.cam_idx, Bc.pt_idx, int((Bc.W.abs().sum(0) > 0).sum()),
                                       plan.n_cameras, Bc.V.shape[1], symmetric=True,
                                       pad_multiple=16, max_degree=3, tracks=False, slots=False,
                                       device="cpu")
    rc, _, _, rok = pairs_mod.solve_schur_sparse(Bc, lam.cpu(), plan_c, **kw)
    assert bool(ok) and bool(rok) and _rel_err(dxc, rc.double().to(dev)) <= 1e-3


# ---- checkpoint and resume, BAL files, the autodiff oracle ----

def test_checkpoint_round_trip_of_card_tensors(dev, tmp_path):
    cams = torch.randn(7, 9, device=dev)
    pts = torch.randn(40, 3, device=dev, dtype=torch.float64)
    save_checkpoint(str(tmp_path), cameras=cams, points=pts, lam=1e-3, iteration=5,
                    cost=2.5, extra={"warm_dxc": torch.zeros_like(cams), "nu": np.asarray(4.0)})
    ck = load_checkpoint(str(tmp_path))
    assert ck["cameras"].dtype == np.float32 and ck["points"].dtype == np.float64
    assert torch.equal(torch.from_numpy(ck["cameras"]), cams.cpu())
    assert torch.equal(torch.from_numpy(ck["points"]), pts.cpu())
    assert ck["iteration"] == 5 and float(ck["extra_tensors"]["nu"]) == 4.0


def test_chunked_and_resumed_solves_on_the_card(dev, tmp_path, monkeypatch):
    """ladybug-49 through schur_sparse_pallas in f32 at the golden's CG
    settings: chunks of 4, and a run killed at 6 and resumed to 12, are the
    uninterrupted solve bit for bit, and launch its kernels."""
    monkeypatch.chdir(tmp_path)
    p, _ = make_bal_like_problem("ladybug-49", device=dev)
    cfg = dict(max_iters=12, cg_max_iters=100, cg_tol=1e-4, linear_solver="schur_sparse_pallas")
    full = solve(p, LMConfig(**cfg))
    _lib.reset_launches()
    pcg_mod.reset_host_reads()
    chunked = solve(p, LMConfig(checkpoint_every=4, checkpoint_path="ck", **cfg))
    n_chunks = -(-int(full.iterations) // 4)
    # a read and a dump a chunk, and a λ read at each chunk's start but the first
    assert pcg_mod.host_reads["state"] == 3 * n_chunks - 1
    for name in ("segsum", "linearize", "cost", "pcg_band", "pairblocks", "trackband"):
        assert _lib.launches[name] > 0, _lib.launches
    for f in ("cameras", "points", "cost", "lam", "nu", "warm_dxc", "gnorm0", "iterations",
              "accepted", "cost_history", "lam_history", "cg_history"):
        assert torch.equal(getattr(chunked, f), getattr(full, f)), f
    solve(p, LMConfig(**dict(cfg, max_iters=6), checkpoint_every=3, checkpoint_path="killed"))
    assert load_checkpoint("killed")["iteration"] == 6
    res = solve(p, LMConfig(**cfg), resume_from="killed")
    for f in ("cameras", "points", "cost", "lam", "nu"):
        assert torch.equal(getattr(res, f), getattr(full, f)), f
    for f in ("cost_history", "cg_history"):
        assert torch.equal(getattr(res, f)[6:], getattr(full, f)[6:]), f


@pytest.mark.parametrize("use_native", [True, False])
def test_load_bal_onto_the_card(dev, tmp_path, use_native):
    p, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    path = str(tmp_path / "p.txt")
    save_bal(path, p)
    q = load_bal(path, use_native=use_native, device=dev)
    for f in ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask"):
        assert getattr(q, f).device == getattr(p, f).device
        assert torch.equal(getattr(q, f), getattr(p, f)), f


def test_autodiff_blocks_on_the_card(dev):
    p, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev,
                                  dtype=torch.float64)
    args = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    for g, a in zip(jacobian_blocks_bal_autodiff(*args), jacobian_blocks_bal(*args)):
        assert g.device == a.device and g.shape == a.shape
        assert _rel_err(g, a) <= 1e-10


# ---- the pose graph and the SfM front end: plain PyTorch on the card against
# the same functions on the CPU, on the same inputs (f64 unless stated)


def _ring(n, seed=0, noise=0.03):
    """The posegraph command line's ring, its draws in one batch."""
    from tpu_ba_torch.geometry.se3 import se3_compose, se3_exp, se3_relative

    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    z = np.zeros(n)
    gt = torch.as_tensor(np.stack([z, ang, z, np.cos(ang), z, np.sin(ang)], axis=1))
    ei = np.r_[np.arange(1, n), 0].astype(np.int32)
    ej = np.r_[np.arange(0, n - 1), n - 1].astype(np.int32)
    meas = se3_compose(se3_exp(torch.as_tensor(noise * rng.standard_normal((n, 6)))),
                       se3_relative(gt[ei], gt[ej]))
    init = gt.numpy() + 0.1 * rng.standard_normal((n, 6))
    init[0] = gt[0].numpy()
    return init, ei, ej, meas.numpy()


def test_se3_and_pose_graph_on_the_card(dev):
    from tpu_ba_torch.geometry import se3
    from tpu_ba_torch.posegraph import solve_pose_graph

    rng = np.random.default_rng(3)
    g = torch.as_tensor(np.concatenate([rng.normal(0, 1.0, (64, 3)), rng.normal(0, 1, (64, 3))],
                                       axis=1))
    g[:4, 0:3] *= 1e-8                                  # the small-angle branches
    h = g.flip(0)
    for name, args in (("se3_exp", (g,)), ("se3_log", (g,)), ("se3_inverse", (g,)),
                       ("se3_compose", (g, h)), ("se3_relative", (g, h))):
        fn = getattr(se3, name)
        out = fn(*(a.to(dev) for a in args))
        assert _rel_err(out.cpu(), fn(*args)) <= 1e-12, name
    init, ei, ej, meas = _ring(60)
    ref_nodes, ref_cost, ref_it = solve_pose_graph(init, ei, ej, meas, device="cpu")
    nodes, cost, it = solve_pose_graph(init, ei, ej, meas)            # the card by default
    assert nodes.device == torch.ones(1, device=dev).device and it == ref_it
    assert (nodes.cpu() - ref_nodes).abs().max().item() <= 1e-9
    assert abs(cost.item() - ref_cost.item()) <= 1e-9 * ref_cost.item()
    again = solve_pose_graph(init, ei, ej, meas, device=dev)
    assert torch.equal(again[0], nodes) and torch.equal(again[1], cost)


@pytest.fixture
def sfm_frames():
    from tpu_ba_torch.io.sequences import render_blob_sequence

    frames, gt = render_blob_sequence(n_frames=5, n_points=120, seed=4, device="cpu")
    return frames, gt


def test_render_on_the_card(dev, sfm_frames):
    from tpu_ba_torch.io.sequences import render_blob_sequence

    frames, gt = render_blob_sequence(n_frames=5, n_points=120, seed=4, device=dev)
    # f32 exp, sin and cos differ by ulps between the card and the CPU: a
    # pixel moves by its gradient times the projected shift (2.8e-5 measured
    # between the reference and the port at this size)
    assert np.abs(frames - sfm_frames[0]).max() <= 1e-4
    assert np.array_equal(gt["poses"], sfm_frames[1]["poses"])


def test_harris_and_matching_on_the_card_keep_the_tie_order(dev, sfm_frames):
    """More slots than peaks: the −∞ slots come in index order on the card
    as on the CPU (a stable sort, not ``torch.topk``)."""
    from tpu_ba_torch.sfm.features import describe_patches, detect_harris, top_k_stable
    from tpu_ba_torch.sfm.matching import match_descriptors

    x = torch.tensor([1.0, -np.inf, 3.0, 3.0, -np.inf, 2.0, -np.inf] * 300)
    assert torch.equal(top_k_stable(x.to(dev), 600)[1].cpu(), top_k_stable(x, 600)[1])
    out = {}
    for d in (dev, torch.device("cpu")):
        feats = []
        for img in sfm_frames[0][:2]:
            im = torch.as_tensor(img, dtype=torch.float64, device=d)
            xy, sc = detect_harris(im, max_corners=1024)
            feats.append((xy, sc, describe_patches(im, xy)))
        (_, s1, d1), (_, s2, d2) = feats
        out[d.type] = feats, match_descriptors(d1, d2, s1, s2)
    (gpu, (gi, gv)), (cpu, (ci, cv)) = out[dev.type], out["cpu"]
    for (gxy, gsc, gd), (cxy, csc, cd) in zip(gpu, cpu):
        fin = torch.isfinite(csc)
        assert 0 < int(fin.sum()) < 1024
        assert torch.equal(torch.isfinite(gsc).cpu(), fin)
        assert _rel_err(gsc.cpu()[fin], csc[fin]) <= 1e-12
        assert (gxy.cpu() - cxy).abs().max().item() <= 1e-9
        assert (gd.cpu() - cd).abs().max().item() <= 1e-9
    assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu(), cv) and int(cv.sum()) > 20


def test_ransacs_on_the_card_given_the_same_index_sets(dev):
    from tpu_ba_torch.geometry.rotations import aa_to_matrix
    from tpu_ba_torch.sfm import pnp, twoview

    rng = np.random.default_rng(5)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)], -1)
    R = aa_to_matrix(torch.tensor([0.03, -0.05, 0.02], dtype=torch.float64)).numpy()
    t = np.array([0.6, 0.1, 0.05])
    x1 = X[:, 0:2] / X[:, 2:3]
    Xc = X @ R.T + t
    x2 = Xc[:, 0:2] / Xc[:, 2:3] + 1e-4 * rng.standard_normal((n, 2))
    x2[:15] += rng.normal(0, 0.05, (15, 2))
    valid = np.ones(n, bool)
    valid[-6:] = False
    cpu = torch.device("cpu")
    T = {d: (lambda a, d=d: torch.as_tensor(a, device=d)) for d in (dev, cpu)}
    # the sampler draws on the CPU, so a seed gives the same sets on any device
    idx8 = {d: twoview.sample_index_sets(torch.Generator().manual_seed(1), T[d](valid), 512, 8)
            for d in T}
    assert torch.equal(idx8[dev].cpu(), idx8[cpu])
    E = {d: twoview.essential_from_samples(idx8[d], T[d](x1), T[d](x2), T[d](valid),
                                           inlier_thresh=1e-6) for d in T}
    assert int(E[dev][2]) == int(E[cpu][2]) > 150
    assert torch.equal(E[dev][1].cpu(), E[cpu][1])
    s = torch.sign(torch.sum(E[dev][0].cpu() * E[cpu][0]))
    assert (s * E[dev][0].cpu() - E[cpu][0]).abs().max().item() <= 1e-9
    idx6 = twoview.sample_index_sets(torch.Generator().manual_seed(2), T[cpu](valid), 256, 6)
    P = {d: pnp.pnp_from_samples(idx6.to(d), T[d](Xc), T[d](x2), T[d](valid),
                                 inlier_thresh=1e-6) for d in T}
    assert int(P[dev][3]) == int(P[cpu][3]) > 150
    assert torch.equal(P[dev][2].cpu(), P[cpu][2])
    for a, b in zip(P[dev][:2], P[cpu][:2]):
        assert (a.cpu() - b).abs().max().item() <= 1e-9


def test_short_incremental_sfm_on_the_card(dev, sfm_frames):
    """5 frames on the card and on the CPU, f32 as the pipeline runs. The
    random draws are the CPU generator's on both. The decisions before the
    first BA are the same; after it the f32 solves differ in rounding (K1's
    sums on the card, the plain version's on the CPU); the card's run repeats
    bit for bit (``test_short_incremental_sfm_repeats_on_the_card``)."""
    from tpu_ba_torch.sfm.incremental import SfMConfig, run_incremental_sfm

    frames, gt = sfm_frames
    cfg = SfMConfig(max_corners=128, ransac_hypotheses=256, ba_iters=3, final_ba_iters=5)
    card = run_incremental_sfm(frames, gt["K"], cfg, device=dev)
    cpu = run_incremental_sfm(frames, gt["K"], cfg, device="cpu")
    for k in ("init_inliers", "init_points", "registered_frames"):
        assert card.report[k] == cpu.report[k], (k, card.report[k], cpu.report[k])
    assert card.report["registered_frames"] == 5
    for k in ("n_points", "n_obs"):
        assert abs(card.report[k] - cpu.report[k]) <= 0.02 * cpu.report[k], k
    assert abs(card.final_cost - cpu.final_cost) <= 1e-2 * cpu.final_cost
    assert np.sqrt(2 * card.final_cost / card.report["n_obs"]) < 2.0


def test_short_incremental_sfm_repeats_on_the_card(dev, sfm_frames):
    """The same 5 frames twice on the card: every windowed BA's sums are K1's,
    in a fixed order, so the two runs end with the same bits."""
    from tpu_ba_torch.sfm.incremental import SfMConfig, run_incremental_sfm

    frames, gt = sfm_frames
    cfg = SfMConfig(max_corners=128, ransac_hypotheses=256, ba_iters=3, final_ba_iters=5)
    a = run_incremental_sfm(frames, gt["K"], cfg, device=dev)
    b = run_incremental_sfm(frames, gt["K"], cfg, device=dev)
    assert a.report["registered_frames"] == b.report["registered_frames"] == 5
    for k in ("poses", "points", "track_point", "registered"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.final_cost == b.final_cost


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sorted_keys", [True, False])
def test_order_fixed_segment_sum_launches_k1(dev, dtype, sorted_keys):
    """``segment_sum_t`` on the card: K1 (f32 or f64) over starts built on the
    device, once a call, through a stable argsort where the keys are not
    sorted; against the plain version in f64 (f64: to 1e-12), and the same
    bits on a second call."""
    g = torch.Generator().manual_seed(3)
    O, N, D = 50_000, 3_000, 12
    keys = torch.randint(0, N, (O,), generator=g)
    if sorted_keys:
        keys = keys.sort().values
    vals = torch.randn((D, O), generator=g, dtype=torch.float64).to(dev, dtype)
    keys = keys.to(dev, torch.int32)
    before = _lib.launches["segsum"]
    out = segment_sum_t(vals, keys, N, sorted_keys=sorted_keys)
    assert _lib.launches["segsum"] == before + 1 and out.dtype == dtype
    ref = sorted_segment_sum_t_plain(vals.double(), keys, N)
    assert _rel_err(out, ref) <= (1e-12 if dtype == torch.float64 else 1e-5)
    assert torch.equal(out, segment_sum_t(vals, keys, N, sorted_keys=sorted_keys))


@pytest.mark.parametrize("tier,dtype", [
    ("schur_pcg", torch.float32), ("schur_pcg", torch.float64),
    ("schur_sparse", torch.float32), ("schur_sparse", torch.float64),
    ("schur_dense", torch.float32), ("dense", torch.float32), ("dense", torch.float64)])
def test_plain_tiers_repeat_on_the_card(dev, tier, dtype):
    """Each plain tier solved twice on the card ends with the same bits: no
    sum of a solve adds with atomics (K1 takes the segment sums, the dense
    tier writes H in passes of distinct cells)."""
    if tier.startswith(("dense", "schur_dense")):
        p, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, dtype=dtype, device=dev)
    else:
        p, _ = make_bal_like_problem("ladybug-49", dtype=dtype, device=dev)
    cfg = LMConfig(linear_solver=tier, max_iters=8, cg_max_iters=100, cg_tol=1e-4)
    _lib.reset_launches()
    a, b = solve(p, cfg), solve(p, cfg)
    assert _lib.launches["segsum"] > 0
    assert torch.equal(a.cameras, b.cameras) and torch.equal(a.points, b.points)
    assert torch.equal(a.cost, b.cost) and torch.equal(a.cg_history, b.cg_history)


def test_sharded_solve_on_the_card_matches_the_cpu(dev):
    """ladybug-49 in f32 through ``schur_sparse_pallas`` on two gloo ranks
    sharing the card, against the single-device solve on the card within the
    reference's f32 bounds for its sharded kernel route (cost rtol 1e-5,
    cameras rtol 1e-2 / atol 1e-3), and against the same two-rank solve on
    the CPU (the kernels' plain versions) within the card-against-CPU bound
    of ``test_solve_on_the_card_matches_the_plain_versions`` (5e-4: f32
    kernels and plain versions differ by ~3e-5 in the final cost). The ranks
    of each run agree bit for bit. λ₀ = 10: at 1e-4 the first systems are not
    positive definite in f32 and the trajectory hinges on rounding."""
    from tpu_ba_torch.sharding.launch import problem_arrays, run_ranks, solve_jobs

    p, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32, device="cpu")
    cfg = dict(linear_solver="schur_sparse_pallas", max_iters=8, cg_max_iters=100, cg_tol=1e-4,
               init_lambda=10.0)
    jobs = [dict(problem=problem_arrays(p), config=cfg)]
    card = run_ranks(2, solve_jobs, (jobs,), backend="gloo")
    cpu = run_ranks(2, solve_jobs, (jobs,), device="cpu", threads=1)
    for run in (card, cpu):
        a, b = run[0][0], run[1][0]
        for k in ("cameras", "points", "cost", "cg_history", "iterations"):
            assert np.array_equal(a[k], b[k]), k
    got, want = card[0][0], cpu[0][0]
    assert got["device"] == "cuda:0" and want["device"] == "cpu"
    for name in ("segsum", "linearize", "cost", "pairblocks", "trackband", "pcg_band"):
        assert got["launches"][name] > 0, name
    assert got["launches"]["slotband"] == 0
    single = solve(make_bal_like_problem("ladybug-49", dtype=torch.float32, device=dev)[0],
                   LMConfig(**cfg))
    np.testing.assert_allclose(float(got["cost"]), single.cost.item(), rtol=1e-5)
    np.testing.assert_allclose(got["cameras"], single.cameras.cpu().numpy(), rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(float(got["cost"]), float(want["cost"]), rtol=5e-4)
    assert int(got["iterations"]) == int(want["iterations"]) == int(single.iterations) == 8


def test_rank_linearize_zeroes_the_cameras_outside_its_shard(dev):
    """Each rank of a 2-rank split of ladybug-49 runs K2 over its shard with
    a schedule over every camera (``build_plans`` of the shard, as the
    sharded solve builds it): about half the cameras have no observation in
    a shard and come out exact zeros, so the all-reduce adds nothing of
    them; the two ranks' sums are the whole problem's K2 sums (f32, 1e-5)."""
    from tpu_ba_torch.sharding.distributed import Mesh, shard_problem

    p, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32, device=dev)
    C = p.n_cameras
    whole = build_plans(p.cam_idx, p.pt_idx, C, p.n_points)
    U_all, gc_all, _, _ = fused_linearize_assemble(
        p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask, whole.cam_start,
        sched=whole.lin_sched)
    U_sum, gc_sum = torch.zeros_like(U_all), torch.zeros_like(gc_all)
    for rank in (0, 1):
        sh = shard_problem(p, Mesh(None, rank, 2, dev, "gloo"))
        plans = build_plans(sh.cam_idx, sh.pt_idx, C, p.n_points)
        U, gc, _, _ = fused_linearize_assemble(
            sh.cameras, sh.points, sh.obs_2d, sh.cam_idx, sh.pt_idx, sh.mask, plans.cam_start,
            sched=plans.lin_sched)
        absent = plans.cam_start.diff() == 0
        assert 0.3 * C < int(absent.sum()) < 0.7 * C
        assert torch.all(U[absent] == 0) and torch.all(gc[absent] == 0)
        U_sum += U
        gc_sum += gc
    assert _rel_err(U_sum, U_all.double()) <= 1e-5
    assert _rel_err(gc_sum, gc_all.double()) <= 1e-5
