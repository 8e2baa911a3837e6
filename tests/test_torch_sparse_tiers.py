"""The solver tiers beside the banded block-Jacobi path, against ``tpu_ba``
on the same ``BlockSystem`` carried across as numpy (f64, CPU):

  * ``solve_schur_sparse`` with ``precond="tridiag"``, on non-banded plans
    (symmetric and full), with heavy points (banded, with tracks, non-banded)
    and on a capped band with off-band leftovers: δ to 1e-9 and equal CG
    counts at λ = 1, where the counts do not hinge on rounding (at λ = 1e-3
    the gauge leaves S near-singular and two f64 runs part by a few
    iterations of ~200; there δ is held to 1e-5);
  * ``_heavy_operator``: ``term(x)`` and ``diag_h`` to 1e-12;
  * the dense reduced system (``build_schur_t``, ``build_dense_schur``,
    ``solve_schur_dense``) and the full-H oracle (``dense_hessian``,
    ``solve_dense``) to 1e-10, and against each other;
  * ``make_bal_like_problem(..., covis="community")``: the reference's arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bandblocks import CEIL, FLOOR, ref_system, system_to_port
from test_torch_pairs_plan import (_with_incidence, community_problem, index_maps,
                                   leftover_problem, plan_to_port, ring_problem)
from tpu_ba.io.bal import make_bal_like_problem as ref_bal_like
from tpu_ba.solver import dense as ref_dense
from tpu_ba.solver import pairs as ref_pairs
from tpu_ba_torch.io.bal import make_bal_like_problem
from tpu_ba_torch.solver import dense as port_dense
from tpu_ba_torch.solver import pairs as port_pairs
from tpu_ba_torch.solver.schur import solve_schur_pcg

torch.set_num_threads(1)

KW = dict(cg_max_iters=500, cg_tol=1e-10, diag_floor=FLOOR, diag_ceil=CEIL)
F64 = torch.float64


def mixed_degree_problem(n_cams=24, seed=5):
    """Tracks of 2, 3, 3 and 5 consecutive cameras from every camera of a
    ring: with ``max_degree=4`` the 5-tracks are heavy and the rest are
    enumerated, so the plan stays banded."""
    rows = [(c + np.arange(d)) % n_cams for c in range(n_cams) for d in (2, 3, 3, 5)]
    return _with_incidence(n_cams, len(rows), np.concatenate(rows),
                           np.repeat(np.arange(len(rows)), [len(r) for r in rows]), seed)


SPARSE_CASES = {
    # name: (problem, build_pair_plan keywords, solve keywords, what the plan must be)
    "tridiag_ring": (ring_problem, {}, dict(precond="tridiag"),
                     lambda p: p.banded and p.band_offsets[1] == 1 and p.n_heavy_pts == 0),
    "community": (community_problem, {}, {}, lambda p: not p.banded and p.symmetric),
    "community_tridiag_is_jacobi": (community_problem, {}, dict(precond="tridiag"),
                                    lambda p: not p.banded),
    "heavy_banded": (mixed_degree_problem, dict(max_degree=4, tracks=False, slots=False), {},
                     lambda p: p.banded and p.n_heavy_pts == 24),
    "heavy_with_tracks": (mixed_degree_problem, dict(max_degree=4), {},
                          lambda p: p.banded and p.track is not None and p.n_heavy_pts > 0),
    "heavy_tridiag_is_jacobi": (mixed_degree_problem, dict(max_degree=4), dict(precond="tridiag"),
                                lambda p: p.banded and p.n_heavy_pts > 0),
    "heavy_non_banded": (ring_problem, dict(max_degree=3, tracks=False, slots=False), {},
                         lambda p: not p.banded and p.n_heavy_pts == 240),
    "leftovers": (leftover_problem, {}, {}, lambda p: p.banded and p.n_segments > p.k_band),
    "leftovers_tridiag": (leftover_problem, {}, dict(precond="tridiag"),
                          lambda p: p.n_segments > p.k_band and p.band_offsets[1] == 1),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_solve_schur_sparse_matches_reference(case):
    make, plan_kw, solve_kw, expect = SPARSE_CASES[case]
    problem = make()
    B = ref_system(problem)
    Bp = system_to_port(B, np.float64)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=True, pad_multiple=16,
                                     **plan_kw)
    assert expect(plan), case
    plans = {"carried": plan_to_port(plan),
             "own, with kernel plans": port_pairs.build_pair_plan(
                 *index_maps(problem), symmetric=True, pad_multiple=16, device="cpu",
                 with_kernel_plans=True, **plan_kw)}
    for lam, tol in ((1.0, 1e-9), (1e-3, 1e-5)):
        dxc_r, dxp_r, k_r, ok_r = ref_pairs.solve_schur_sparse(B, lam, plan, **KW, **solve_kw)
        ref_c, ref_p = np.asarray(dxc_r), np.asarray(dxp_r)
        for name, pp in plans.items():
            dxc, dxp, k, ok = port_pairs.solve_schur_sparse(Bp, torch.tensor(lam, dtype=F64), pp,
                                                            **KW, **solve_kw)
            assert bool(ok) == bool(ok_r), (name, lam)
            if lam == 1.0:
                assert bool(ok) and int(k) == int(k_r), (name, int(k), int(k_r))
            if not bool(ok):        # a frozen iterate: the same iteration, the same x
                assert int(k) == int(k_r), (name, lam)
            np.testing.assert_allclose(dxc.numpy(), ref_c, rtol=tol,
                                       atol=tol * np.abs(ref_c).max(), err_msg=f"{name} {lam}")
            np.testing.assert_allclose(dxp.numpy(), ref_p, rtol=tol,
                                       atol=tol * np.abs(ref_p).max(), err_msg=f"{name} {lam}")


def test_solve_schur_sparse_on_a_full_plan_matches_reference():
    """A non-symmetric (full) non-banded plan: the forward pass alone."""
    problem = community_problem()
    B = ref_system(problem)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=False, pad_multiple=16)
    assert not plan.symmetric and plan.seg_perm_cj is None
    r = ref_pairs.solve_schur_sparse(B, 1.0, plan, **KW)
    o = port_pairs.solve_schur_sparse(system_to_port(B, np.float64), torch.tensor(1.0, dtype=F64),
                                      plan_to_port(plan, with_kernel_plans=True), **KW)
    assert int(o[2]) == int(r[2]) and bool(o[3])
    np.testing.assert_allclose(o[0].numpy(), np.asarray(r[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(o[1].numpy(), np.asarray(r[1]), rtol=1e-9, atol=1e-12)


def test_tridiag_preconditioner_cuts_cg_iterations_and_keeps_the_solution():
    problem = ring_problem()
    Bp = system_to_port(ref_system(problem), np.float64)
    plan = port_pairs.build_pair_plan(*index_maps(problem), symmetric=True, pad_multiple=16,
                                      device="cpu")
    lam = torch.tensor(1.0, dtype=F64)
    jac = port_pairs.solve_schur_sparse(Bp, lam, plan, **KW)
    tri = port_pairs.solve_schur_sparse(Bp, lam, plan, precond="tridiag", **KW)
    assert bool(tri[3]) and tri[2] < jac[2]
    np.testing.assert_allclose(tri[0].numpy(), jac[0].numpy(), rtol=1e-7,
                               atol=1e-7 * jac[0].abs().max().item())
    with pytest.raises(ValueError, match="precond"):
        port_pairs.solve_schur_sparse(Bp, lam, plan, precond="ilu", **KW)


@pytest.mark.parametrize("plan_kw", [dict(max_degree=4, tracks=False, slots=False),
                                     dict(max_degree=4, symmetric=False),
                                     dict(max_degree=3, banded=False)],
                         ids=["banded", "full_plan", "non_banded"])
def test_heavy_operator_matches_reference(plan_kw):
    problem = mixed_degree_problem()
    B = ref_system(problem)
    Bp = system_to_port(B, np.float64)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), pad_multiple=16,
                                     **{"symmetric": True, **plan_kw})
    pp = plan_to_port(plan)
    assert plan.n_heavy_pts > 0 and plan.n_heavy_obs < plan.heavy_obs.shape[0]   # padded
    pd, pdp = ref_pairs.precompute_pair_data(B, plan), port_pairs.precompute_pair_data(Bp, pp)
    np.testing.assert_array_equal(pdp.heavy_W.numpy(), np.asarray(pd.heavy_W))
    np.testing.assert_array_equal(pdp.heavy_V.numpy(), np.asarray(pd.heavy_V))
    x = np.random.default_rng(0).standard_normal((plan.n_cameras, 9))
    for lam in (1e-3, 1.0):
        term_r, diag_r = ref_pairs._heavy_operator(pd, lam, plan, 9, FLOOR, CEIL)
        term, diag = port_pairs._heavy_operator(pdp, torch.tensor(lam, dtype=F64), pp, 9, FLOOR,
                                                CEIL)
        y_r = np.asarray(term_r(jnp.asarray(x)))
        np.testing.assert_allclose(term(torch.tensor(x)).numpy(), y_r, rtol=1e-12,
                                   atol=1e-12 * np.abs(y_r).max())
        np.testing.assert_allclose(diag.numpy(), np.asarray(diag_r), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(diag_r)).max())


@pytest.fixture(scope="module")
def tiny():
    """A 12-camera ring: reference system, full pair plan, the same carried over."""
    problem = ring_problem(n_cams=12, n_pts=60)
    B = ref_system(problem)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=False, pad_multiple=16)
    return dict(problem=problem, B=B, Bp=system_to_port(B, np.float64), plan=plan,
                pp=plan_to_port(plan), pd=ref_pairs.precompute_pair_data(B, plan))


@pytest.mark.parametrize("lam", [1e-3, 1.0])
def test_dense_reduced_system_matches_reference(tiny, lam):
    s = tiny
    lam_t = torch.tensor(lam, dtype=F64)
    pdp = port_pairs.precompute_pair_data(s["Bp"], s["pp"])
    ref_t = ref_pairs.build_schur_t(s["B"], lam, s["plan"], s["pd"], FLOOR, CEIL)
    out_t = port_pairs.build_schur_t(s["Bp"], lam_t, s["pp"], pdp, FLOOR, CEIL)
    for a, b, name in zip(out_t, ref_t, ("Ul", "T4", "diag_S")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)
    S_r, d_r = ref_pairs.build_dense_schur(s["B"], lam, s["plan"], s["pd"], FLOOR, CEIL)
    S, d = port_pairs.build_dense_schur(s["Bp"], lam_t, s["pp"], pdp, FLOOR, CEIL)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_r), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(S_r)).max())
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), rtol=1e-10)
    np.testing.assert_allclose(S.numpy(), S.numpy().T, rtol=0, atol=1e-9 * S.abs().max().item())
    # S is what the matrix-free matvec applies
    from tpu_ba_torch.solver.normal import damp_blocks
    from tpu_ba_torch.solver.schur import inv3x3_rows, make_schur_matvec
    Ul, Vl = damp_blocks(s["Bp"], lam_t, FLOOR, CEIL)
    mv = make_schur_matvec(Ul, s["Bp"].W, inv3x3_rows(Vl), s["Bp"].cam_idx, s["Bp"].pt_idx,
                           s["Bp"].V.shape[1])
    x = torch.tensor(np.random.default_rng(1).standard_normal((12, 9)))
    np.testing.assert_allclose((S @ x.reshape(-1)).reshape(12, 9).numpy(), mv(x).numpy(),
                               rtol=1e-9, atol=1e-9 * mv(x).abs().max().item())


def test_build_schur_t_refuses_a_symmetric_plan(tiny):
    s = tiny
    plan = port_pairs.build_pair_plan(*index_maps(s["problem"]), symmetric=True, pad_multiple=16,
                                      device="cpu")
    with pytest.raises(ValueError, match="non-symmetric"):
        port_pairs.build_schur_t(s["Bp"], torch.tensor(1.0, dtype=F64), plan,
                                 port_pairs.precompute_pair_data(s["Bp"], plan), FLOOR, CEIL)
    heavy = port_pairs.build_pair_plan(*index_maps(s["problem"]), symmetric=False, max_degree=3,
                                       pad_multiple=16, device="cpu")
    with pytest.raises(ValueError, match="heavy"):
        port_pairs.build_dense_schur(s["Bp"], torch.tensor(1.0, dtype=F64), heavy,
                                     port_pairs.precompute_pair_data(s["Bp"], heavy), FLOOR, CEIL)


@pytest.mark.parametrize("lam", [1e-3, 1.0])
def test_dense_solves_match_reference_and_each_other(tiny, lam):
    """solve_schur_dense and the full-H solve against their counterparts
    (1e-10), and every tier's δ on the same system against the direct solve
    (CG at 1e-12: 1e-7 at λ = 1e-3, where S is ill-conditioned)."""
    s = tiny
    lam_t = torch.tensor(lam, dtype=F64)
    kw = dict(KW, cg_tol=1e-12)
    r = ref_pairs.solve_schur_dense(s["B"], lam, s["plan"], **kw)
    o = port_pairs.solve_schur_dense(s["Bp"], lam_t, s["pp"], **kw)
    assert bool(o[3]) and abs(int(o[2]) - int(r[2])) <= (0 if lam == 1.0 else 3)
    tol = 1e-10 if lam == 1.0 else 1e-7
    np.testing.assert_allclose(o[0].numpy(), np.asarray(r[0]), rtol=tol,
                               atol=tol * np.abs(np.asarray(r[0])).max())
    H_r, g_r = ref_dense.dense_hessian(s["B"], lam, FLOOR, CEIL)
    H, g = port_dense.dense_hessian(s["Bp"], lam_t, FLOOR, CEIL)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_r), rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-10, atol=1e-300)
    dc_r, dp_r = ref_dense.solve_dense(s["B"], lam, FLOOR, CEIL)
    dxc, dxp = port_dense.solve_dense(s["Bp"], lam_t, FLOOR, CEIL)
    np.testing.assert_allclose(dxc.numpy(), np.asarray(dc_r), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(dc_r)).max())
    np.testing.assert_allclose(dxp.numpy(), np.asarray(dp_r), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(dp_r)).max())
    sym = port_pairs.build_pair_plan(*index_maps(s["problem"]), symmetric=True, pad_multiple=16,
                                     device="cpu")
    for name, (c, p, _, ok) in {
        "schur_dense": o,
        "schur_sparse": port_pairs.solve_schur_sparse(s["Bp"], lam_t, sym, **kw),
        "schur_sparse tridiag": port_pairs.solve_schur_sparse(s["Bp"], lam_t, sym,
                                                              precond="tridiag", **kw)
        if lam == 1.0 else o,
        "schur_pcg": solve_schur_pcg(s["Bp"], lam_t, **kw),
    }.items():
        assert bool(ok), name
        np.testing.assert_allclose(c.numpy(), dxc.numpy(), rtol=1e-7,
                                   atol=1e-7 * dxc.abs().max().item(), err_msg=name)
        np.testing.assert_allclose(p.numpy(), dxp.numpy(), rtol=1e-7,
                                   atol=1e-7 * dxp.abs().max().item(), err_msg=name)


def test_dense_solve_with_heavy_points_matches_reference():
    problem = mixed_degree_problem()
    B = ref_system(problem)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=False, max_degree=4,
                                     pad_multiple=16)
    assert plan.n_heavy_pts > 0
    r = ref_pairs.solve_schur_dense(B, 1.0, plan, **KW)
    o = port_pairs.solve_schur_dense(system_to_port(B, np.float64), torch.tensor(1.0, dtype=F64),
                                     plan_to_port(plan), **KW)
    assert int(o[2]) == int(r[2]) and bool(o[3])
    np.testing.assert_allclose(o[0].numpy(), np.asarray(r[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(o[1].numpy(), np.asarray(r[1]), rtol=1e-9, atol=1e-12)


def test_kernel_plans_of_the_new_branches():
    """What the kernels walk on the branches without a band: CSR starts of the
    compact matvec's two keyed sums, and the leftover lists of a capped band,
    which name every leftover segment once by row and once by column."""
    ci, pi, n_obs, C, P = index_maps(community_problem())
    plan = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, symmetric=True, pad_multiple=16,
                                      with_kernel_plans=True, device="cpu")
    assert not plan.banded and plan.left is None
    for keys, start in ((plan.seg_ci, plan.ci_start), (plan.cj_keys, plan.cj_start)):
        keys, start = keys.numpy(), start.numpy()
        assert start.shape == (C + 2,) and start[0] == 0 and start[-1] == plan.k_pad
        assert all(np.all(keys[start[c]:start[c + 1]] == c) for c in range(C + 1))
    assert start[C] == plan.n_segments                  # the padding tail is the trash camera's
    assert plan.ci_longest == np.diff(plan.ci_start.numpy()).max()
    assert plan.cj_longest == np.diff(plan.cj_start.numpy()).max()
    bare = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, symmetric=True, pad_multiple=16,
                                      device="cpu")
    assert bare.ci_start is None and bare.cj_start is None and bare.ci_longest is None

    ci, pi, n_obs, C, P = index_maps(leftover_problem())
    plan = port_pairs.build_pair_plan(ci, pi, n_obs, C, P, symmetric=True, pad_multiple=16,
                                      with_kernel_plans=True, device="cpu")
    L = plan.n_segments - plan.k_band
    lci = plan.seg_ci.numpy()[plan.k_band:plan.n_segments]
    lcj = plan.seg_cj.numpy()[plan.k_band:plan.n_segments]
    left = plan.left
    assert L > 0 and plan.ci_start is None
    rs, cs = left.row_start.numpy(), left.col_start.numpy()
    assert rs[-1] == cs[-1] == L and np.array_equal(left.row_cj.numpy(), lcj)
    assert all(np.all(lci[rs[c]:rs[c + 1]] == c) for c in range(C))
    seg = left.col_seg.numpy()
    assert sorted(seg.tolist()) == list(range(L))
    assert all(np.all(lcj[seg[cs[c]:cs[c + 1]]] == c) for c in range(C))
    assert np.array_equal(left.col_ci.numpy(), lci[seg])
    assert all(np.all(np.diff(seg[cs[c]:cs[c + 1]]) > 0) for c in range(C))   # stable order


def test_compact_matvec_applies_the_dense_schur_complement():
    """make_compact_matvec on a symmetric non-banded plan, with and without
    kernel plans, against S of the full plan's dense build."""
    problem = community_problem(n_cams=40, n_pts=120)
    Bp = system_to_port(ref_system(problem), np.float64)
    maps = index_maps(problem)
    lam = torch.tensor(1e-2, dtype=F64)
    full = port_pairs.build_pair_plan(*maps, symmetric=False, pad_multiple=16, device="cpu")
    S, _ = port_pairs.build_dense_schur(Bp, lam, full, port_pairs.precompute_pair_data(Bp, full),
                                        FLOOR, CEIL)
    x = torch.tensor(np.random.default_rng(4).standard_normal((40, 9)))
    want = (S @ x.reshape(-1)).reshape(40, 9)
    from tpu_ba_torch.solver.normal import damp_blocks
    Ul, _ = damp_blocks(Bp, lam, FLOOR, CEIL)
    for kernels in (False, True):
        plan = port_pairs.build_pair_plan(*maps, symmetric=True, banded=False, pad_multiple=16,
                                          with_kernel_plans=kernels, device="cpu")
        blk = port_pairs._compact_blocks(Bp, lam, plan, port_pairs.precompute_pair_data(Bp, plan),
                                         FLOOR, CEIL)
        y = port_pairs.make_compact_matvec(blk, Ul, plan, 9)(x)
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10 * want.abs().max().item())


def test_community_generator_matches_reference(tmp_path, monkeypatch):
    """Each package generates ladybug-49 with community covisibility from
    scratch in its own directory: index arrays exactly, parameters to 1e-12,
    the same cache file name."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    ref, ref_gt = ref_bal_like("ladybug-49", dtype=np.float64, covis="community")
    monkeypatch.chdir(tmp_path / "port")
    port, gt = make_bal_like_problem("ladybug-49", dtype=F64, covis="community", device="cpu")
    for k in ("cam_idx", "pt_idx", "mask"):
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(ref, k)), k)
    for k in ("cameras", "points", "obs_2d"):
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(gt["cameras"], ref_gt["cameras"], rtol=1e-12)
    assert gt["n_obs"] == ref_gt["n_obs"] == 31843
    import os
    names = os.listdir(tmp_path / "port" / "data" / "cache")
    assert names == os.listdir(tmp_path / "ref" / "data" / "cache") and "_community_" in names[0]
    # camera order carries no structure: far more distinct index offsets than a ring has
    ci, pi = port.cam_idx.numpy()[:port.n_obs], port.pt_idx.numpy()[:port.n_obs]
    order = np.argsort(pi, kind="stable")
    first = np.r_[True, np.diff(pi[order]) > 0]
    offsets = np.unique(np.abs(ci[order][~first] - ci[order][np.flatnonzero(~first) - 1]))
    assert offsets.size > 32
