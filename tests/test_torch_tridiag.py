"""The PCR block-tridiagonal preconditioner of the port against the
reference: ``solver/tridiag.py`` function for function in f64 (rtol 1e-12),
the exact inverse against a dense solve (rtol 1e-8), and
``pcg_banded_plain`` in the two forms that take Ul from outside (M⁻¹ given,
``tridiag=`` given) against the reference's Pallas kernel
``tpu_ba.kernels.pcg_band.pcg_banded`` in interpret mode, in f32, on the
system the reference's own kernel test uses: ladybug-49's first
linearization at λ = 1e-3, where the tridiagonal part of S is positive
definite (iterations within max(3, 20%), x to 1e-3 of max|x|, both ok).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bandblocks import CEIL, FLOOR, ref_system, system_to_port
from test_torch_pairs_plan import index_maps, plan_to_port, ring_problem
from tpu_ba.io.bal import make_bal_like_problem as ref_bal_like
from tpu_ba.kernels.pcg_band import pcg_banded as ref_pcg_banded
from tpu_ba.solver import pairs as ref_pairs
from tpu_ba.solver import tridiag as ref_tridiag
from tpu_ba.solver.batched_linalg import inv_spd_small as ref_inv_spd_small
from tpu_ba.solver.normal import damp_blocks as ref_damp_blocks
from tpu_ba.solver.schur import inv3x3_rows as ref_inv3x3_rows
from tpu_ba.solver.schur import schur_rhs as ref_schur_rhs
from tpu_ba_torch.kernels.pcg_band import pcg_banded, pcg_banded_plain
from tpu_ba_torch.solver import pcg as pcg_mod
from tpu_ba_torch.solver import tridiag as port_tridiag

torch.set_num_threads(1)


def _random_spd_tridiag(C, dc, seed=0, damp=2.0):
    """(D, B_up, dense M) of a random SPD block-tridiagonal matrix."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((C, dc, dc)) * 0.3
    D = D @ D.transpose(0, 2, 1) + damp * np.eye(dc)
    B = rng.standard_normal((C, dc, dc)) * 0.25
    B[-1] = 0.0
    M = np.zeros((C * dc, C * dc))
    for c in range(C):
        M[c * dc:(c + 1) * dc, c * dc:(c + 1) * dc] = D[c]
        if c + 1 < C:
            M[c * dc:(c + 1) * dc, (c + 1) * dc:(c + 2) * dc] = B[c]
            M[(c + 1) * dc:(c + 2) * dc, c * dc:(c + 1) * dc] = B[c].T
    ev_min = np.linalg.eigvalsh(M).min()
    if ev_min < 0.1:
        D = D + (0.1 - ev_min) * np.eye(dc)
        M = M + (0.1 - ev_min) * np.eye(C * dc)
    return D, B, M


@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 1723])
def test_n_pcr_levels_matches_reference(n):
    assert port_tridiag.n_pcr_levels(n) == ref_tridiag.n_pcr_levels(n)
    assert (1 << port_tridiag.n_pcr_levels(n)) >= n


@pytest.mark.parametrize("C,dc", [(5, 3), (16, 9), (23, 9), (64, 9)])
def test_pcr_factor_and_apply_match_reference_and_dense_solve(C, dc):
    D, B, M = _random_spd_tridiag(C, dc, seed=C)
    r = np.random.default_rng(1).standard_normal((C, dc))
    ref = ref_tridiag.pcr_factor(jnp.asarray(D), jnp.asarray(B))
    out = port_tridiag.pcr_factor(torch.tensor(D), torch.tensor(B))
    assert out[0].shape == (port_tridiag.n_pcr_levels(C), C, dc, dc)
    for a, b, name in zip(out, ref, "PQD"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14, err_msg=name)
    z = port_tridiag.pcr_apply(*out, torch.tensor(r)).numpy()
    np.testing.assert_allclose(z, np.asarray(ref_tridiag.pcr_apply(*ref, jnp.asarray(r))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(z, np.linalg.solve(M, r.reshape(-1)).reshape(C, dc), rtol=1e-8,
                               atol=1e-10)
    # the reference's factors, carried over as numpy, through the port's apply
    carried = port_tridiag.tridiag_from_numpy(*(np.asarray(a) for a in ref), device="cpu")
    np.testing.assert_allclose(port_tridiag.pcr_apply(*carried, torch.tensor(r)).numpy(), z,
                               rtol=1e-12, atol=1e-14)


def test_pcr_operator_is_symmetric():
    C, dc = 17, 9
    D, B, _ = _random_spd_tridiag(C, dc, seed=3)
    f = port_tridiag.pcr_factor(torch.tensor(D), torch.tensor(B))
    rng = np.random.default_rng(5)
    u, v = (torch.tensor(rng.standard_normal((C, dc))) for _ in range(2))
    np.testing.assert_allclose(float((port_tridiag.pcr_apply(*f, u) * v).sum()),
                               float((u * port_tridiag.pcr_apply(*f, v)).sum()), rtol=1e-9)


def test_shifts_and_a_single_camera():
    X = torch.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(port_tridiag._shift_dn(X, 1).numpy(),
                                  np.asarray(ref_tridiag._shift_dn(jnp.asarray(X.numpy()), 1)))
    np.testing.assert_array_equal(port_tridiag._shift_up(X, 2).numpy(),
                                  np.asarray(ref_tridiag._shift_up(jnp.asarray(X.numpy()), 2)))
    assert torch.all(port_tridiag._shift_dn(X, 9) == 0)     # a stride past the end: zeros
    # one camera: no level, the inverse of the one block
    D = torch.tensor(_random_spd_tridiag(1, 9)[0])
    P, Q, Dinv = port_tridiag.pcr_factor(D, torch.zeros_like(D))
    assert P.shape == (0, 1, 9, 9)
    torch.testing.assert_close(port_tridiag.pcr_apply(P, Q, Dinv, torch.ones(1, 9,
                               dtype=torch.float64)), torch.linalg.solve(D, torch.ones(
                                   1, 9, dtype=torch.float64)), rtol=1e-10, atol=1e-12)


def test_factor_t_matches_reference_layout():
    D, B, _ = _random_spd_tridiag(7, 9, seed=2)
    ref = ref_tridiag.pcr_factor(jnp.asarray(D), jnp.asarray(B))
    out = port_tridiag.factor_t(*port_tridiag.tridiag_from_numpy(*(np.asarray(a) for a in ref),
                                                               device="cpu"),
                                128)
    for a, b in zip(out, ref_tridiag.factor_t(*ref, 128)):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def ladybug49():
    """ladybug-49's first linearization in f32 at λ = 1e-3, by the reference:
    band blocks, Ul, M⁻¹, the PCR factors and b, and the same as tensors."""
    problem, _ = ref_bal_like("ladybug-49", dtype=np.float32)
    B = ref_system(problem, np.float32)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=True, banded=True)
    assert plan.banded and plan.band_offsets[1] == 1
    lam, C = 1e-3, plan.n_cameras
    blk = ref_pairs._compact_blocks(B, lam, plan, ref_pairs.precompute_pair_data(B, plan),
                                    FLOOR, CEIL)
    Ul, Vl = ref_damp_blocks(B, lam, FLOOR, CEIL)
    diag_S = Ul - blk[:, :C].reshape(9, 9, C).transpose(2, 0, 1)
    Minv = ref_inv_spd_small(diag_S)
    b = ref_schur_rhs(B, ref_inv3x3_rows(Vl))
    pcr = ref_tridiag.pcr_factor(*ref_tridiag.tridiag_from_band(blk, diag_S, plan, 9))
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)   # noqa: E731
    return dict(plan=plan, pp=plan_to_port(plan), blk=blk, Ul=Ul, Minv=Minv, b=b, pcr=pcr,
                diag_S=diag_S, blk_t=t(blk), Ul_t=t(Ul), Minv_t=t(Minv), b_t=t(b),
                pcr_t=port_tridiag.tridiag_from_numpy(*(np.asarray(a) for a in pcr),
                                                      dtype=torch.float32, device="cpu"))


def test_tridiag_from_band_and_factor_match_reference_on_a_real_band(ladybug49):
    s = ladybug49
    D, B_up = port_tridiag.tridiag_from_band(s["blk_t"].double(), torch.tensor(
        np.asarray(s["diag_S"], np.float64)), s["pp"], 9)
    D_r, B_r = ref_tridiag.tridiag_from_band(s["blk"], s["diag_S"], s["plan"], 9)
    np.testing.assert_allclose(B_up.numpy(), np.asarray(B_r, np.float64), rtol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_r, np.float64), rtol=1e-12)
    assert torch.all(B_up[-1] == 0)


@pytest.mark.parametrize("form", ["given", "tridiag"])
def test_plain_pcg_matches_reference_kernel(ladybug49, form):
    s = ladybug49
    tri = form == "tridiag"
    x_r, k_r, ok_r = ref_pcg_banded(s["blk"], s["Ul"], s["Minv"], s["b"], s["plan"],
                                    max_iters=300, tol=1e-5, interpret=True,
                                    tridiag=s["pcr"] if tri else None)
    reads = pcg_mod.host_reads["cg"]
    x, k, ok = pcg_banded_plain(s["blk_t"], s["Ul_t"], s["Minv_t"], s["b_t"], s["pp"],
                                max_iters=300, tol=1e-5, tridiag=s["pcr_t"] if tri else None)
    assert pcg_mod.host_reads["cg"] == reads + k + 1
    assert bool(ok) and bool(ok_r) and 0 < k < 300
    assert abs(k - int(k_r)) <= max(3, int(k_r) // 5), (k, int(k_r))
    x_r = np.asarray(x_r, np.float64)
    assert np.abs(x.double().numpy() - x_r).max() <= 1e-3 * np.abs(x_r).max()
    # the wrapper on CPU tensors is the plain version
    x_w, k_w, _ = pcg_banded(s["blk_t"], s["Ul_t"], s["Minv_t"], s["b_t"], s["pp"],
                             max_iters=300, tol=1e-5, tridiag=s["pcr_t"] if tri else None)
    assert k_w == k and torch.equal(x_w, x)


def test_tridiag_preconditioner_takes_fewer_iterations_than_block_jacobi(ladybug49):
    s = ladybug49
    counts = {}
    for form, tri in (("given", None), ("tridiag", s["pcr_t"])):
        counts[form] = pcg_banded_plain(s["blk_t"], s["Ul_t"], s["Minv_t"], s["b_t"], s["pp"],
                                        max_iters=300, tol=1e-5, tridiag=tri)[1]
    assert counts["tridiag"] < counts["given"], counts


def test_indefinite_preconditioner_freezes_both(ladybug49):
    """−D⁻¹ in the last PCR step: r·z ≤ 0 at the first step, so ok is False,
    one iteration is counted and x stays at x0, in the reference's kernel and
    in the plain version. (The ring's own tridiagonal part at weak damping is
    such a case on the solver's path; this one is indefinite by
    construction.)"""
    s = ladybug49
    x0 = np.random.default_rng(0).standard_normal(s["b_t"].shape).astype(np.float32)
    P, Q, Dinv = s["pcr"]
    x_r, k_r, ok_r = ref_pcg_banded(s["blk"], s["Ul"], s["Minv"], s["b"], s["plan"], max_iters=50,
                                    tol=1e-4, x0=jnp.asarray(x0), interpret=True,
                                    tridiag=(P, Q, -Dinv))
    Pt, Qt, Dt = s["pcr_t"]
    x, k, ok = pcg_banded_plain(s["blk_t"], s["Ul_t"], None, s["b_t"], s["pp"], max_iters=50,
                                tol=1e-4, x0=torch.tensor(x0), tridiag=(Pt, Qt, -Dt))
    assert not bool(ok) and not bool(ok_r) and k == int(k_r) == 1
    assert torch.equal(x, torch.tensor(x0))
    np.testing.assert_array_equal(np.asarray(x_r), x0)


def test_weakly_damped_ring_breaks_down_in_both_packages():
    """The synthetic ring at λ = 1e-3: the tridiagonal part of S is indefinite
    there, and both packages' sparse solves stop not-ok at the same
    iteration (f64)."""
    from tpu_ba_torch.solver import pairs as port_pairs

    problem = ring_problem()
    B = ref_system(problem)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=True, pad_multiple=16)
    kw = dict(cg_max_iters=200, cg_tol=1e-10, diag_floor=FLOOR, diag_ceil=CEIL,
              precond="tridiag")
    _, _, k_r, ok_r = ref_pairs.solve_schur_sparse(B, 1e-3, plan, **kw)
    _, _, k, ok = port_pairs.solve_schur_sparse(
        system_to_port(B, np.float64), torch.tensor(1e-3, dtype=torch.float64),
        plan_to_port(plan), **kw)
    assert not bool(ok) and not bool(ok_r) and int(k) == int(k_r) < 200
