"""``pcg_banded_plain`` (the plain PyTorch version of K4) against the
reference: the Pallas kernel ``tpu_ba.kernels.pcg_band.pcg_banded`` in
interpret mode in f32 with the fold-damp prologue (x to 1e-4 of max|x|,
iterations within 1, ok equal), and ``tpu_ba.solver.pcg.pcg`` over
``make_banded_matvec`` in f64 with identical iteration counts.

The system is a 24-camera ring whose plan is fully banded with wrap-around
offsets (21, 22, 23) and ``c_pad`` 128, so padding cameras and the ring's
wrap are in every case. The damping is λ = 1: two solves that both meet a
relative residual of 1e-6 agree in x only as far as S is well conditioned
(at small λ they differ by ~tol/λ_min), so the solutions are compared where
CG is stable, as the reference's own kernel test does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bandblocks import CEIL, DT, FLOOR, ref_system
from test_torch_pairs_plan import index_maps, leftover_problem, plan_to_port, ring_problem
from tpu_ba.kernels.pcg_band import pcg_banded as ref_pcg_banded
from tpu_ba.solver import pairs as ref_pairs
from tpu_ba.solver.batched_linalg import inv_spd_small as ref_inv_spd_small
from tpu_ba.solver.normal import damp_blocks as ref_damp_blocks
from tpu_ba.solver.pcg import pcg as ref_pcg
from tpu_ba.solver.schur import inv3x3_rows as ref_inv3x3_rows
from tpu_ba.solver.schur import schur_rhs as ref_schur_rhs
from tpu_ba_torch.kernels import pcg_band as pcg_band_mod
from tpu_ba_torch.kernels.pcg_band import (fold_damp_prologue, gauss_jordan_inverse, pcg_banded,
                                           pcg_banded_plain)
from tpu_ba_torch.solver import pairs as port_pairs
from tpu_ba_torch.solver import pcg as pcg_mod

torch.set_num_threads(1)

LAM = 1.0


@pytest.fixture(scope="module", params=[np.float32, np.float64], ids=["f32", "f64"])
def banded(request):
    dtype = request.param
    problem = ring_problem()
    B = ref_system(problem, dtype)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=True, pad_multiple=16)
    assert plan.banded and plan.n_segments <= plan.k_band and plan.c_pad > plan.n_cameras
    assert max(plan.band_offsets) == plan.n_cameras - 1          # wrap-around offsets
    pd = ref_pairs.precompute_pair_data(B, plan)
    lam = jnp.asarray(LAM, dtype)
    blk = ref_pairs._compact_blocks(B, lam, plan, pd, FLOOR, CEIL)
    Ul, Vl = ref_damp_blocks(B, lam, FLOOR, CEIL)
    b = ref_schur_rhs(B, ref_inv3x3_rows(Vl))
    t = lambda a: torch.tensor(np.asarray(a), dtype=DT[dtype])   # noqa: E731
    return dict(dtype=dtype, plan=plan, pp=plan_to_port(plan), blk=blk, U_t=pd.U_t, Ul=Ul, b=b,
                lam=lam, blk_t=t(blk), U_t_t=t(pd.U_t), b_t=t(b), lam_t=t(lam))


def _reference(s, *, max_iters, tol, x0=None, U_t=None):
    """f32: the Pallas kernel, interpreted, fold-damp. f64: the jnp PCG over
    the banded matvec with the reference's block-Jacobi inverse."""
    plan, blk, b = s["plan"], s["blk"], s["b"]
    U_t = s["U_t"] if U_t is None else U_t
    if s["dtype"] == np.float32:
        x0 = jnp.zeros_like(b) if x0 is None else x0
        fn = jax.jit(lambda U_t, x0, tol: ref_pcg_banded(
            blk, None, None, b, plan, max_iters=max_iters, tol=tol, x0=x0, interpret=True,
            U_t=U_t, lam=s["lam"], diag_floor=FLOOR, diag_ceil=CEIL))
        key = ("fn", max_iters)
        fn = s.setdefault(key, fn)                 # one compilation per max_iters
        return fn(U_t, x0, jnp.float32(tol))
    C = plan.n_cameras
    diag_S = s["Ul"] - blk[:, :C].reshape(9, 9, C).transpose(2, 0, 1)
    Minv = ref_inv_spd_small(diag_S)
    matvec = ref_pairs.make_banded_matvec(blk, s["Ul"], plan, 9)
    return ref_pcg(matvec, b, lambda r: jnp.einsum("cij,cj->ci", Minv, r),
                   max_iters=max_iters, tol=tol, x0=x0)


def _port(s, *, max_iters, tol, x0=None, U_t=None):
    return pcg_banded_plain(s["blk_t"], None, None, s["b_t"], s["pp"], max_iters=max_iters,
                            tol=tol, x0=x0, U_t=s["U_t_t"] if U_t is None else U_t,
                            lam=s["lam_t"], diag_floor=FLOOR, diag_ceil=CEIL)


def _assert_same(s, out, ref):
    (x, k, ok), (x_r, k_r, ok_r) = out, ref
    assert bool(ok) == bool(ok_r)
    if s["dtype"] == np.float32:
        assert abs(int(k) - int(k_r)) <= 1
        tol = 1e-4
    else:
        assert int(k) == int(k_r)
        tol = 1e-9
    x_r = np.asarray(x_r, np.float64)
    assert np.abs(x.double().numpy() - x_r).max() <= tol * np.abs(x_r).max()


def test_cold_start(banded):
    out = _port(banded, max_iters=200, tol=1e-6)
    ref = _reference(banded, max_iters=200, tol=1e-6)
    assert 3 < int(out[1]) < 200 and bool(out[2])
    _assert_same(banded, out, ref)


def test_warm_start_that_meets_the_tolerance_takes_no_iteration(banded):
    x, k, _ = _port(banded, max_iters=200, tol=1e-6)
    assert int(k) > 0
    out = _port(banded, max_iters=200, tol=1e-4, x0=x)
    ref = _reference(banded, max_iters=200, tol=1e-4, x0=jnp.asarray(x.numpy()))
    assert int(out[1]) == 0 and int(ref[1]) == 0 and bool(out[2])
    assert torch.equal(out[0], x)
    _assert_same(banded, out, ref)


def test_max_iters_reached(banded):
    out = _port(banded, max_iters=3, tol=1e-12)
    ref = _reference(banded, max_iters=3, tol=1e-12)
    assert int(out[1]) == 3 and int(ref[1]) == 3
    _assert_same(banded, out, ref)


def test_breakdown_freezes_the_iterate(banded):
    """−U makes S = −U_λ' − T negative definite: pᵀSp ≤ 0 at the first step,
    so ok is False, one iteration is counted and x stays at x0."""
    s = banded
    x0 = torch.tensor(np.random.default_rng(0).standard_normal(s["b_t"].shape), dtype=s["b_t"].dtype)
    reads = pcg_mod.host_reads["cg"]
    x, k, ok = _port(s, max_iters=50, tol=1e-4, x0=x0, U_t=-s["U_t_t"])
    assert not bool(ok) and int(k) == 1 and torch.equal(x, x0)
    assert pcg_mod.host_reads["cg"] == reads + 2      # the host loop reads one flag a test
    if s["dtype"] == np.float32:                       # the kernel has the same contract
        x_r, k_r, ok_r = _reference(s, max_iters=200, tol=1e-4, x0=jnp.asarray(x0.numpy()),
                                    U_t=-s["U_t"])
        assert not bool(ok_r) and int(k_r) == 1
        np.testing.assert_allclose(np.asarray(x_r), x0.numpy(), rtol=0, atol=0)


def test_prologue_matches_reference_blocks(banded):
    """Ul and M⁻¹ of the fold-damp prologue against damp_blocks and the
    reference's block inverse; Gauss–Jordan against torch.linalg.inv."""
    s = banded
    C = s["plan"].n_cameras
    Ul, Minv = fold_damp_prologue(s["blk_t"], s["U_t_t"], s["lam_t"], C, 9, FLOOR, CEIL)
    tol = 1e-5 if s["dtype"] == np.float32 else 1e-12
    np.testing.assert_allclose(Ul.numpy(), np.asarray(s["Ul"]), rtol=tol)
    diag_S = s["Ul"] - s["blk"][:, :C].reshape(9, 9, C).transpose(2, 0, 1)
    Minv_r = np.asarray(ref_inv_spd_small(diag_S), np.float64)
    cond_tol = 2e-2 if s["dtype"] == np.float32 else 1e-8    # f32: cond(diag S) ~ 1e4
    assert np.abs(Minv.double().numpy() - Minv_r).max() <= cond_tol * np.abs(Minv_r).max()
    A = torch.tensor(np.random.default_rng(1).standard_normal((5, 9, 9)), dtype=torch.float64)
    A = A @ A.transpose(1, 2) + 9 * torch.eye(9, dtype=torch.float64)
    torch.testing.assert_close(gauss_jordan_inverse(A), torch.linalg.inv(A), rtol=1e-10,
                               atol=1e-12)


def test_wrapper_on_cpu_is_the_plain_version_and_refuses_other_variants(banded):
    s = banded
    kw = dict(max_iters=20, tol=1e-4, U_t=s["U_t_t"], lam=s["lam_t"], diag_floor=FLOOR,
              diag_ceil=CEIL)
    a = pcg_banded(s["blk_t"], None, None, s["b_t"], s["pp"], **kw)
    b = pcg_banded_plain(s["blk_t"], None, None, s["b_t"], s["pp"], **kw)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    with pytest.raises(ValueError, match="block-Jacobi only"):    # fold-damp with tridiag
        pcg_banded(s["blk_t"], None, None, s["b_t"], s["pp"], tridiag=(None, None, None), **kw)
    with pytest.raises(ValueError, match="Minv or tridiag"):      # Ul alone
        pcg_banded(s["blk_t"], s["U_t_t"], None, s["b_t"], s["pp"], max_iters=5, tol=1e-4)


@pytest.mark.parametrize("resident", [None, True, False])
def test_wrapper_on_cpu_ignores_the_kernel_form(banded, resident):
    """``resident`` picks between the CUDA kernel's two forms; a CPU tensor
    takes the plain version whatever it says, with the same result."""
    s = banded
    kw = dict(max_iters=20, tol=1e-4, U_t=s["U_t_t"], lam=s["lam_t"], diag_floor=FLOOR,
              diag_ceil=CEIL)
    before = dict(pcg_band_mod.form_launches)
    a = pcg_banded(s["blk_t"], None, None, s["b_t"], s["pp"], resident=resident, **kw)
    b = pcg_banded_plain(s["blk_t"], None, None, s["b_t"], s["pp"], **kw)
    assert torch.equal(a[0], b[0]) and a[1] == b[1] and bool(a[2]) == bool(b[2])
    assert pcg_band_mod.form_launches == before          # no kernel was launched


def test_resident_form_needs_a_band_that_starts_at_offset_zero():
    """The size rule's host part: offsets must be 0 followed by distinct
    positive ones (the resident form lays a transposed item beside every
    positive offset and orders the items by their camera shift);
    anything else is the streaming form's, decided without asking a card."""
    assert pcg_band_mod.resident_cams(0, (), 10, "cuda:0") == 0
    assert pcg_band_mod.resident_cams(0, (1, 2), 10, "cuda:0") == 0
    assert pcg_band_mod.resident_cams(1, (0, 0, 3), 10, "cuda:0") == 0
    assert pcg_band_mod.resident_cams(2, (0, 3, 3), 10, "cuda:0") == 0      # distinct shifts


def test_banded_matvec_with_offband_leftovers_matches_reference():
    """> 32 offsets: the band is capped and the leftover segments go through
    the gather branch of make_banded_matvec."""
    problem = leftover_problem()
    B = ref_system(problem)
    plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=True, pad_multiple=16)
    assert plan.n_segments > plan.k_band
    lam = 1e-3
    blk = ref_pairs._compact_blocks(B, lam, plan, ref_pairs.precompute_pair_data(B, plan),
                                    FLOOR, CEIL)
    Ul, _ = ref_damp_blocks(B, lam, FLOOR, CEIL)
    x = np.random.default_rng(2).standard_normal((plan.n_cameras, 9))
    y_ref = ref_pairs.make_banded_matvec(blk, Ul, plan, 9)(jnp.asarray(x))
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)   # noqa: E731
    y = port_pairs.make_banded_matvec(t(blk), t(Ul), plan_to_port(plan), 9)(t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(y_ref)).max())
