"""The port's Schur algebra against ``tpu_ba``: assembly, damping, the small
inverses, the matrix-free Schur operators and PCG, in float64 on a
synthetic problem made from a numpy seed.

Each comparison feeds both packages the same arrays. The operations are
the same sums in another order, so results agree to ~1e-14; the stated
tolerance is 1e-10, with an absolute floor of 1e-10 times the array's
largest entry for entries that cancel to near zero. PCG is compared at
λ = 1, where the reduced system is well conditioned and the iteration count
does not hinge on rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba.jacobians.analytic import jacobian_blocks_bal as ref_jacobians
from tpu_ba.solver import schur as ref_schur
from tpu_ba.solver.batched_linalg import inv_spd_small as ref_inv_spd_small
from tpu_ba.solver.normal import BlockSystem as RefBlockSystem
from tpu_ba.solver.normal import assemble as ref_assemble
from tpu_ba.solver.normal import damp_blocks as ref_damp_blocks
from tpu_ba.solver.pcg import pcg as ref_pcg
from tpu_ba_torch.core import problem_from_numpy
from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
from tpu_ba_torch.solver import schur
from tpu_ba_torch.solver.batched_linalg import inv_spd_small
from tpu_ba_torch.solver.normal import BlockSystem, assemble, damp_blocks
from tpu_ba_torch.solver.pcg import host_reads, pcg
from tpu_ba_torch.solver.plans import build_plans

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of a thread per core oversubscribes the machine
torch.set_num_threads(1)

RTOL = 1e-10
C, P = 10, 100
FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def problems():
    ref, _ = ref_synthetic(C, P, obs_per_point=4, seed=11, dtype=np.float64)
    port = problem_from_numpy({k: np.asarray(getattr(ref, k)) for k in FIELDS},
                              n_cameras=C, n_points=P, n_obs=ref.n_obs, dtype=torch.float64,
                              device="cpu")
    return ref, port


def _systems(problems, kind=0):
    ref, port = problems
    rargs = [getattr(ref, k) for k in FIELDS]
    r, Jc, Jp = ref_jacobians(*rargs)
    B_ref = ref_assemble(r, Jc, Jp, ref.cam_idx, ref.pt_idx, C, P, kind, 2.0, ref.mask)
    # the port's operators get the reference's system, converted, so each
    # function is compared on identical inputs
    B_port = BlockSystem(*[torch.as_tensor(np.asarray(v)) for v in B_ref])
    return B_ref, B_port


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("with_plans", [False, True])
def test_assemble_matches_reference(problems, kind, with_plans):
    ref, port = problems
    B_ref, _ = _systems(problems, kind)
    r, Jc, Jp = jacobian_blocks_bal(*[getattr(port, k) for k in FIELDS])
    plans = build_plans(port.cam_idx, port.pt_idx, C, P) if with_plans else None
    B = assemble(r, Jc, Jp, port.cam_idx, port.pt_idx, C, P, kind, 2.0, port.mask, plans)
    for name in ("U", "V", "W", "gc", "gp", "cost"):
        _close(getattr(B, name).numpy(), getattr(B_ref, name))


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_damping_and_small_inverses_match_reference(problems, lam):
    B_ref, B = _systems(problems)
    Ul_r, Vl_r = ref_damp_blocks(B_ref, lam, 1e-6, 1e32)
    Ul, Vl = damp_blocks(B, torch.tensor(lam, dtype=torch.float64), 1e-6, 1e32)
    _close(Ul.numpy(), Ul_r)
    _close(Vl.numpy(), Vl_r)
    Vinv_r = ref_schur.inv3x3_rows(Vl_r)
    Vinv = schur.inv3x3_rows(Vl)
    _close(Vinv.numpy(), Vinv_r)
    D_r = Ul_r - ref_schur.w_vinv_wt_diag(B_ref.W, Vinv_r, B_ref.cam_idx, B_ref.pt_idx, C)
    D = Ul - schur.w_vinv_wt_diag(B.W, Vinv, B.cam_idx, B.pt_idx, C)
    _close(D.numpy(), D_r)
    _close(inv_spd_small(D).numpy(), ref_inv_spd_small(D_r))
    # degenerate blocks: the floors of both inverses act alike
    zero = np.zeros((9, 4))
    _close(schur.inv3x3_rows(torch.as_tensor(zero)).numpy(), ref_schur.inv3x3_rows(jnp.asarray(zero)))
    Z = np.zeros((2, 9, 9))
    _close(inv_spd_small(torch.as_tensor(Z)).numpy(), ref_inv_spd_small(jnp.asarray(Z)))


@pytest.mark.parametrize("with_plans", [False, True])
def test_schur_operators_match_reference(problems, with_plans):
    B_ref, B = _systems(problems)
    plans = build_plans(B.cam_idx, B.pt_idx, C, P) if with_plans else None
    Ul_r, Vl_r = ref_damp_blocks(B_ref, 1e-3, 1e-6, 1e32)
    Vinv_r = ref_schur.inv3x3_rows(Vl_r)
    Ul, Vinv = torch.as_tensor(np.asarray(Ul_r)), torch.as_tensor(np.asarray(Vinv_r))
    _close(schur.schur_rhs(B, Vinv, plans).numpy(), ref_schur.schur_rhs(B_ref, Vinv_r))
    x = np.random.default_rng(5).standard_normal((C, 9))
    mv_r = ref_schur.make_schur_matvec(Ul_r, B_ref.W, Vinv_r, B_ref.cam_idx, B_ref.pt_idx, P)
    mv = schur.make_schur_matvec(Ul, B.W, Vinv, B.cam_idx, B.pt_idx, P, plans)
    _close(mv(torch.as_tensor(x)).numpy(), mv_r(jnp.asarray(x)))
    _close(schur.back_substitute(B, Vinv, torch.as_tensor(x), plans).numpy(),
           ref_schur.back_substitute(B_ref, Vinv_r, jnp.asarray(x)))
    _close(schur.w_vinv_wt_diag(B.W, Vinv, B.cam_idx, B.pt_idx, C, plans).numpy(),
           ref_schur.w_vinv_wt_diag(B_ref.W, Vinv_r, B_ref.cam_idx, B_ref.pt_idx, C))


def test_solve_schur_pcg_matches_reference(problems):
    B_ref, B = _systems(problems)
    plans = build_plans(B.cam_idx, B.pt_idx, C, P)
    kw = dict(cg_max_iters=100, cg_tol=1e-6, diag_floor=1e-6, diag_ceil=1e32)
    dxc_r, dxp_r, it_r, ok_r = ref_schur.solve_schur_pcg(B_ref, 1.0, **kw)
    before = host_reads["cg"]
    dxc, dxp, it, ok = schur.solve_schur_pcg(B, torch.tensor(1.0, dtype=torch.float64),
                                             plans=plans, **kw)
    assert it == int(it_r) and 0 < it < 100 and bool(ok) and bool(ok_r)
    assert host_reads["cg"] - before == it + 1     # one read per CG test
    _close(dxc.numpy(), dxc_r)
    _close(dxp.numpy(), dxp_r)


def test_pcg_breakdown_matches_reference():
    """An indefinite system: pᵀAp ≤ 0 freezes x and flags not-ok, after the
    same number of iterations in both packages."""
    d = np.array([4.0, 3.0, -2.0, 1.0, 5.0, 2.0])
    b = np.array([1.0, -2.0, 3.0, 0.5, 1.0, -1.0])
    x_r, k_r, ok_r = ref_pcg(lambda v: jnp.asarray(d) * v, jnp.asarray(b), lambda r: r,
                             max_iters=20, tol=1e-12)
    dt = torch.as_tensor(d)
    x, k, ok = pcg(lambda v: dt * v, torch.as_tensor(b), lambda r: r, max_iters=20, tol=1e-12)
    assert not bool(ok_r) and not bool(ok)
    assert k == int(k_r)
    _close(x.numpy(), x_r)
    # and a positive definite one converges with the same count
    d = np.abs(d) + np.arange(6)
    dt = torch.as_tensor(d)
    x_r, k_r, ok_r = ref_pcg(lambda v: jnp.asarray(d) * v, jnp.asarray(b), lambda r: r,
                             max_iters=20, tol=1e-8, x0=jnp.asarray(0.1 * b))
    x, k, ok = pcg(lambda v: dt * v, torch.as_tensor(b), lambda r: r, max_iters=20, tol=1e-8,
                   x0=torch.as_tensor(0.1 * b))
    assert bool(ok_r) and bool(ok) and k == int(k_r)
    _close(x.numpy(), x_r)


def test_block_system_layout_matches_reference():
    assert BlockSystem._fields == RefBlockSystem._fields
