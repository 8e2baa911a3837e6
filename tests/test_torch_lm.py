"""The whole slice: ``tpu_ba_torch.solver.lm.solve`` against
``tpu_ba.solver.lm.solve`` in float64 on the CPU, for both tiers of the
matrix-free solver, and a trust-region state carried from one package to
the other.

The problem is the reference kernel test's synthetic ring (10 cameras, 100
points, 4 observations per point, seed 11). Its 7-DOF gauge leaves the
reduced camera system near-singular at small λ, where CG amplifies rounding
until the iteration counts fork: at λ₀ = 1e-4 even the reference's own two
tiers, which differ only in summation order, part ways by the second
linearization. The comparisons therefore start at λ₀ = 10, where CG counts
vary (1 to 35 here) but do not hinge on rounding; there the histories agree
to ~1e-12, and the stated tolerance is 1e-8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_ba.core import LMConfig as RefLMConfig
from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba.solver.lm import _solve_jit
from tpu_ba.solver.lm import solve as ref_solve
from tpu_ba.solver.plans import build_plans as ref_build_plans
from tpu_ba_torch.core import LMConfig, problem_from_numpy
from tpu_ba_torch.solver.lm import solve

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of a thread per core oversubscribes the machine
torch.set_num_threads(1)

FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")
CFG = dict(max_iters=8, init_lambda=10.0)


@pytest.fixture(scope="module")
def problems():
    ref, _ = ref_synthetic(10, 100, obs_per_point=4, seed=11, dtype=np.float64)
    port = problem_from_numpy({k: np.asarray(getattr(ref, k)) for k in FIELDS},
                              n_cameras=10, n_points=100, n_obs=ref.n_obs, dtype=torch.float64,
                              device="cpu")
    return ref, port


def _assert_same_run(res, ref, rtol=1e-8):
    assert int(res.iterations) == int(ref.iterations)
    assert int(res.accepted) == int(ref.accepted)
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_array_equal(res.cg_history.numpy(), np.asarray(ref.cg_history))
    np.testing.assert_allclose(res.cost_history.numpy(), np.asarray(ref.cost_history), rtol=rtol)
    np.testing.assert_allclose(res.lam_history.numpy(), np.asarray(ref.lam_history), rtol=rtol)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=rtol)
    np.testing.assert_allclose(float(res.initial_cost), float(ref.initial_cost), rtol=rtol)


@pytest.mark.parametrize("tier", ["schur_pcg", "schur_pcg_pallas"])
def test_slice_matches_reference(problems, tier):
    ref_p, p = problems
    ref = ref_solve(ref_p, RefLMConfig(linear_solver=tier, **CFG))
    res = solve(p, LMConfig(linear_solver=tier, **CFG))
    assert len(set(res.cg_history.tolist())) > 3      # early stops at varied counts
    _assert_same_run(res, ref)
    # f64 parameters after 8 LM steps: the same solution to 1e-8
    np.testing.assert_allclose(res.cameras.numpy(), np.asarray(ref.cameras), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(ref.points), rtol=1e-8, atol=1e-10)


def test_slice_with_frozen_columns_and_forcing_matches_reference(problems):
    ref_p, p = problems
    cfg = dict(CFG, freeze_camera_cols=(7, 8), cg_forcing=0.1, linear_solver="schur_pcg_pallas")
    ref = ref_solve(ref_p, RefLMConfig(**cfg))
    res = solve(p, LMConfig(**cfg))
    _assert_same_run(res, ref)
    np.testing.assert_array_equal(res.cameras.numpy()[:, 7:9], p.cameras.numpy()[:, 7:9])


def test_state_carried_from_reference_resumes_the_same_trajectory(problems):
    """tpu_ba runs 4 iterations; its parameters and trust-region state go to
    the port, which runs to 8: the result is tpu_ba's uninterrupted 8."""
    ref_p, p = problems
    cfg = RefLMConfig(linear_solver="schur_pcg_pallas", **CFG)
    plans = ref_build_plans(ref_p.cam_idx, ref_p.pt_idx, 10, 100)
    full = ref_solve(ref_p, cfg)      # the compiled solve of test_slice_matches_reference
    half = _solve_jit(ref_p, cfg, plans, None, None, 4)
    assert int(half.iterations) == 4
    state = tuple(np.asarray(v) for v in (half.lam, half.nu, half.iterations, half.warm_dxc,
                                          half.gnorm0))
    resumed = p.with_params(torch.tensor(np.asarray(half.cameras)),
                            torch.tensor(np.asarray(half.points)))
    res = solve(resumed, LMConfig(linear_solver="schur_pcg_pallas", **CFG), init_state=state)
    assert int(res.iterations) == int(full.iterations) == 8
    np.testing.assert_array_equal(res.cg_history.numpy()[4:], np.asarray(full.cg_history)[4:])
    np.testing.assert_allclose(res.cost_history.numpy()[4:], np.asarray(full.cost_history)[4:],
                               rtol=1e-8)
    np.testing.assert_allclose(float(res.cost), float(full.cost), rtol=1e-8)
    np.testing.assert_allclose(res.cameras.numpy(), np.asarray(full.cameras), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(res.nu), float(full.nu), rtol=1e-8)
    np.testing.assert_allclose(float(res.lam), float(full.lam), rtol=1e-8)


def test_port_resumes_itself(problems):
    _, p = problems
    cfg = LMConfig(linear_solver="schur_pcg_pallas", **CFG)
    full = solve(p, cfg)
    half = solve(p, LMConfig(linear_solver="schur_pcg_pallas", **dict(CFG, max_iters=3)))
    assert int(half.iterations) == 3
    res = solve(p.with_params(half.cameras, half.points), cfg,
                init_state=(half.lam, half.nu, half.iterations, half.warm_dxc, half.gnorm0))
    np.testing.assert_allclose(float(res.cost), float(full.cost), rtol=1e-12)
    np.testing.assert_array_equal(res.cg_history.numpy()[3:], full.cg_history.numpy()[3:])


def test_unknown_solver_and_model_raise(problems):
    _, p = problems
    with pytest.raises(ValueError):
        solve(p, LMConfig(linear_solver="cholmod"))
    with pytest.raises(ValueError):
        solve(p, LMConfig(linear_solver="schur_sparse", precond="ilu"))
    with pytest.raises(ValueError):
        solve(dataclasses.replace(p, model="fisheye"), LMConfig())
