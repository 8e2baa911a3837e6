"""The port's per-observation modules against their ``tpu_ba`` counterparts:
robust losses, rotations, the BAL camera, residuals and analytic Jacobians.

Inputs come from numpy seeds and go through both packages in float64. The
formulas are the same, evaluated in a different operation order, so values
agree to ~1e-15 relative; the stated tolerance is 1e-12, with an absolute
floor of 1e-12 times the array's largest entry for entries that cancel to
near zero. The Jacobians are also held against ``torch.func.jacfwd``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ba.geometry import cameras as ref_cameras
from tpu_ba.geometry import rotations as ref_rot
from tpu_ba.jacobians.analytic import jacobian_blocks_bal as ref_jacobians
from tpu_ba.residuals import robust as ref_robust
from tpu_ba.residuals.reprojection import residuals_bal as ref_residuals
from tpu_ba_torch.geometry import rotations
from tpu_ba_torch.geometry.cameras import project_bal
from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
from tpu_ba_torch.residuals import robust
from tpu_ba_torch.residuals.reprojection import residuals_bal

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of a thread per core oversubscribes the machine
torch.set_num_threads(1)

RTOL = 1e-12


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _angles(rng, n):
    """Angle-axis vectors: random, θ = 0, and θ² just under and just over
    the 1e-12 Taylor switch."""
    aa = rng.standard_normal((n, 3)) * 0.5
    unit = np.ones(3) / np.sqrt(3.0)
    aa[0] = 0.0
    aa[1] = unit * np.sqrt(0.99e-12)
    aa[2] = unit * np.sqrt(1.01e-12)
    aa[3] = unit * 1e-9
    return aa


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_robust_matches_reference(kind):
    rng = np.random.default_rng(kind)
    scale = 2.0
    s = np.concatenate([rng.exponential(8.0, 200), [0.0, 4.0, 4.0 - 1e-9, 4.0 + 1e-9, 1e4]])
    for pallas in (False, True):
        _close(robust.robust_rho(kind, _t(s), scale, pallas=pallas).numpy(),
               ref_robust.robust_rho(kind, jnp.asarray(s), scale, pallas=pallas))
    _close(robust.robust_weight(kind, _t(s), scale).numpy(),
           ref_robust.robust_weight(kind, jnp.asarray(s), scale))
    x = np.concatenate([rng.exponential(2.0, 100), [0.0, 0.4142135623730951, 1.0, 1e6]])
    _close(robust.atan_pos(_t(x)).numpy(), ref_robust.atan_pos(jnp.asarray(x)))
    with pytest.raises(ValueError):
        robust.robust_rho(7, _t(s), scale)


def test_rotations_match_reference():
    rng = np.random.default_rng(0)
    aa = _angles(rng, 64)
    x = rng.standard_normal((64, 3)) * 10.0
    _close(rotations.rotate_aa(_t(aa), _t(x)).numpy(), ref_rot.rotate_aa(jnp.asarray(aa), jnp.asarray(x)))
    R = rotations.aa_to_matrix(_t(aa)).numpy()
    _close(R, ref_rot.aa_to_matrix(jnp.asarray(aa)))
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)
    _close(rotations.skew(_t(x)).numpy(), ref_rot.skew(jnp.asarray(x)))
    small, theta = rotations._safe_theta(_t(np.sum(aa * aa, axis=1)))
    rs, rt = ref_rot._safe_theta(jnp.asarray(np.sum(aa * aa, axis=1)))
    np.testing.assert_array_equal(small.numpy(), np.asarray(rs))
    _close(theta.numpy(), rt)
    assert small.numpy()[:2].all() and not small.numpy()[2]


def _bal_inputs(seed=0, n=96):
    rng = np.random.default_rng(seed)
    cams = np.zeros((n, 9))
    cams[:, 0:3] = _angles(rng, n)
    cams[:, 3:6] = rng.standard_normal((n, 3)) + np.array([0.0, 0.0, -20.0])
    cams[:, 6] = 400.0 * (1.0 + 0.05 * rng.standard_normal(n))
    cams[:, 7] = -1e-3 * rng.random(n)
    cams[:, 8] = 1e-6 * rng.random(n)
    X = rng.standard_normal((n, 3)) * 3.0
    obs = rng.standard_normal((n, 2)) * 50.0
    return cams, X, obs


def test_projection_and_residuals_match_reference():
    cams, X, obs = _bal_inputs()
    _close(project_bal(_t(cams), _t(X)).numpy(),
           ref_cameras.project_bal(jnp.asarray(cams), jnp.asarray(X)))
    rng = np.random.default_rng(1)
    C, P, O = 7, 30, 96
    ci = np.sort(rng.integers(0, C, O)).astype(np.int32)
    pi = rng.integers(0, P, O).astype(np.int32)
    mask = np.arange(O) < 90
    args = (cams[:C], X[:P], obs, ci, pi, mask)
    out = residuals_bal(*[_t(a) for a in args]).numpy()
    _close(out, ref_residuals(*[jnp.asarray(a) for a in args]))
    assert np.all(out[~mask] == 0)


def test_jacobians_match_reference_and_jacfwd():
    cams, X, obs = _bal_inputs(seed=2)
    O = cams.shape[0]
    idx = np.arange(O, dtype=np.int32)
    mask = np.arange(O) < O - 6
    args = (cams, X, obs, idx, idx, mask)
    out = jacobian_blocks_bal(*[_t(a) for a in args])
    ref = ref_jacobians(*[jnp.asarray(a) for a in args])
    for o, r in zip(out, ref):
        assert np.isfinite(o.numpy()).all()
        _close(o.numpy(), r)
        assert np.all(o.numpy()[..., ~mask] == 0)

    # the autodiff oracle: jacfwd of the projection, per observation
    def proj(cam, x, uv):
        return project_bal(cam, x) - uv

    Jc_ad = torch.func.vmap(torch.func.jacfwd(proj, argnums=0))(_t(cams), _t(X), _t(obs))
    Jp_ad = torch.func.vmap(torch.func.jacfwd(proj, argnums=1))(_t(cams), _t(X), _t(obs))
    m = torch.as_tensor(mask)
    Jc_ad = (Jc_ad * m[:, None, None]).permute(1, 2, 0).numpy()
    Jp_ad = (Jp_ad * m[:, None, None]).permute(1, 2, 0).numpy()
    # closed form vs forward-mode chain rule: same derivative, different
    # algebra (Gallego–Yezzi vs differentiated Rodrigues), so 1e-9 — except
    # observation 1, whose θ ≈ 1e-6 sits just under the Taylor switch: there
    # the closed form takes dP/daa = −[X]×, exact only to O(θ) ≈ 1e-6
    rest = np.arange(O) != 1
    _close(out[1].numpy()[..., rest], Jc_ad[..., rest], rtol=1e-9)
    _close(out[2].numpy(), Jp_ad, rtol=1e-9)
    _close(out[1].numpy()[..., 1], Jc_ad[..., 1], rtol=1e-5)
