"""The rest of the port's geometry and residual API, its SE(3) module and its
trajectory metrics against their ``tpu_ba`` counterparts.

Inputs come from numpy seeds and go through both packages in float64, to
1e-12 relative (with an absolute floor of 1e-12 times the array's largest
entry), the small-angle branches (θ² < 1e-12) and rotations near π included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ba.bench.ate as ref_ate
import tpu_ba.geometry as ref_geo
import tpu_ba.geometry.cameras as ref_cameras
import tpu_ba.geometry.rotations as ref_rot
import tpu_ba.geometry.se3 as ref_se3
import tpu_ba.residuals as ref_res
import tpu_ba_torch.bench.ate as ate
import tpu_ba_torch.geometry as geo
import tpu_ba_torch.geometry.cameras as cameras
import tpu_ba_torch.geometry.rotations as rot
import tpu_ba_torch.geometry.se3 as se3
import tpu_ba_torch.residuals as res

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of a thread per core oversubscribes the machine
torch.set_num_threads(1)

RTOL = 1e-12


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _aa(n, seed):
    """Angle-axis vectors: random, tiny (θ² < 1e-12), zero and near π."""
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0, 3.0, n - 6), [1e-7, 3e-8, 0.0, np.pi - 1e-3,
                                                       np.pi - 1e-6, np.pi]])
    return axis * ang[:, None]


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([_aa(n, seed), rng.standard_normal((n, 3))], axis=1)


def _both(name, *args):
    """(port, reference) of the rotation or camera function ``name`` on the
    same f64 inputs."""
    port, ref = (cameras, ref_cameras) if hasattr(cameras, name) else (rot, ref_rot)
    return (getattr(port, name)(*(torch.as_tensor(np.array(a)) for a in args)).numpy(),
            np.asarray(getattr(ref, name)(*(jnp.asarray(a) for a in args))))


@pytest.mark.parametrize("name", ["aa_to_matrix", "aa_to_quat", "rotate_aa_transpose"])
def test_rotation_functions_match_reference(name):
    aa = _aa(40, 0)
    X = np.random.default_rng(1).standard_normal((40, 3))
    args = (aa, X) if name == "rotate_aa_transpose" else (aa,)
    _close(*_both(name, *args))


def test_matrix_quat_round_trips_match_reference_near_pi():
    aa = _aa(40, 2)
    R = np.asarray(ref_geo.aa_to_matrix(jnp.asarray(aa)))
    _close(*_both("matrix_to_aa", R))
    _close(*_both("quat_to_aa", np.asarray(ref_geo.aa_to_quat(jnp.asarray(aa)))))
    q = _both("matrix_to_quat", R)
    _close(*q)
    _close(*_both("quat_to_matrix", q[1]))
    q2 = np.asarray(ref_geo.aa_to_quat(jnp.asarray(_aa(40, 3))))
    _close(*_both("quat_mul", q[1], q2))
    # the reference's own near-π criterion (tests/test_rotations.py)
    axis = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    for angle in (np.pi - 1e-3, np.pi - 1e-6):
        aa1 = torch.as_tensor(angle * axis)[None]
        np.testing.assert_allclose(geo.matrix_to_aa(geo.aa_to_matrix(aa1)).numpy(),
                                   aa1.numpy(), atol=1e-6)


def test_cameras_and_residuals_match_reference():
    rng = np.random.default_rng(4)
    C, P, O = 5, 30, 80
    cams6 = np.concatenate([_aa(C + 6, 5)[:C], rng.normal(0, 0.3, (C, 3))], axis=1)
    cams9 = np.concatenate([cams6, rng.uniform(400, 600, (C, 1)),
                            rng.normal(0, 1e-3, (C, 2))], axis=1)
    Kin = np.stack([rng.uniform(250, 300, C), rng.uniform(250, 300, C),
                    rng.uniform(150, 170, C), rng.uniform(110, 130, C)], axis=1)
    X = np.concatenate([rng.uniform(-2, 2, (P, 2)), rng.uniform(4, 8, (P, 1))], axis=1)
    ci, pi = rng.integers(0, C, O), rng.integers(0, P, O)
    obs = rng.uniform(0, 320, (O, 2))
    mask = rng.random(O) < 0.8
    assert geo.BAL_CAM_DIM == ref_geo.BAL_CAM_DIM == 9
    assert geo.PINHOLE_CAM_DIM == ref_geo.PINHOLE_CAM_DIM == 6
    _close(*_both("camera_center_bal", cams9))
    _close(*_both("project_pinhole", cams6[ci], Kin[ci], X[pi]))

    t, j = torch.as_tensor, jnp.asarray
    for m in (None, mask):
        r = res.residuals_pinhole(t(cams6), t(Kin), t(X), t(obs), t(ci), t(pi),
                                  None if m is None else t(m))
        rr = ref_res.residuals_pinhole(j(cams6), j(Kin), j(X), j(obs), j(ci), j(pi),
                                       None if m is None else j(m))
        _close(r.numpy(), rr)
        _close(res.cost_from_residuals(r, None if m is None else t(m)).item(),
               float(ref_res.cost_from_residuals(rr, None if m is None else j(m))))
        for kind in range(4):
            _close(res.robust_cost(kind, r, 2.0, None if m is None else t(m)).item(),
                   float(ref_res.robust_cost(kind, rr, 2.0, None if m is None else j(m))))


@pytest.mark.parametrize("name", ["se3_exp", "se3_log", "se3_inverse", "_V_matrix"])
def test_se3_unary_matches_reference(name):
    g = _poses(30, 6)
    arg = g[:, 0:3] if name == "_V_matrix" else g
    out = getattr(se3, name)(torch.as_tensor(arg)).numpy()
    _close(out, np.asarray(getattr(ref_se3, name)(jnp.asarray(arg))))
    if name in ("se3_exp", "se3_log"):
        # the twist layout [rho, aa]: exp and log invert each other
        inv = se3.se3_log if name == "se3_exp" else se3.se3_exp
        _close(inv(torch.as_tensor(out)).numpy(), arg)


@pytest.mark.parametrize("name", ["se3_compose", "se3_relative"])
def test_se3_binary_matches_reference(name):
    g1, g2 = _poses(30, 7), _poses(30, 8)
    _close(getattr(se3, name)(torch.as_tensor(g1), torch.as_tensor(g2)).numpy(),
           np.asarray(getattr(ref_se3, name)(jnp.asarray(g1), jnp.asarray(g2))))
    X = np.random.default_rng(9).standard_normal((30, 3))
    _close(se3.se3_apply(torch.as_tensor(g1), torch.as_tensor(X)).numpy(),
           np.asarray(ref_se3.se3_apply(jnp.asarray(g1), jnp.asarray(X))))


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.zeros((n, 6))
    poses[:, 0:3] = 0.3 * rng.standard_normal((n, 3))
    centers = np.cumsum(rng.normal(0, 0.5, (n, 3)), axis=0)
    R = np.asarray(ref_geo.aa_to_matrix(jnp.asarray(poses[:, 0:3])))
    poses[:, 3:6] = -np.einsum("fij,fj->fi", R, centers)
    return poses


def test_ate_functions_match_reference():
    gt = _trajectory(25, 10)
    est = gt + np.random.default_rng(11).normal(0, 0.05, gt.shape)
    mask = np.ones(25, bool)
    mask[[3, 17]] = False
    _close(ate.camera_centers(est), ref_ate.camera_centers(est))
    src, dst = ate.camera_centers(est), ate.camera_centers(gt)
    for with_scale in (True, False):
        for a, b in zip(ate.umeyama_alignment(src, dst, with_scale),
                        ref_ate.umeyama_alignment(src, dst, with_scale)):
            _close(a, b)
    for m in (None, mask):
        out, ref = ate.ate_rmse(est, gt, mask=m), ref_ate.ate_rmse(est, gt, mask=m)
        assert out.keys() == ref.keys() and out["frames"] == ref["frames"]
        for k in out:
            _close(out[k], ref[k])
        for delta in (1, 3):
            out, ref = ate.rpe_stats(est, gt, m, delta), ref_ate.rpe_stats(est, gt, m, delta)
            assert out.keys() == ref.keys()
            for k in out:
                _close(out[k], ref[k])


def test_subpackages_reexport_the_reference_names():
    import tpu_ba.io as ref_io
    import tpu_ba.posegraph as ref_pg
    import tpu_ba.sfm as ref_sfm
    import tpu_ba.solver as ref_solver
    import tpu_ba_torch.io as io
    import tpu_ba_torch.posegraph as pg
    import tpu_ba_torch.sfm as sfm

    for port, ref in ((geo, ref_geo), (res, ref_res), (io, ref_io), (pg, ref_pg),
                      (sfm, ref_sfm)):
        names = {n for n in vars(ref) if not n.startswith("_") and callable(getattr(ref, n))}
        assert names <= set(dir(port)), (port.__name__, sorted(names - set(dir(port))))
    assert hasattr(ref_solver, "solve")
    from tpu_ba_torch.solver import solve  # noqa: F401
