"""The PyTorch port's kernel modules against the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels run only on the card, where chip_smoke.py compares them with these
plain versions) and the reference's Pallas kernels run in interpret mode.
Both see the same float64 inputs, made from numpy seeds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba.kernels.linearize import fused_cost as ref_fused_cost
from tpu_ba.kernels.linearize import fused_linearize_assemble as ref_linearize
from tpu_ba.kernels.segsum import build_segsum_plan
from tpu_ba.kernels.segsum import sorted_segment_sum_t as ref_segsum_t
from tpu_ba.solver.plans import build_plans as ref_build_plans
from tpu_ba_torch.core import problem_from_numpy
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.linearize import fused_cost, fused_linearize_assemble
from tpu_ba_torch.kernels.segsum import group_log2, sorted_segment_sum_t
from tpu_ba_torch.solver.plans import build_plans

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of a thread per core oversubscribes the machine
torch.set_num_threads(1)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(out, ref, rtol):
    """Elementwise rtol, with an absolute floor of rtol·max|ref|: entries
    that cancel to near zero carry the rounding of the largest terms."""
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _segsum_case(O, N, D, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        sizes = rng.integers(1, 10, N).astype(np.float64)
        sizes[: max(N // 50, 1)] *= 100
        keys = np.sort(rng.choice(N, O, p=sizes / sizes.sum())).astype(np.int32)
    else:
        keys = np.sort(rng.integers(0, N, O)).astype(np.int32)
    return rng.standard_normal((D, O)), keys


# the five shapes of tests/test_kernels.py; the same sums in another order,
# so f64 agrees to ~1e-15 relative — 1e-12 leaves room for the longest sums
@pytest.mark.parametrize("O,N,D,skew", [
    (4096, 37, 12, False),       # camera-like: few dense segments
    (4096, 1500, 12, False),     # point-like: many sparse segments
    (8192, 300, 90, False),      # wide D (packed U+g)
    (4096, 1000, 3, True),       # skewed sizes, tiny D
    (2048, 5, 9, False),         # tiny N
])
def test_segsum_plain_matches_pallas(O, N, D, skew):
    values, keys = _segsum_case(O, N, D, skew=skew)
    plan = build_segsum_plan(keys, N, tile=1024)
    ref = np.asarray(ref_segsum_t(jnp.asarray(values), jnp.asarray(keys), N, plan=plan,
                                  interpret=True))
    out = sorted_segment_sum_t(_t(values), _t(keys), N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_segsum_empty_segments_exactly_zero():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.choice([0, 3, 7, 19], 2048)).astype(np.int32)
    values = rng.standard_normal((8, 2048))
    plan = build_segsum_plan(keys, 20, tile=1024)
    ref = np.asarray(ref_segsum_t(jnp.asarray(values), jnp.asarray(keys), 20, plan=plan,
                                  interpret=True))
    out = sorted_segment_sum_t(_t(values), _t(keys), 20).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    empty = ~np.isin(np.arange(20), keys)
    assert np.all(out[:, empty] == 0)


def test_plans_csr_starts_describe_the_sorted_keys():
    """The kernels read segment k as [start[k], start[k+1]): the starts must
    reproduce the sorted keys exactly, empty segments included."""
    problem, _ = ref_synthetic(6, 40, obs_per_point=4, seed=12, dtype=np.float64,
                               pad_multiple=128)
    ci, pi = np.asarray(problem.cam_idx), np.asarray(problem.pt_idx)
    plans = build_plans(_t(ci), _t(pi), 8, 41)   # camera 7 and point 40 are empty
    ref = ref_build_plans(problem.cam_idx, problem.pt_idx, 8, 41, tile=128)
    np.testing.assert_array_equal(plans.perm_pt.numpy(), np.asarray(ref.perm_pt))
    np.testing.assert_array_equal(plans.pt_sorted_keys.numpy(), np.asarray(ref.pt_sorted_keys))
    for start, keys, n in [(plans.cam_start, ci, 8), (plans.pt_start, pi[np.asarray(ref.perm_pt)], 41)]:
        start = start.numpy()
        assert start[0] == 0 and start[-1] == len(keys)
        np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(start)), keys)
    with pytest.raises(ValueError, match="sorted"):
        build_plans(_t(ci[::-1].copy()), _t(pi), 8, 41)
    with pytest.raises(ValueError, match="pt_idx outside"):
        build_plans(_t(ci), _t(pi), 8, 39)
    with pytest.raises(ValueError, match="cam_idx outside"):
        build_plans(_t(ci), _t(pi), 5, 41)


def test_group_width_follows_mean_segment_length():
    assert group_log2(678912, 1723) == 5      # cameras: ~394 per segment, a full warp
    assert group_log2(678912, 156502) == 1    # points: ~4.3 per segment, 2 lanes
    assert group_log2(100, 100) == 0
    assert group_log2(0, 0) == 0


def _linearize_inputs(small_angle=None):
    """A padded synthetic problem (160 observations padded to 256) as
    float64 reference arrays; optionally with every camera at a given θ²."""
    problem, _ = ref_synthetic(6, 40, obs_per_point=4, pixel_noise=0.5, seed=12,
                               dtype=np.float64, pad_multiple=128)
    if small_angle is not None:
        cams = np.asarray(problem.cameras).copy()
        cams[:, 0:3] = np.sqrt(small_angle / 3.0)
        problem = dataclasses.replace(problem, cameras=jnp.asarray(cams))
    port = problem_from_numpy(
        {k: np.asarray(getattr(problem, k)) for k in
         ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")},
        n_cameras=6, n_points=40, n_obs=problem.n_obs, dtype=torch.float64)
    return problem, port


def _args(p):
    return (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)


@functools.lru_cache(maxsize=None)
def _ref_linearize_jit(robust, freeze):
    """The reference kernel in interpret mode, compiled once per static
    configuration and shared by the cases that differ only in their inputs."""
    return jax.jit(functools.partial(ref_linearize, robust_kind=robust, robust_scale=2.0,
                                     freeze_cols=freeze, interpret=True))


# same chain in the same order in f64; the camera sums differ in order only,
# so 1e-10 (of the array's largest entry, for the near-zero ones) is ample
@pytest.mark.parametrize("robust,case", [
    (0, "plain"), (1, "plain"), (2, "plain"), (3, "plain"),
    (1, "frozen"), (2, "theta0"), (3, "theta_under"), (0, "theta_over"),
])
def test_linearize_plain_matches_pallas(robust, case):
    small = {"theta0": 0.0, "theta_under": 0.99e-12, "theta_over": 1.01e-12}.get(case)
    freeze = (7, 8) if case == "frozen" else ()
    ref_p, p = _linearize_inputs(small)
    plan = ref_build_plans(ref_p.cam_idx, ref_p.pt_idx, 6, 40, tile=128)
    ref = _ref_linearize_jit(robust, freeze)(*_args(ref_p), plan.cam_plan)
    plans = build_plans(p.cam_idx, p.pt_idx, 6, 40)
    before = dict(_lib.launches)
    out = fused_linearize_assemble(*_args(p), plans.cam_start, robust_kind=robust,
                                   robust_scale=2.0, freeze_cols=freeze)
    assert _lib.launches == before          # CPU tensors take the plain version
    for o, r in zip(out, ref):
        assert np.isfinite(o.numpy()).all()
        _close(o.numpy(), r, 1e-10)
    pad = ~p.mask.numpy()
    assert pad.any() and np.all(out[2].numpy()[:, pad] == 0) and np.all(out[3].numpy()[:, pad] == 0)
    if freeze:
        U, gc = out[0].numpy(), out[1].numpy()
        assert np.all(U[:, 7:9, :] == 0) and np.all(U[:, :, 7:9] == 0) and np.all(gc[:, 7:9] == 0)


# a sum over 160 values in another order: 1e-12 relative
@pytest.mark.parametrize("robust", [0, 1, 2, 3])
def test_cost_plain_matches_pallas(robust):
    ref_p, p = _linearize_inputs()
    ref = float(ref_fused_cost(*_args(ref_p), robust_kind=robust, robust_scale=2.0,
                               interpret=True))
    out = fused_cost(*_args(p), robust_kind=robust, robust_scale=2.0)
    assert out.shape == ()
    np.testing.assert_allclose(out.item(), ref, rtol=1e-12)


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    dev = torch.device("cpu")
    x = torch.zeros((4, 9), dtype=torch.float32)
    _lib.check_tensor("x", x, torch.float32, (4, 9), dev)
    with pytest.raises(TypeError):
        _lib.check_tensor("x", x.double(), torch.float32, (4, 9), dev)
    with pytest.raises(ValueError):
        _lib.check_tensor("x", x, torch.float32, (9, 4), dev)
    with pytest.raises(ValueError):
        _lib.check_tensor("x", x.T, torch.float32, (9, 4), dev)
    with pytest.raises(RuntimeError):
        _lib.check_status("k", 1)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _lib.build_library()
    assert not list(tmp_path.iterdir())


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel path: here (meta tensors, no
    nvcc) that path raises, and nothing is counted as launched."""
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_nvcc", lambda: "false")
    meta = torch.device("meta")
    C, P, O = 3, 5, 8

    def z(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    args = (z((C, 9)), z((P, 3)), z((O, 2)), z((O,), torch.int32), z((O,), torch.int32),
            z((O,), torch.bool))
    before = dict(_lib.launches)
    with pytest.raises(ValueError, match="seg_start"):
        sorted_segment_sum_t(z((3, O)), z((O,), torch.int32), P)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sorted_segment_sum_t(z((3, O)), z((O,), torch.int32), P, z((P + 1,), torch.int32))
    with pytest.raises(TypeError):
        sorted_segment_sum_t(z((3, O), torch.float64), z((O,), torch.int32), P,
                             z((P + 1,), torch.int32))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_linearize_assemble(*args, z((C + 1,), torch.int32))
    with pytest.raises(ValueError, match="robust kind"):
        fused_linearize_assemble(*args, z((C + 1,), torch.int32), robust_kind=9)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_cost(*args)
    assert _lib.launches == before
