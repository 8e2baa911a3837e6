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
one. ``test_torch_kernels.py`` holds the plain versions against the
reference's Pallas kernels on the CPU.
"""

import numpy as np
import pytest
import torch

from tpu_ba_torch.core import LMConfig
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.kernels.linearize import (fused_cost, fused_cost_plain,
                                            fused_linearize_assemble,
                                            fused_linearize_assemble_plain)
from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t, sorted_segment_sum_t_plain
from tpu_ba_torch.solver.lm import solve
from tpu_ba_torch.solver.plans import build_plans

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
    out = fused_linearize_assemble(*args, plans.cam_start, freeze_cols=freeze, **kw)
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
    cost = fused_cost(*args, **kw)
    assert cost.shape == () and cost.dtype == torch.float32
    assert abs(cost.item() - fused_cost_plain(*args64, **kw).item()) <= \
        1e-5 * abs(fused_cost_plain(*args64, **kw).item())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    p, C = _problem(dev)
    plans = build_plans(p.cam_idx, p.pt_idx, C, p.n_points)
    args = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    before = dict(_lib.launches)
    with pytest.raises(TypeError):          # f64 on the card: no quiet plain version
        fused_cost(p.cameras.double(), *args[1:])
    with pytest.raises(ValueError):         # an index map left on the CPU
        fused_linearize_assemble(*args, plans.cam_start.cpu())
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
    p_cpu, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11)
    p_dev, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    _lib.reset_launches()
    res = solve(p_dev, cfg)
    launched = dict(_lib.launches)
    ref = solve(p_cpu, cfg)
    assert all(n > 0 for n in launched.values()), launched
    assert _lib.launches == launched        # the CPU solve launched nothing
    assert int(res.iterations) == int(ref.iterations) == 6
    assert int(res.accepted) == int(ref.accepted)
    np.testing.assert_allclose(res.cost.item(), ref.cost.item(), rtol=5e-4)
    assert res.cost.item() < res.initial_cost.item()
