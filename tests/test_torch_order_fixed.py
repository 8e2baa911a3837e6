"""The solver's sums in a fixed order, and the CPU baseline.

Where the solver has no plan (the plain tiers, the SfM's windowed BA) its
segment sums go through ``kernels/segsum.py:segment_sum_t``, which on the
card launches K1 over starts built on the device and so never adds with
atomics; on the CPU it is the plain version, as checked here. The dense
tier writes H in passes of distinct cells (``solver/dense.py``), which on the
CPU gives the accumulating scatter's bits. The plain versions of K5, K6 and
K7 stay the yardsticks the kernels are held against: the solver hands them
``segment_sum_t``, their default is the plain sum. The CPU baseline
(``bench/cpu_baseline.py``, numpy and scipy only) equals the reference's.
"""

import numpy as np
import pytest
import torch

from test_torch_pairs_plan import gappy_problem, index_maps, ring_problem
from tpu_ba.bench.cpu_baseline import solve_cpu_baseline as ref_cpu_baseline
from tpu_ba.io.bal import make_bal_like_problem as ref_bal_like
from tpu_ba_torch.bench.cpu_baseline import solve_cpu_baseline
from tpu_ba_torch.core import problem_from_numpy
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
from tpu_ba_torch.kernels.pairblocks import fused_pair_blocks_plain
from tpu_ba_torch.kernels.segsum import segment_sum_t, sorted_segment_sum_t_plain
from tpu_ba_torch.kernels.slotband import slot_band_blocks_plain
from tpu_ba_torch.kernels.trackband import fused_track_blocks_plain
from tpu_ba_torch.solver import pairs as port_pairs
from tpu_ba_torch.solver.dense import dense_hessian
from tpu_ba_torch.solver.normal import assemble, damp_blocks

torch.set_num_threads(1)

FLOOR, CEIL = 1e-6, 1e32


@pytest.mark.parametrize("sorted_keys", [True, False])
@pytest.mark.parametrize("with_perm", [False, True])
@pytest.mark.parametrize("D,O,N", [(3, 500, 40), (12, 64, 300), (81, 1000, 7)])
def test_segment_sum_t_is_the_plain_sum_on_the_cpu(sorted_keys, with_perm, D, O, N):
    """Sorted and unsorted keys, with and without a permutation, segments
    empty where no key falls (N = 300 > O = 64): the plain version's sums
    exactly, empty segments exactly 0."""
    rng = np.random.default_rng(D + O + N)
    keys = rng.integers(0, N, O)
    if sorted_keys:
        keys = np.sort(keys)
    vals = torch.as_tensor(rng.standard_normal((D, O)))
    keys_t = torch.as_tensor(keys, dtype=torch.int32)
    perm = torch.as_tensor(rng.permutation(O), dtype=torch.int32) if with_perm else None
    out = segment_sum_t(vals, keys_t, N, perm, sorted_keys=sorted_keys)
    assert torch.equal(out, sorted_segment_sum_t_plain(vals, keys_t, N, perm))
    empty = np.setdiff1d(np.arange(N), keys)
    assert empty.size == 0 or out[:, empty].abs().max().item() == 0.0
    src = vals if perm is None else vals[:, perm.long()]
    want = np.zeros((D, N))
    np.add.at(want.T, keys, src.numpy().T)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)


def _port_system(p):
    """The port's assembled f64 system of a problem (port or reference)."""
    p = problem_from_numpy({k: np.asarray(getattr(p, k)) for k in
                            ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")},
                           n_cameras=p.cameras.shape[0], n_points=p.points.shape[0],
                           n_obs=p.n_obs, dtype=torch.float64, device="cpu")
    r, Jc, Jp = jacobian_blocks_bal(p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    return assemble(r, Jc, Jp, p.cam_idx, p.pt_idx, p.n_cameras, p.n_points, mask=p.mask)


def test_dense_hessian_passes_equal_the_accumulating_scatter():
    """H written in passes of distinct cells equals, bit for bit on the CPU,
    H from one accumulating scatter in observation order, on a problem whose
    padding rows repeat the last (camera, point) cell."""
    B = _port_system(make_synthetic_problem(8, 60, obs_per_point=3, seed=2, dtype=torch.float64,
                                            pad_multiple=128, device="cpu")[0])
    ci, pi = B.cam_idx.numpy(), B.pt_idx.numpy()
    cells = ci.astype(np.int64) * B.V.shape[-1] + pi
    assert np.unique(cells).size < cells.size, "the problem must repeat a cell"
    lam = torch.tensor(1e-3, dtype=torch.float64)
    H, _ = dense_hessian(B, lam, FLOOR, CEIL)
    C, dc, _ = B.U.shape
    P, O = B.V.shape[-1], B.W.shape[-1]
    Ul, Vl_t = damp_blocks(B, lam, FLOOR, CEIL)
    want = torch.zeros_like(H)
    ar_dc, ar3 = torch.arange(dc), torch.arange(3)
    arC, arP = torch.arange(C), torch.arange(P)

    def add(rows, cols, vals):
        rows, cols = torch.broadcast_tensors(rows, cols)
        want.index_put_((rows, cols), vals, accumulate=True)

    add(arC[:, None, None] * dc + ar_dc[None, :, None],
        arC[:, None, None] * dc + ar_dc[None, None, :], Ul)
    add(C * dc + arP[:, None, None] * 3 + ar3[None, :, None],
        C * dc + arP[:, None, None] * 3 + ar3[None, None, :], Vl_t.T.reshape(P, 3, 3))
    W = B.W.T.reshape(O, dc, 3)
    oi = B.cam_idx.long()[:, None, None] * dc + ar_dc[None, :, None]
    oj = C * dc + B.pt_idx.long()[:, None, None] * 3 + ar3[None, None, :]
    add(oi, oj, W)
    add(oj, oi, W)
    assert torch.equal(H, want)


@pytest.mark.parametrize("case", ["ring_tracks", "gappy_slots"])
def test_solver_blocks_hand_the_plain_versions_the_order_fixed_sum(case):
    """The solver's blocks without kernel plans (K7's plain products summed
    by ``segment_sum_t``, K5's and K6's plain versions handed it) equal the
    yardsticks on the CPU; the yardsticks keep the plain sum as default."""
    if case == "ring_tracks":
        problem, kw = ring_problem(), dict(symmetric=True)
    else:
        problem, kw = gappy_problem(), dict(symmetric=True, slots=True, tracks=False)
    B = _port_system(problem)
    plan = port_pairs.build_pair_plan(*index_maps(problem), pad_multiple=16, device="cpu", **kw)
    assert (plan.track if case == "ring_tracks" else plan.slot) is not None
    pd = port_pairs.precompute_pair_data(B, plan)
    lam = torch.tensor(1e-2, dtype=torch.float64)
    bkw = dict(dc=9, diag_floor=FLOOR, diag_ceil=CEIL)
    want = fused_pair_blocks_plain(pd.packed, plan.pair_seg, lam, plan.k_pad, **bkw)
    want[:, -1] = 0.0
    if plan.track is not None:
        tout = fused_track_blocks_plain(pd.trk_W, pd.trk_V, lam, plan.track, **bkw)
        assert torch.equal(tout, fused_track_blocks_plain(pd.trk_W, pd.trk_V, lam, plan.track,
                                                          segment_sum=segment_sum_t, **bkw))
        for g in range(plan.track.dmax):
            pos = plan.band_offsets.index(g) * plan.c_pad
            want[:, pos:pos + plan.c_pad] += tout[g * 81:(g + 1) * 81, :plan.c_pad]
    if plan.slot is not None:
        want[:, :plan.k_band] += slot_band_blocks_plain(pd.slot_W, pd.slot_V, lam, plan.slot,
                                                        **bkw)
    got = port_pairs._compact_blocks(B, lam, plan, pd, FLOOR, CEIL)
    assert torch.equal(got, want)


def test_cpu_baseline_matches_reference():
    """Two LM iterations of the MATLAB-class baseline on ladybug-49 from the
    same f64 arrays: the same cost trace to 1e-12."""
    ref, _ = ref_bal_like("ladybug-49", dtype=np.float64)
    port = problem_from_numpy(
        {k: np.asarray(getattr(ref, k)) for k in ("cameras", "points", "obs_2d", "cam_idx",
                                                  "pt_idx", "mask")},
        n_cameras=ref.cameras.shape[0], n_points=ref.points.shape[0], n_obs=ref.n_obs,
        dtype=torch.float64, device="cpu")
    want = ref_cpu_baseline(ref, max_iters=2)
    got = solve_cpu_baseline(port, max_iters=2)
    assert got["iters"] == want["iters"] == 2
    np.testing.assert_allclose(got["cost_trace"], want["cost_trace"], rtol=1e-12)
    assert got["cost_trace"][-1] < 1e-3 * got["cost_trace"][0]
