"""K2's and K3's schedule (``tpu_ba_torch/kernels/linearize.py:
linearize_schedule``) on the CPU: it cuts every camera's run of observations
into consecutive pieces of at most Q, covers every observation once, lists
the empty cameras, is a pure function of ``cam_start`` and rides on
``build_plans``; and a plain emulation that sums in the kernel's order (a
thread's observations in turn, the warp shuffle trees, the block's warps in
order, a split camera's pieces in order) gives the plain version's U and gc
in f64.

Three layouts: the ladybug-49 stand-in, the 150-camera community problem of
``tests/test_torch_pairs_plan.py``, and a synthetic layout with empty cameras
(the last one among them), cameras just under and over a piece, and one
camera of more than ten pieces. K2 and K3 themselves are held against
``tpu_ba`` in ``tests/test_torch_kernels.py`` and against their plain
versions on the card in ``tests/test_torch_cuda.py``."""

import os

import numpy as np
import pytest
import torch

from test_torch_pairs_plan import community_problem
from tpu_ba_torch.core import make_problem
from tpu_ba_torch.io.bal import make_bal_like_problem
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
from tpu_ba_torch.kernels import linearize as lin
from tpu_ba_torch.solver.plans import build_plans

torch.set_num_threads(1)

CASES = ("ladybug49", "community", "synthetic")
SCHEDULES = ((lin.LIN_THREADS, lin.PIECE_OBS), (64, 256))


def _ladybug49():
    cwd = os.getcwd()
    tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"lin_sched_{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    os.chdir(tmp)                     # the generator caches under ./data/cache
    try:
        p, _ = make_bal_like_problem("ladybug-49", dtype=torch.float64, device="cpu")
    finally:
        os.chdir(cwd)
    return p


def _community():
    ref = community_problem()
    return make_problem(np.asarray(ref.cameras), np.asarray(ref.points),
                        np.asarray(ref.obs_2d)[:ref.n_obs], np.asarray(ref.cam_idx)[:ref.n_obs],
                        np.asarray(ref.pt_idx)[:ref.n_obs], dtype=torch.float64, pad_multiple=8,
                        device="cpu")


def _synthetic(seed=4):
    """Nine cameras with runs of 3, 0, 6,000 (twelve pieces of 500), 1,
    512, 513, 0, 1,024 and 0 observations of random points, padded to a
    multiple of 128 (the padding rows join camera 7, the last observed)."""
    base, _ = make_synthetic_problem(9, 200, obs_per_point=4, seed=seed, dtype=torch.float64,
                                     device="cpu")
    lens = np.array([3, 0, 6000, 1, 512, 513, 0, 1024, 0])
    rng = np.random.default_rng(seed)
    n = int(lens.sum())
    return make_problem(base.cameras.numpy(), base.points.numpy(), rng.normal(0.0, 50.0, (n, 2)),
                        np.repeat(np.arange(lens.size), lens), rng.integers(0, 200, n),
                        dtype=torch.float64, pad_multiple=128, device="cpu")


@pytest.fixture(scope="module")
def problems():
    return {"ladybug49": _ladybug49(), "community": _community(), "synthetic": _synthetic()}


def _cam_start(p):
    return build_plans(p.cam_idx, p.pt_idx, p.n_cameras, p.n_points).cam_start.numpy()


@pytest.mark.parametrize("threads,piece_obs", SCHEDULES)
@pytest.mark.parametrize("name", CASES)
def test_schedule_covers_every_observation_once_in_order(problems, name, threads, piece_obs):
    p = problems[name]
    starts = _cam_start(p).astype(np.int64)
    lens = np.diff(starts)
    s = lin.linearize_schedule(starts, threads=threads, piece_obs=piece_obs)
    cam, lo, hi = s.pieces.numpy().astype(np.int64)
    ps = s.piece_start.numpy()
    assert (s.threads, s.piece_obs, s.n_obs) == (threads, piece_obs, p.obs_2d.shape[0])
    assert s.longest == lens.max() and ps[0] == 0 and ps[-1] == cam.size
    assert np.array_equal(s.empty.numpy(), np.flatnonzero(lens == 0))
    assert np.array_equal(np.diff(ps), -(-lens // piece_obs))       # ceil(L / Q) pieces a camera
    assert np.all(np.diff(cam) >= 0) and np.all((hi > lo) & (hi - lo <= piece_obs))
    for c in range(lens.size):
        clo, chi = lo[ps[c]:ps[c + 1]], hi[ps[c]:ps[c + 1]]
        assert np.all(cam[ps[c]:ps[c + 1]] == c)
        if lens[c]:                                # consecutive, in order, near-equal
            assert clo[0] == starts[c] and chi[-1] == starts[c + 1]
            assert np.array_equal(clo[1:], chi[:-1])
            assert np.ptp(chi - clo) <= 1
    cover = np.zeros(p.obs_2d.shape[0], np.int64)
    for a, b in zip(lo, hi):
        cover[a:b] += 1
    assert np.all(cover == 1)
    assert s.ticket.shape == (lens.size + 1,) and not s.ticket.any()
    assert s.partial.shape == (cam.size, lin.CAM_SUMS) and s.cost_partial.shape == (cam.size,)
    if name == "synthetic" and piece_obs == lin.PIECE_OBS:
        assert np.diff(ps).max() > 10 and lens[-1] == 0 and (lens.size - 1) in s.empty.numpy()


@pytest.mark.parametrize("name", CASES)
def test_schedule_is_a_pure_function_of_cam_start(problems, name):
    starts = _cam_start(problems[name])
    a = lin.linearize_schedule(starts)
    b = lin.linearize_schedule(torch.as_tensor(starts))
    c = lin.linearize_schedule(starts.astype(np.int64).copy())
    for x, y, z, field in zip(a, b, c, lin.LinSchedule._fields):
        if field in ("partial", "cost_partial"):       # working memory, not a function
            assert x.shape == y.shape == z.shape
        elif isinstance(x, torch.Tensor):
            assert x.dtype == torch.int32 and x.is_contiguous()
            assert torch.equal(x, y) and torch.equal(x, z)
        else:
            assert x == y == z


@pytest.mark.parametrize("name", CASES)
def test_build_plans_carries_the_schedule(problems, name):
    p = problems[name]
    plans = build_plans(p.cam_idx, p.pt_idx, p.n_cameras, p.n_points)
    want = lin.linearize_schedule(plans.cam_start)
    for x, y, field in zip(plans.lin_sched, want, lin.LinSchedule._fields):
        if field not in ("partial", "cost_partial"):
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_schedule_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="non-decreasing"):
        lin.linearize_schedule(np.array([0, 5, 3]))
    with pytest.raises(ValueError, match="non-decreasing"):
        lin.linearize_schedule(np.array([2, 5]))
    with pytest.raises(ValueError, match="threads"):
        lin.linearize_schedule(np.array([0, 5]), threads=32)
    with pytest.raises(ValueError, match="piece_obs"):
        lin.linearize_schedule(np.array([0, 5]), piece_obs=0)
    s = lin.linearize_schedule(np.array([0, 0, 0]))
    assert s.pieces.shape == (3, 0) and s.empty.tolist() == [0, 1] and s.longest == 0


def _emulate(p, sched):
    """K2's U and gc in its summation order, in f64: thread t of a piece's
    block takes the observations w0 + t, w0 + t + T, … that lie in
    [lo, hi), w0 = lo rounded down to a multiple of 32; each warp folds by
    shuffles (off = 16 … 1), the warps' sums are added in order; a split
    camera's pieces are added in piece order from 0; an empty camera is 0."""
    r, Jc, _ = jacobian_blocks_bal(p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    iu = [(m, n) for m in range(9) for n in range(m, 9)]
    vals = torch.stack([Jc[0, m] * Jc[0, n] + Jc[1, m] * Jc[1, n] for m, n in iu]
                       + [Jc[0, m] * r[0] + Jc[1, m] * r[1] for m in range(9)])   # (54, O)
    O, T = vals.shape[1], sched.threads
    cam, lo, hi = sched.pieces.long()
    w0 = lo & ~31
    acc = torch.zeros((lin.CAM_SUMS, cam.numel(), T), dtype=vals.dtype)
    for it in range(-(-int((hi - w0).max()) // T)):
        q = w0[:, None] + torch.arange(T) + it * T
        live = (q >= lo[:, None]) & (q < hi[:, None])
        acc += torch.where(live, vals[:, q.clamp(max=O - 1)], 0.0)
    acc = acc.reshape(lin.CAM_SUMS, cam.numel(), T // 32, 32)
    off = 16
    while off:
        acc[..., :off] = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    piece = torch.zeros((lin.CAM_SUMS, cam.numel()), dtype=vals.dtype)
    for w in range(T // 32):
        piece = piece + acc[..., w, 0]
    ps = sched.piece_start.long()
    n = ps[1:] - ps[:-1]
    sums = torch.zeros((lin.CAM_SUMS, n.numel()), dtype=vals.dtype)
    for k in range(int(n.max())):
        sums += torch.where(k < n, piece[:, (ps[:-1] + k).clamp(max=cam.numel() - 1)], 0.0)
    U = torch.full((n.numel(), 9, 9), float("nan"), dtype=vals.dtype)
    for q, (m, nn) in enumerate(iu):
        U[:, m, nn] = U[:, nn, m] = sums[q]
    return U, sums[45:].T


@pytest.mark.parametrize("threads,piece_obs", SCHEDULES)
@pytest.mark.parametrize("name", CASES)
def test_emulation_in_kernel_order_matches_plain(problems, name, threads, piece_obs):
    p = problems[name]
    sched = lin.linearize_schedule(_cam_start(p), threads=threads, piece_obs=piece_obs)
    U, gc = _emulate(p, sched)
    U_ref, gc_ref, _, _ = lin.fused_linearize_assemble_plain(
        p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    assert torch.isfinite(U).all() and torch.isfinite(gc).all()
    for got, ref in ((U, U_ref), (gc, gc_ref)):
        assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
    empty = sched.empty.long()
    assert torch.all(U[empty] == 0) and torch.all(gc[empty] == 0)
