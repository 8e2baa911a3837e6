"""K7's schedule (``tpu_ba_torch/kernels/pairblocks.py:pair_schedule``) on the
CPU: it covers every real pair once and in order, keeps the short items apart
from the split segments, is a pure function of ``pair_seg``, and a plain
emulation that sums in the kernel's order (a lane's pairs in turn, the shuffle
trees, the block's warps in order, the pieces in order) gives the plain
version's blocks in f64.

Three layouts: the 150-camera community problem of
``tests/test_torch_pairs_plan.py`` (non-banded), the ladybug-49 stand-in's
banded plan, and a synthetic sorted ``pair_seg`` with a power-law spread of
lengths (empty segments, segments of one pair, one of 5,000 pairs that spans
ten pieces, padding pairs at the end). The pair data is drawn from a numpy
seed: only the summation order is under test."""

import math
import os

import numpy as np
import pytest
import torch

from test_torch_pairs_plan import community_problem, index_maps
from tpu_ba_torch.io.bal import make_bal_like_problem
from tpu_ba_torch.kernels import pairblocks as pb
from tpu_ba_torch.solver import pairs as port_pairs

torch.set_num_threads(1)

FLOOR, CEIL = 1e-6, 1e32
CASES = ("community", "ladybug49", "power_law")


def _synthetic_pair_seg(seed=8):
    """(pair_seg with padding pairs in the trash segment, k_pad, n_real)."""
    rng = np.random.default_rng(seed)
    k_pad = 640
    lens = np.minimum(rng.zipf(1.6, k_pad), 900)
    lens[rng.random(k_pad) < 0.3] = 0                 # empty segments
    lens[rng.random(k_pad) < 0.2] = 1
    lens[200] = 5000                                  # ten pieces, the last one short
    lens[-1] = 0                                      # the trash segment has no real pair
    seg = np.repeat(np.arange(k_pad), lens)
    n_real = seg.size
    return np.concatenate([seg, np.full(37, k_pad - 1)]), k_pad, n_real


def _ladybug49_plan():
    cwd = os.getcwd()
    tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"pair_sched_{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    os.chdir(tmp)                     # the generator caches under ./data/cache
    try:
        p, _ = make_bal_like_problem("ladybug-49", dtype=torch.float64, device="cpu")
    finally:
        os.chdir(cwd)
    return port_pairs.build_pair_plan(p.cam_idx, p.pt_idx, p.n_obs, p.n_cameras, p.n_points,
                                      symmetric=True, with_kernel_plans=True, device="cpu")


@pytest.fixture(scope="module")
def layouts():
    """name → (pair_seg (Np,), k_pad, n_real, the plan's schedule or None)."""
    out = {}
    plan = port_pairs.build_pair_plan(*index_maps(community_problem()), symmetric=True,
                                      pad_multiple=16, with_kernel_plans=True, device="cpu")
    assert not plan.banded
    for name, pl in (("community", plan), ("ladybug49", _ladybug49_plan())):
        n_real = int((pl.pair_key < pl.n_cameras ** 2).sum())
        out[name] = (pl.pair_seg.numpy(), pl.k_pad, n_real, pl.pair_sched)
    seg, k_pad, n_real = _synthetic_pair_seg()
    out["power_law"] = (seg, k_pad, n_real, None)
    return out


def _starts(seg, k_pad, n_real):
    return np.searchsorted(seg[:n_real], np.arange(k_pad + 1), side="left")


def _schedule(layouts, name):
    seg, k_pad, n_real, _ = layouts[name]
    return pb.pair_schedule(_starts(seg, k_pad, n_real), device="cpu")


@pytest.mark.parametrize("name", CASES)
def test_schedule_covers_every_real_pair_once_in_order(layouts, name):
    seg, k_pad, n_real, _ = layouts[name]
    starts = _starts(seg, k_pad, n_real)
    lens = np.diff(starts)
    s = _schedule(layouts, name)
    items, pieces = s.items.numpy().astype(np.int64), s.pieces.numpy().astype(np.int64)
    empty, fold_seg, fold_start = s.empty.numpy(), s.fold_seg.numpy(), s.fold_start.numpy()
    med = np.median(lens[lens > 0])
    G = 1 << s.group_log2
    assert G == 32 or G >= med > G // 2 or (G == 1 and med <= 1)     # median, rounded up
    assert s.cut == G * pb.SHORT_ITERS and s.longest == lens.max()
    # every segment is a short item, an empty one or a split one, never two
    assert np.array_equal(np.sort(np.concatenate([items[0], empty, fold_seg])), np.arange(k_pad))
    assert all(np.all(np.diff(a) > 0) for a in (items[0], empty, fold_seg))
    assert np.array_equal(empty, np.flatnonzero(lens == 0))
    # a short item is its whole non-empty segment of at most cut pairs
    assert np.array_equal(items[1], starts[items[0]]) and np.array_equal(items[2],
                                                                         starts[items[0] + 1])
    assert np.all((items[2] > items[1]) & (items[2] - items[1] <= s.cut))
    # a split segment's pieces tile it in order; none crosses a segment
    n_pieces = np.diff(fold_start)
    assert np.all(lens[fold_seg] > s.cut) and np.all(n_pieces > 0)
    for j in range(fold_seg.size):
        lo, hi = pieces[:, fold_start[j]:fold_start[j + 1]]
        k = fold_seg[j]
        assert lo[0] == starts[k] and hi[-1] == starts[k + 1]
        assert np.array_equal(lo[1:], hi[:-1])
        assert np.all((hi > lo) & (hi - lo <= pb.PIECE_PAIRS))
        assert np.all(hi[:-1] - lo[:-1] == pb.PIECE_PAIRS)
    assert fold_start[-1] == pieces.shape[1] and np.all(np.diff(pieces[0]) > 0)
    # every real pair exactly once, no padding pair
    cover = np.zeros(seg.size, np.int64)
    for lo, hi in list(zip(items[1], items[2])) + list(zip(pieces[0], pieces[1])):
        cover[lo:hi] += 1
    assert np.all(cover[:n_real] == 1) and np.all(cover[n_real:] == 0)
    if name == "power_law":
        assert n_pieces.max() == 10 and k_pad - 1 in empty   # the trash segment: written 0
    if layouts[name][3] is not None:                              # what the plan carries
        for a, b in zip(layouts[name][3], s):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("name", CASES)
def test_schedule_is_a_pure_function_of_pair_seg(layouts, name):
    a, b = _schedule(layouts, name), _schedule(layouts, name)
    seg, k_pad, n_real, _ = layouts[name]
    c = pb.pair_schedule(_starts(seg.copy(), k_pad, n_real).astype(np.int32), device="cpu")
    for x, y, z in zip(a, b, c):
        if isinstance(x, torch.Tensor):
            assert x.dtype == torch.int32 and x.is_contiguous()
            assert torch.equal(x, y) and torch.equal(x, z)
        else:
            assert x == y == z


def _packed(n_pairs, seed):
    """(63, Np) f64 pair data: W rows of either side and an SPD V."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 1.0, (54, n_pairs))
    A = rng.normal(0.0, 1.0, (3, 3, n_pairs))
    V = np.einsum("abn,cbn->acn", A, A) + 0.5 * np.eye(3)[:, :, None]
    return torch.tensor(np.concatenate([W, V.reshape(9, n_pairs)]))


def _emulate(packed, sched, n_out, lam):
    """K7's sums in its order: a lane of a short item's group takes the
    segment's pairs lane, lane + G, …; the group folds by shuffles (off = G/2
    … 1); a piece's thread t takes pairs t, t + 64, …, each warp folds by
    shuffles (off = 16 … 1) and the two warps' sums are added in order; the
    fold adds a split segment's pieces in order from 0; an empty segment is 0."""
    vals = pb.block_products_rows(packed[:27], pb.damped_vinv_rows(packed[54:], lam, FLOOR, CEIL),
                                  packed[27:54], 9)
    Np = vals.shape[1]
    out = torch.full((81, n_out), float("nan"), dtype=vals.dtype)

    def walk(lo, hi, width, iters):
        acc = torch.zeros((81, lo.numel(), width), dtype=vals.dtype)
        for it in range(iters):
            q = lo[:, None] + torch.arange(width) + it * width
            acc += torch.where(q < hi[:, None], vals[:, q.clamp(max=Np - 1)], 0.0)
        return acc

    def tree(acc, width):
        off = width // 2
        while off:
            acc[..., :off] = acc[..., :off] + acc[..., off:2 * off]
            off //= 2
        return acc[..., 0]

    seg, lo, hi = sched.items.long()
    G = 1 << sched.group_log2
    out[:, seg] = tree(walk(lo, hi, G, math.ceil(sched.cut / G)), G)
    lo, hi = sched.pieces.long()
    T = pb.PIECE_THREADS
    acc = walk(lo, hi, T, pb.PIECE_PAIRS // T).reshape(81, lo.numel(), T // 32, 32)
    warps = tree(acc, 32)
    partial = warps[..., 0]
    for w in range(1, T // 32):
        partial = partial + warps[..., w]
    fs = sched.fold_start.long()
    n = fs[1:] - fs[:-1]
    s = torch.zeros((81, n.numel()), dtype=vals.dtype)
    for k in range(int(n.max()) if n.numel() else 0):
        s += torch.where(k < n, partial[:, (fs[:-1] + k).clamp(max=max(lo.numel() - 1, 0))], 0.0)
    out[:, sched.fold_seg.long()] = s
    out[:, sched.empty.long()] = 0.0
    return out


@pytest.mark.parametrize("lam", [1e-4, 1.0])
@pytest.mark.parametrize("name", CASES)
def test_emulation_in_schedule_order_matches_plain(layouts, name, lam):
    seg, k_pad, n_real, _ = layouts[name]
    sched = _schedule(layouts, name)
    packed = _packed(seg.size, seed=len(name))
    lam_t = torch.tensor(lam, dtype=torch.float64)
    got = _emulate(packed, sched, k_pad, lam_t)
    plain = pb.fused_pair_blocks_plain(packed, torch.as_tensor(seg), lam_t, k_pad,
                                       diag_floor=FLOOR, diag_ceil=CEIL)
    plain[:, -1] = 0.0                          # the padding pairs' trash segment
    assert torch.all(got[:, np.diff(_starts(seg, k_pad, n_real)) == 0] == 0)
    assert torch.all(got[:, -1] == 0)
    assert (got - plain).abs().max() <= 1e-12 * plain.abs().max()
