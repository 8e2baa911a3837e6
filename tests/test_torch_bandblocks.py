"""The band builds of the sparse-Schur tier against the reference.

For each of K7 (enumerated pairs), K5 (consecutive tracks) and K6 (slot-major
points) the port's plain PyTorch version is held against
  (a) the reference's jnp oracle in f64: 1e-10 of max|ref|, and
  (b) the reference's Pallas kernel in interpret mode in f32: 1e-4 of
      max|ref| (the kernel's 3-pass bf16 split is near-exact for one-hot
      operands; the rest is f32 summation order) where the kernel itself is
      that close to the f64 oracle on the same f32 inputs. Two f32 results
      cannot agree better than each agrees with f64, and at λ = 1e-4 the
      tracked points' W V⁻¹ Wᵀ cancels: there the Pallas kernel is 9e-4
      from f64 (the reference's own f32 oracle 1e-3), so the tolerance is
      four times the kernel's own distance, and the port's plain version is
      held to the same distance from f64,
on one problem whose plan engages all three (windowed visibility, half the
tracks with gaps, a few wrapped points). ``_compact_blocks`` as a whole is
held against the reference's with tracks, with slots and with both, and
every route against the pure pair enumeration of the same problem.

The reference's plan and blocks reach the port as numpy arrays
(``plan_to_port``, ``block_system_from_numpy``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pairs_plan import (gappy_problem, index_maps, plan_to_port, ring_problem)
from tpu_ba.jacobians import jacobian_blocks_bal as ref_jacobian_blocks_bal
from tpu_ba.kernels.pairblocks import fused_pair_blocks as ref_fused_pair_blocks
from tpu_ba.kernels.slotband import slot_band_blocks as ref_slot_band_blocks
from tpu_ba.kernels.trackband import fused_track_blocks as ref_fused_track_blocks
from tpu_ba.solver import pairs as ref_pairs
from tpu_ba.solver.normal import assemble as ref_assemble
from tpu_ba.solver.slots import slot_blocks_jnp
from tpu_ba.solver.tracks import track_blocks_jnp
from tpu_ba_torch.kernels.pairblocks import fused_pair_blocks, fused_pair_blocks_plain
from tpu_ba_torch.kernels.slotband import slot_band_blocks, slot_band_blocks_plain
from tpu_ba_torch.kernels.trackband import fused_track_blocks, fused_track_blocks_plain
from tpu_ba_torch.solver import pairs as port_pairs
from tpu_ba_torch.solver.normal import block_system_from_numpy

torch.set_num_threads(1)

FLOOR, CEIL = 1e-6, 1e32
LAMS = (1e-4, 1.0)
DT = {np.float64: torch.float64, np.float32: torch.float32}


def ref_system(problem, dtype=np.float64):
    """The reference's assembled BlockSystem of ``problem`` in ``dtype``."""
    cast = [jnp.asarray(np.asarray(a), dtype)
            for a in (problem.cameras, problem.points, problem.obs_2d)]
    r, Jc, Jp = ref_jacobian_blocks_bal(*cast, problem.cam_idx, problem.pt_idx, problem.mask)
    return ref_assemble(r, Jc, Jp, problem.cam_idx, problem.pt_idx, problem.cameras.shape[0],
                        problem.points.shape[0], 0, 1.0, problem.mask)


def system_to_port(B, dtype):
    return block_system_from_numpy(
        *(np.asarray(a) for a in (B.U, B.V, B.W, B.gc, B.gp, B.cam_idx, B.pt_idx)),
        dtype=DT[dtype], device="cpu")


def rel_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(out.double().numpy() - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def mixed():
    """Problem, per dtype: reference system and plan (kernel plans only for
    f32), their pair data, and the same carried to the port."""
    problem = gappy_problem(drop_share=0.5)
    out = {"problem": problem}
    for dtype in (np.float64, np.float32):
        kernels = dtype == np.float32
        B = ref_system(problem, dtype)
        plan = ref_pairs.build_pair_plan(*index_maps(problem), symmetric=True, slots=True,
                                         pad_multiple=128, with_kernel_plans=kernels)
        assert plan.track is not None and plan.slot is not None and plan.n_segments > 0
        assert int(np.asarray(plan.pair_key < plan.n_cameras ** 2).sum()) > 0
        Bp, pp = system_to_port(B, dtype), plan_to_port(plan, with_kernel_plans=kernels)
        out[dtype] = dict(B=B, plan=plan, pd=ref_pairs.precompute_pair_data(B, plan), Bp=Bp,
                          pp=pp, pdp=port_pairs.precompute_pair_data(Bp, pp))
    return out


def test_precompute_pair_data_matches_reference(mixed):
    m = mixed[np.float64]
    pd, pdp = m["pd"], m["pdp"]
    np.testing.assert_array_equal(pdp.packed.numpy(), np.asarray(pd.packed))
    np.testing.assert_array_equal(pdp.trk_W.numpy(), np.asarray(pd.trk_W))
    np.testing.assert_array_equal(pdp.trk_V.numpy(), np.asarray(pd.trk_V))
    assert len(pdp.slot_W) == len(pd.slot_W) > 0
    for a, b in zip(pdp.slot_W + pdp.slot_V, tuple(pd.slot_W) + tuple(pd.slot_V)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pdp.U_t.numpy(), np.asarray(pd.U_t))
    assert pdp.packed.is_contiguous() and pdp.trk_W.is_contiguous() and pdp.U_t.is_contiguous()


def _ref_blocks_fn(kernel, m, dtype, pallas):
    """λ ↦ the reference's result on the inputs of ``m`` taken in ``dtype``:
    the Pallas kernel in interpret mode, or the jnp oracle. Jitted, so both
    values of λ share one compilation."""
    plan = m["plan"]
    pd = jax.tree_util.tree_map(lambda a: a.astype(dtype), m["pd"])
    return jax.jit(lambda lam: _ref_blocks(kernel, plan, pd, lam, pallas))


def _ref_blocks(kernel, plan, pd, lam, pallas):
    kw = dict(dc=9, diag_floor=FLOOR, diag_ceil=CEIL, interpret=True)
    if kernel == "pair":
        if pallas:
            return ref_fused_pair_blocks(pd.packed, plan.pair_seg, lam, plan.k_pad,
                                         plan.seg_plan, **kw)
        vals = ref_pairs._pair_products_t(pd.packed, lam, 9, FLOOR, CEIL)
        return jax.ops.segment_sum(vals.T, plan.pair_seg, plan.k_pad).T
    if kernel == "track":
        if pallas:
            return ref_fused_track_blocks(pd.trk_W, pd.trk_V, lam, plan.track,
                                          **kw)[:, :plan.track.n_out]
        return track_blocks_jnp(pd.trk_W, pd.trk_V, lam, plan.track, 9, FLOOR, CEIL)
    if pallas:
        return ref_slot_band_blocks(pd.slot_W, pd.slot_V, lam, plan.slot, **kw)
    return slot_blocks_jnp(pd.slot_W, pd.slot_V, lam, plan.slot, 9, FLOOR, CEIL)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)],
                         ids=["f64_jnp_oracle", "f32_pallas_interpret"])
@pytest.mark.parametrize("kernel", ["pair", "track", "slot"])
def test_plain_versions_match_reference(mixed, kernel, dtype, tol):
    m = mixed[dtype]
    pp, pdp = m["pp"], m["pdp"]
    kw = dict(dc=9, diag_floor=FLOOR, diag_ceil=CEIL)
    pallas = dtype == np.float32
    ref_fn = _ref_blocks_fn(kernel, m, dtype, pallas)
    oracle_fn = _ref_blocks_fn(kernel, m, np.float64, False)
    for lam in LAMS:
        lam_t = torch.tensor(lam, dtype=DT[dtype])
        if kernel == "pair":
            plain = fused_pair_blocks_plain(pdp.packed, pp.pair_seg, lam_t, pp.k_pad, **kw)
            wrapped = fused_pair_blocks(pdp.packed, pp.pair_seg, lam_t, pp.k_pad, pp.pair_sched,
                                        **kw)
        elif kernel == "track":
            plain = fused_track_blocks_plain(pdp.trk_W, pdp.trk_V, lam_t, pp.track, **kw)
            wrapped = fused_track_blocks(pdp.trk_W, pdp.trk_V, lam_t, pp.track, **kw)
        else:
            plain = slot_band_blocks_plain(pdp.slot_W, pdp.slot_V, lam_t, pp.slot, **kw)
            wrapped = slot_band_blocks(pdp.slot_W, pdp.slot_V, lam_t, pp.slot, **kw)
        ref = ref_fn(jnp.asarray(lam, dtype))
        assert plain.shape == ref.shape and plain.dtype == DT[dtype]
        assert np.abs(np.asarray(ref)).max() > 0
        if pallas:
            oracle = oracle_fn(jnp.asarray(lam, np.float64))
            tol = max(tol, 4.0 * rel_err(torch.tensor(np.asarray(ref)), oracle))
            assert rel_err(plain, oracle) <= tol, (kernel, lam)
        assert rel_err(plain, ref) <= tol, (kernel, lam)
        assert torch.equal(wrapped, plain)       # on the CPU the wrapper is the plain version


def dense_T(blk, plan):
    """(C, C, 81) from compact blocks: T[ci, cj] of every real segment."""
    C = plan.n_cameras
    ci, cj = np.asarray(plan.seg_ci), np.asarray(plan.seg_cj)
    blk = blk.numpy() if isinstance(blk, torch.Tensor) else np.asarray(blk)
    T = np.zeros((C + 1, C, blk.shape[0]))
    np.add.at(T, (ci, cj), blk.T)
    return T[:C]


ROUTES = {
    "tracks": (ring_problem, dict(tracks=True, slots=False)),
    "slots": (gappy_problem, dict(tracks=False, slots=True)),
    "tracks_and_slots": (lambda: gappy_problem(drop_share=0.5), dict(tracks=True, slots=True)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_compact_blocks_match_reference_and_pair_enumeration(route):
    make, kw = ROUTES[route]
    problem = make()
    maps = index_maps(problem)
    B = ref_system(problem)
    Bp = system_to_port(B, np.float64)
    kw = dict(kw, symmetric=True, pad_multiple=16)
    ref_plan = ref_pairs.build_pair_plan(*maps, **kw)
    plan = port_pairs.build_pair_plan(*maps, device="cpu", **kw)
    assert (plan.track is not None) == kw["tracks"] and (plan.slot is not None) == kw["slots"]
    pure = port_pairs.build_pair_plan(*maps, device="cpu", **dict(kw, tracks=False, slots=False))
    assert pure.track is None and pure.slot is None and pure.n_pairs > plan.n_pairs
    for lam in LAMS:
        lam_t = torch.tensor(lam, dtype=torch.float64)
        ref = ref_pairs._compact_blocks(B, lam, ref_plan,
                                        ref_pairs.precompute_pair_data(B, ref_plan), FLOOR, CEIL)
        blk = port_pairs._compact_blocks(Bp, lam_t, plan,
                                         port_pairs.precompute_pair_data(Bp, plan), FLOOR, CEIL)
        assert rel_err(blk, ref) <= 1e-10
        assert torch.all(blk[:, plan.n_segments:] == 0)      # columns ≥ K are exact zeros
        blk_pure = port_pairs._compact_blocks(
            Bp, lam_t, pure, port_pairs.precompute_pair_data(Bp, pure), FLOOR, CEIL)
        T, T_pure = dense_T(blk, plan), dense_T(blk_pure, pure)
        assert np.abs(T - T_pure).max() <= 1e-10 * np.abs(T_pure).max()


def test_compact_blocks_with_kernel_plans_take_the_wrappers_plain_route_on_cpu(mixed):
    """A plan with kernel plans and one without build the same blocks on the
    CPU, where every wrapper takes its plain version."""
    m = mixed[np.float32]
    lam = torch.tensor(1e-3)
    with_plans = port_pairs._compact_blocks(m["Bp"], lam, m["pp"], m["pdp"], FLOOR, CEIL)
    bare = plan_to_port(m["plan"], with_kernel_plans=False)
    assert bare.seg_start is None and bare.track.key_start is None and bare.slot.inc_start is None
    assert bare.pair_sched is None and m["pp"].pair_sched is not None
    assert bare.slot.inc is None
    without = port_pairs._compact_blocks(m["Bp"], lam, bare, m["pdp"], FLOOR, CEIL)
    assert torch.equal(with_plans, without)


@pytest.mark.parametrize("lam", LAMS)
def test_track_blocks_add_into_the_band_they_are_given(mixed, lam):
    """``out=``: on the CPU the plain version's (dmax·81, c_pad) rows land on
    top of the band in its layout, offset g of entry e at columns
    g·c_pad..(g+1)·c_pad of row e; the columns behind dmax·c_pad are left
    alone, and a band narrower than that grid is refused."""
    m = mixed[np.float32]
    tl, pdp = m["pp"].track, m["pdp"]
    kw = dict(dc=9, diag_floor=FLOOR, diag_ceil=CEIL)
    lam_t = torch.tensor(lam)
    plain = fused_track_blocks_plain(pdp.trk_W, pdp.trk_V, lam_t, tl, **kw)
    band = torch.from_numpy(np.random.default_rng(4).normal(size=(81, m["pp"].k_pad))
                            .astype(np.float32))
    want = band.clone()
    cp = tl.n_out
    for g in range(tl.dmax):
        want[:, g * cp:(g + 1) * cp] += plain[g * 81:(g + 1) * 81]
    got = fused_track_blocks(pdp.trk_W, pdp.trk_V, lam_t, tl, out=band, **kw)
    assert got is band and torch.equal(band, want)
    assert m["pp"].k_pad > tl.dmax * cp
    with pytest.raises(ValueError):
        fused_track_blocks(pdp.trk_W, pdp.trk_V, lam_t, tl, out=band[:, :tl.dmax * cp - 1], **kw)
