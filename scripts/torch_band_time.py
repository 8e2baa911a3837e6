#!/usr/bin/env python3
"""Time the band-build kernels of ladybug-1723 as ``_compact_blocks`` calls
them, and K2 and K3 as the LM loop calls them, for one tree of the port, on
one CUDA card.

    python3 scripts/torch_band_time.py [--root DIR] [--lam 1e-4] [--venice]

``--root`` is the directory that holds the ``tpu_ba_torch`` package to time
(default: this checkout). To compare two commits, unpack the other with
``git archive`` and run this script once for each root on the same card, e.g.
other, this, this, other: the calls go through the wrappers' public
signatures and the plan and pair data of ``build_pair_plan`` /
``precompute_pair_data``, which every tree of the port has, whatever its
kernel does inside.

Two clocks per call, in ms, each 20 calls replayed from a CUDA graph and
timed by CUDA events: ``cold``, over copies of the kernel's point data that
rotate through more than twice the L2's size, so that each call reads it from
device memory, as in a solve; ``l2``, the same on one copy, which the replays
find in L2 where it fits. Each kernel is first checked against its plain
version in f64 (worst (entry, offset) row). Prints the card's name and power
limit first. A kernel is one entry of ``CASES``: K7, K5 and K6. A tree whose
K5 wrapper has no ``out`` (K5 before it added into the band) is timed as its
``_compact_blocks`` called it, the kernel and then its dmax slice adds into
the band, and its bare kernel on a line of its own. K7 takes the plan's
schedule (``PairPlan.pair_sched``), or its CSR starts in a tree that has no
schedule (K7 before it was split by pairs).

``--venice`` also times K7 at venice-1778-community's shape (non-banded,
15.8 M pairs into 665,600 segments; generated into ``data/cache/`` under the
working directory on the first run, ~50 s, and read from there after): the
median of 10 calls between CUDA events, after the same check against f64.
Its 4 GB of pair data are read from device memory on every call.

K2 (linearize + assemble) and K3 (trial cost) are timed too, as the LM loop
calls them on ladybug-1723 (no robust loss), on the same two clocks over
copies of ``points`` and ``obs_2d``, after a check of every output against
the plain version in f64; with ``--venice`` also at venice-1778-community's
shape (eager events: K2 writes 800 MB a call). A tree whose K2 and K3 take no
schedule (``AssemblyPlans.lin_sched``, K2 before it was cut into pieces) is
called through its own signature, with ``cam_start`` alone.
"""

import argparse
import os
import statistics
import subprocess
import sys

L2_BYTES = 50 << 20


def event_ms(torch, fn, reps=10, warmup=2):
    times = []
    for i in range(warmup + reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def replay_ms(torch, fns, launches=20):
    """ms per call of ``launches`` calls, taken in turn from ``fns``,
    replayed from a CUDA graph."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    return event_ms(torch, graph.replay) / launches


def n_copies(n_bytes, launches=20):
    """How many copies of ``n_bytes`` of data make more than twice the L2."""
    return min(launches, max(1, -(-2 * L2_BYTES // n_bytes) + 1))


def k5(torch, plan, pd, lam, band, kw):
    """K5 as ``_compact_blocks`` calls it: adding into the band under
    assembly where its wrapper takes ``out``, else the kernel and then the
    dmax slice adds of its (dmax·81, c_pad) output; its point data is W.
    Returns (call on a W, W, plain call in the band's layout, the bare kernel
    of a tree without ``out`` or None)."""
    import inspect

    from tpu_ba_torch.kernels.trackband import fused_track_blocks, fused_track_blocks_plain

    tl, cp = plan.track, plan.c_pad
    takes_out = "out" in inspect.signature(fused_track_blocks).parameters

    def bare(ws):
        return fused_track_blocks(ws[0], pd.trk_V, lam, tl, **kw)

    def call(ws):
        if takes_out:
            return fused_track_blocks(ws[0], pd.trk_V, lam, tl, out=band, **kw)
        tout = bare(ws)
        for g in range(tl.dmax):
            pos = plan.band_offsets.index(g) * cp
            band[:, pos:pos + cp] += tout[g * 81:(g + 1) * 81, :cp]
        return band

    def plain(ws, vs, lam_):
        out = fused_track_blocks_plain(ws[0], vs[0], lam_, tl, **kw)
        return out.reshape(tl.dmax, 81, cp).transpose(0, 1).reshape(81, tl.dmax * cp)

    return call, [pd.trk_W], (plain, [pd.trk_V]), None if takes_out else bare


def k7(torch, plan, pd, lam, band, kw):
    """K7 over the plan's pairs into a fresh (81, k_pad) output; its data is
    ``packed``. Returns (call on packed, packed, plain call, None)."""
    from tpu_ba_torch.kernels.pairblocks import fused_pair_blocks, fused_pair_blocks_plain

    sched = getattr(plan, "pair_sched", None)
    sched = plan.seg_start if sched is None else sched

    def call(ws):
        return fused_pair_blocks(ws[0], plan.pair_seg, lam, plan.k_pad, sched, **kw)

    def plain(ws, vs, lam_):
        out = fused_pair_blocks_plain(ws[0], plan.pair_seg, lam_, plan.k_pad, **kw)
        out[:, -1] = 0.0            # the padding pairs' trash segment: zero from the kernel
        return out

    return call, [pd.packed], (plain, []), None


def k6(torch, plan, pd, lam, band, kw):
    """K6 adding into the band under assembly, as ``_compact_blocks`` calls
    it; its point data is W. Returns (call on a W, W, plain call, None)."""
    from tpu_ba_torch.kernels.slotband import slot_band_blocks, slot_band_blocks_plain

    def call(ws):
        return slot_band_blocks(ws, pd.slot_V, lam, plan.slot, out=band, **kw)

    def plain(ws, vs, lam_):
        return slot_band_blocks_plain(ws, vs, lam_, plan.slot, **kw)

    return call, list(pd.slot_W), (plain, list(pd.slot_V)), None


# name → maker of (call on the point data, the point data, (plain, its other
# inputs), the bare kernel where the call is more than the kernel, or None)
CASES = {"K7 pairblocks": k7, "K5 trackband": k5, "K6 slotband": k6}


def worst_row(got, ref):
    """Worst row's max abs error over that row's max |ref|."""
    scale = ref.abs().amax(1).clamp_min(1e-300)
    return ((got.double() - ref).abs().amax(1) / scale).max().item()


def lin_calls(cams, ci, pi, mask, plans, robust_kind=0, robust_scale=1.0):
    """K2 and K3 as the tree's LM loop calls them, each a function of
    (points, obs_2d): the tree's schedule (``plans.lin_sched``) where its
    wrappers take one, else ``cam_start`` alone for K2 and nothing for K3."""
    import inspect

    from tpu_ba_torch.kernels.linearize import fused_cost, fused_linearize_assemble

    sched = getattr(plans, "lin_sched", None)
    kw = dict(robust_kind=robust_kind, robust_scale=robust_scale)
    kw2 = dict(kw, sched=sched) if sched is not None else kw
    takes = "sched" in inspect.signature(fused_cost).parameters
    kw3 = dict(kw, sched=sched) if takes else kw

    def k2(pts, obs):
        return fused_linearize_assemble(cams, pts, obs, ci, pi, mask, plans.cam_start, **kw2)

    def k3(pts, obs):
        return fused_cost(cams, pts, obs, ci, pi, mask, **kw3)

    return k2, k3


def lin_errors(cams, pts, obs, ci, pi, mask, k2, k3, robust_kind=0, robust_scale=1.0):
    """(K2's worst output array, K3's) max abs error over max |ref| against
    the plain versions in f64 on the same inputs."""
    from tpu_ba_torch.kernels.linearize import (fused_cost_plain,
                                                fused_linearize_assemble_plain)

    kw = dict(robust_kind=robust_kind, robust_scale=robust_scale)
    args64 = (cams.double(), pts.double(), obs.double(), ci, pi, mask)
    ref = fused_linearize_assemble_plain(*args64, **kw)
    got = k2(pts, obs)
    e2 = max((g.double() - r).abs().max().item() / max(r.abs().max().item(), 1e-300)
             for g, r in zip(got, ref))
    del ref, got
    c = fused_cost_plain(*args64, **kw).item()
    return e2, abs(k3(pts, obs).item() - c) / abs(c)


def time_lin(torch, name, cams, pts, obs, ci, pi, mask, plans, graph=True):
    """Check K2 and K3 against f64 and print their times: cold / l2 on the
    graph clock, or eager events with ``graph=False``."""
    k2, k3 = lin_calls(cams, ci, pi, mask, plans)
    e2, e3 = lin_errors(cams, pts, obs, ci, pi, mask, k2, k3)
    n_bytes = pts.numel() * 4 + obs.numel() * 4
    for kname, fn, e in (("K2 linearize", k2, e2), ("K3 cost", k3, e3)):
        if graph:
            sets = [(pts, obs)] + [(pts.clone(), obs.clone())
                                   for _ in range(n_copies(n_bytes) - 1)]
            t = (f"{replay_ms(torch, [lambda s=s: fn(*s) for s in sets]):.4f} / "
                 f"{replay_ms(torch, [lambda: fn(pts, obs)]):.4f}")
            what = f"{len(sets):2d} copies of {n_bytes / 1e6:.1f} MB"
            del sets
        else:
            t = f"{event_ms(torch, lambda: fn(pts, obs)):.4f} (eager events, median of 10)"
            what = f"{obs.shape[0]} observations"
        print(f"{kname + ' ' + name:30s} {what} | {t} | worst output {e:.2e} from f64",
              flush=True)


def system(p, jacobian_blocks_bal, assemble):
    r, Jc, Jp = jacobian_blocks_bal(p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    B = assemble(r, Jc, Jp, p.cam_idx, p.pt_idx, p.n_cameras, p.n_points, mask=p.mask)
    return B._replace(U=B.U.contiguous(), W=B.W.contiguous())


def venice_cases(torch, lam, kw):
    """K7, then K2 and K3, at venice-1778-community's shape: ms a call (eager
    events) and the worst row or output against f64."""
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
    from tpu_ba_torch.kernels.pairblocks import fused_pair_blocks_plain
    from tpu_ba_torch.solver import pairs as pairs_mod
    from tpu_ba_torch.solver.lm import build_solver_plans
    from tpu_ba_torch.solver.normal import assemble

    dev = lam.device
    p, _ = make_bal_like_problem("venice-1778", covis="community", dtype=torch.float32,
                                 device=dev)
    plans, plan = build_solver_plans(p, LMConfig(linear_solver="schur_sparse_pallas"))
    pd = pairs_mod.precompute_pair_data(system(p, jacobian_blocks_bal, assemble), plan)
    call, data, _, _ = k7(torch, plan, pd, lam, None, kw)
    # f64 over the real pairs only, in chunks: the trash segment stays 0
    n_real = int((plan.pair_key < p.n_cameras ** 2).sum())
    ref = torch.zeros((81, plan.k_pad), dtype=torch.float64, device=dev)
    step = 1 << 20
    for a0 in range(0, n_real, step):
        a1 = min(a0 + step, n_real)
        ref += fused_pair_blocks_plain(data[0][:, a0:a1].double(), plan.pair_seg[a0:a1],
                                       lam.double(), plan.k_pad, **kw)
    worst = worst_row(call(data), ref)
    del ref
    ms = event_ms(torch, lambda: call(data))
    n_bytes = data[0].numel() * data[0].element_size()
    print(f"{'K7 venice':16s} {n_real} pairs, {n_bytes / 1e9:.2f} GB of packed | {ms:.4f} ms "
          f"(eager events, median of 10) | worst row {worst:.2e} from f64", flush=True)
    del data, pd, plan
    torch.cuda.empty_cache()
    time_lin(torch, "venice", p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask,
             plans, graph=False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--venice", action="store_true",
                    help="also time K7, K2 and K3 at venice-1778-community's shape")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_band_time: needs a CUDA card", file=sys.stderr)
        return 1
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
    from tpu_ba_torch.solver import pairs as pairs_mod
    from tpu_ba_torch.solver.normal import assemble
    from tpu_ba_torch.solver.plans import build_plans

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    p, _ = make_bal_like_problem("ladybug-1723", dtype=torch.float32, device=dev)
    B = system(p, jacobian_blocks_bal, assemble)
    plan = pairs_mod.build_pair_plan(p.cam_idx, p.pt_idx, p.n_obs, p.n_cameras, p.n_points,
                                     with_kernel_plans=True, symmetric=True)
    pd = pairs_mod.precompute_pair_data(B, plan)
    kw = dict(dc=9, diag_floor=LMConfig().diag_floor, diag_ceil=LMConfig().diag_ceil)
    lam = torch.tensor(args.lam, device=dev)
    print(f"root {root}; lam {args.lam:g}; ms per call: cold / l2", flush=True)
    for name, make in CASES.items():
        band = torch.zeros((81, plan.k_pad), device=dev)
        call, data, (plain, rest), bare = make(torch, plan, pd, lam, band, kw)
        # the kernel's contribution against the plain version in f64
        ref = plain([t.double() for t in data], [t.double() for t in rest], lam.double())
        worst = worst_row(call(data)[:, :ref.shape[1]], ref)
        n_bytes = sum(t.numel() * t.element_size() for t in data)
        sets = [data] + [[t.clone() for t in data] for _ in range(n_copies(n_bytes) - 1)]
        cold = replay_ms(torch, [lambda s=s: call(s) for s in sets])
        l2 = replay_ms(torch, [lambda: call(data)])
        print(f"{name:16s} {len(sets):2d} copies of {n_bytes / 1e6:.1f} MB | {cold:.4f} / {l2:.4f}"
              f" | worst (entry, offset) row {worst:.2e} from f64", flush=True)
        if bare is not None:
            cold = replay_ms(torch, [lambda s=s: bare(s) for s in sets])
            l2 = replay_ms(torch, [lambda: bare(data)])
            print(f"{name + ' bare':16s} {len(sets):2d} copies of {n_bytes / 1e6:.1f} MB | "
                  f"{cold:.4f} / {l2:.4f} | the kernel alone, without the slice adds", flush=True)
        del sets, band
    time_lin(torch, "ladybug-1723", p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask,
             build_plans(p.cam_idx, p.pt_idx, p.n_cameras, p.n_points))
    if args.venice:
        del pd, plan, B, p
        torch.cuda.empty_cache()
        venice_cases(torch, lam, kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
