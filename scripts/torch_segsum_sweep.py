#!/usr/bin/env python3
"""Sweep the schedules of the K1 segment-sum kernel on one CUDA card.

    python3 scripts/torch_segsum_sweep.py

Times ``sorted_segment_sum_t`` under every schedule (2ᵍ lanes a segment for
g = 0 … 5, and a block of 128 threads a segment) at the shapes of the main
paths (ladybug-1723's point- and camera-keyed sums, the point-keyed sums
through the fused permutation, the compact matvec's camera sums on the pair
plan of venice-1778-community), on even camera runs with one run stretched
(where the longest segment starts to decide), on power-law keys and at
synthetic mean segment lengths, beside ``scatter_add_`` into a cleared
output. The rule of ``tpu_ba_torch/kernels/segsum.py:group_log2`` is read off
this table; the schedule it picks from the longest segment is marked with
``*``, the one it picks without knowing it with ``^``. Device times: 20 calls
captured into a CUDA graph, the replays timed by CUDA events (launched call
by call from Python such a call takes longer to launch than to run). Two
lines a case: ``cold``, over copies of the values that rotate through more
than twice the L2's size, so that each call reads them from device memory as
a call inside a solve does (the rule is fitted to these), and ``l2``, on one
copy, which the replays find in L2 where it fits. Prints the card's name and
power limit first.
"""

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_ba_torch.io.bal import make_bal_like_problem  # noqa: E402
from tpu_ba_torch.kernels.segsum import (BLOCK_LOG2, group_log2,  # noqa: E402
                                         sorted_segment_sum_t, sorted_segment_sum_t_plain)
from tpu_ba_torch.solver.lm import LMConfig, build_solver_plans  # noqa: E402
from tpu_ba_torch.solver.plans import build_plans, longest_segment  # noqa: E402

SCHEDULES = (0, 1, 2, 3, 4, 5, BLOCK_LOG2)


L2_BYTES = 50 << 20


def median_ms(fns, launches=20, reps=10, warmup=2):
    """ms per call of ``launches`` calls, taken in turn from ``fns``,
    replayed from a CUDA graph."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    times = []
    for i in range(warmup + reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def copies(vals, launches=20):
    """``vals`` and clones of it, more than twice the L2's size in all."""
    n = min(launches, max(1, -(-2 * L2_BYTES // (vals.numel() * 4)) + 1))
    return [vals] + [vals.clone() for _ in range(n - 1)]


def sweep(name, vals, keys, n_out, starts, perm=None, lib_keys=None):
    D, O = vals.shape
    ref = sorted_segment_sum_t_plain(vals.double(), keys, n_out, perm=perm)
    longest = longest_segment(starts.cpu().numpy())
    picked = group_log2(O, n_out, D, longest, gathered=perm is not None)
    blind = group_log2(O, n_out, D)
    lib_out = torch.empty((D, n_out), device=vals.device)
    lib_idx = (keys if lib_keys is None else lib_keys).long().expand(D, O)
    for g in SCHEDULES:
        out = sorted_segment_sum_t(vals, keys, n_out, starts, perm=perm, schedule=g)
        rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
        if not rel <= 1e-5:
            raise AssertionError(f"{name}, schedule {g}: relative error {rel}")
    del out, ref
    print(f"{name}: mean {O / n_out:.1f}, longest {longest}", flush=True)
    for clock, sets in (("cold", copies(vals)), ("l2", [vals])):
        cells = []
        for g in SCHEDULES:
            ms = median_ms([lambda v=v: sorted_segment_sum_t(v, keys, n_out, starts, perm=perm,
                                                             schedule=g) for v in sets])
            cells.append(f"{'*' if g == picked else '^' if g == blind else ' '}{ms:.4f}")
        lms = median_ms([lambda v=v: lib_out.zero_().scatter_add_(1, lib_idx, v) for v in sets])
        print(f"  {clock:4s} {len(sets):2d} | " + " ".join(cells) + f" | {lms:.4f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_segsum_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"ms per call; schedules g = {SCHEDULES} ({BLOCK_LOG2}: a block a segment); last "
          f"column scatter_add_", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    problem, _ = make_bal_like_problem("ladybug-1723", dtype=torch.float32, device=dev)
    C, P, O = problem.n_cameras, problem.n_points, problem.obs_2d.shape[0]
    plans = build_plans(problem.cam_idx, problem.pt_idx, C, P)
    for D in (3, 12):
        vals = torch.randn((D, O), generator=gen, device=dev)
        sweep(f"ladybug-1723 ({D},O)->P sorted", vals, plans.pt_sorted_keys, P, plans.pt_start)
        sweep(f"ladybug-1723 ({D},O)->P through perm", vals, plans.pt_sorted_keys, P,
              plans.pt_start, perm=plans.perm_pt, lib_keys=problem.pt_idx)
    for D in (9, 81):
        vals = torch.randn((D, O), generator=gen, device=dev)
        sweep(f"ladybug-1723 ({D},O)->C", vals, problem.cam_idx, C, plans.cam_start)
    del problem, plans
    # the compact matvec's sums on the real pair plan: by row camera, and by
    # column camera through the plan's permutation
    vp, _ = make_bal_like_problem("venice-1778", covis="community", dtype=torch.float32,
                                  device=dev)
    _, vplan = build_solver_plans(vp, LMConfig(linear_solver="schur_sparse_pallas"))
    Cv, kp = vp.n_cameras, vplan.k_pad
    del vp
    vals = torch.randn((9, kp), generator=gen, device=dev)
    sweep(f"venice-1778-community (9,{kp}) by seg_ci", vals, vplan.seg_ci, Cv + 1, vplan.ci_start)
    unsorted = torch.empty_like(vplan.cj_keys)
    unsorted[vplan.seg_perm_cj.long()] = vplan.cj_keys
    sweep(f"venice-1778-community (9,{kp}) by cj, perm", vals, vplan.cj_keys, Cv + 1,
          vplan.cj_start, perm=vplan.seg_perm_cj, lib_keys=unsorted)
    del vplan, unsorted
    # even camera runs of 394 with one run stretched: where the longest decides
    for D, stretches in ((9, (1024, 2048, 4096, 8192, 32768)), (81, (2048, 8192))):
        for stretch in stretches:
            lens = np.full(1723, 394)
            lens[861] = stretch
            starts_np = np.concatenate([[0], np.cumsum(lens)])
            keys = torch.tensor(np.repeat(np.arange(1723), lens).astype(np.int32), device=dev)
            vals = torch.randn((D, int(starts_np[-1])), generator=gen, device=dev)
            sweep(f"even 394, one run of {stretch} ({D},O)->1723", vals, keys, 1723,
                  torch.tensor(starts_np.astype(np.int32), device=dev))
    # power-law keys: 1,779 cameras of very uneven segment counts
    n_out, k_pad = 1779, 665600
    pop = (1.0 + np.arange(n_out)) ** -0.9
    unsorted = rng.choice(n_out, k_pad, p=pop / pop.sum())
    perm = np.argsort(unsorted, kind="stable")
    keys = torch.tensor(unsorted[perm].astype(np.int32), device=dev)
    starts = torch.tensor(np.searchsorted(unsorted[perm], np.arange(n_out + 1)).astype(np.int32),
                          device=dev)
    vals = torch.randn((9, k_pad), generator=gen, device=dev)
    sweep("power law (9,665600)->1779 sorted", vals, keys, n_out, starts)
    sweep("power law (9,665600)->1779 through perm", vals, keys, n_out, starts,
          perm=torch.tensor(perm.astype(np.int32), device=dev),
          lib_keys=torch.tensor(unsorted.astype(np.int32), device=dev))
    # between the two: uniform keys at growing mean segment lengths
    O = 1 << 19
    for mean in (2, 8, 16, 32, 64, 128, 256):
        n_out = O // mean
        keys_np = np.sort(rng.integers(0, n_out, O))
        keys = torch.tensor(keys_np.astype(np.int32), device=dev)
        starts = torch.tensor(np.searchsorted(keys_np, np.arange(n_out + 1)).astype(np.int32),
                              device=dev)
        vals = torch.randn((9, O), generator=gen, device=dev)
        sweep(f"uniform (9,{O})->{n_out}", vals, keys, n_out, starts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
