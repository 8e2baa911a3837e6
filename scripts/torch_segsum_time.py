#!/usr/bin/env python3
"""Time the K1 segment sums of ladybug-1723 as the solver calls them, for
one tree of the port, on one CUDA card.

    python3 scripts/torch_segsum_time.py [--root DIR]

``--root`` is the directory that holds the ``tpu_ba_torch`` package to time
(default: this checkout). To compare two commits, unpack the other with
``git archive`` and run this script once for each root on the same card, e.g.
other, this, this, other: the calls go through ``cam_segsum_t``,
``pt_segsum_t`` and ``sorted_segment_sum_t(values, keys, n_out, starts)``,
which every tree of the port has, whatever its kernel does inside (a tree
without the fused gather makes an ``index`` copy inside ``pt_segsum_t``, and
that is timed with it).

Three clocks per call, in ms: ``cold``, 20 calls replayed from a CUDA graph
over copies of the values that rotate through more than twice the L2's size,
so that each call reads its values from device memory, as in a solve;
``l2``, the same on one copy, which the replays find in L2 where it fits;
``eager``, one call launched from Python between two CUDA events, which at
these sizes is the host's pace. Beside each, ``scatter_add_`` into a cleared
output on the same clock. Prints the card's name and power limit first.
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


def copies(vals, launches=20):
    """``vals`` and clones of it, more than twice the L2's size in all."""
    n = min(launches, max(1, -(-2 * L2_BYTES // (vals.numel() * 4)) + 1))
    return [vals] + [vals.clone() for _ in range(n - 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_segsum_time: needs a CUDA card", file=sys.stderr)
        return 1
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t
    from tpu_ba_torch.solver.plans import build_plans, cam_segsum_t, pt_segsum_t

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"root {root}; ms per call: K1 cold / l2 / eager | scatter_add_ cold / l2", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    problem, _ = make_bal_like_problem("ladybug-1723", dtype=torch.float32, device=dev)
    C, P, O = problem.n_cameras, problem.n_points, problem.obs_2d.shape[0]
    plans = build_plans(problem.cam_idx, problem.pt_idx, C, P)
    cam, pt = problem.cam_idx, problem.pt_idx
    cases = [
        ("(3,O)->P sorted keys", 3, P, plans.pt_sorted_keys,
         lambda v: sorted_segment_sum_t(v, plans.pt_sorted_keys, P, plans.pt_start)),
        ("(12,O)->P sorted keys", 12, P, plans.pt_sorted_keys,
         lambda v: sorted_segment_sum_t(v, plans.pt_sorted_keys, P, plans.pt_start)),
        ("(3,O)->P pt_segsum_t", 3, P, pt, lambda v: pt_segsum_t(plans, v, pt, P)),
        ("(12,O)->P pt_segsum_t", 12, P, pt, lambda v: pt_segsum_t(plans, v, pt, P)),
        ("(9,O)->C cam_segsum_t", 9, C, cam, lambda v: cam_segsum_t(plans, v, cam, C)),
        ("(81,O)->C cam_segsum_t", 81, C, cam, lambda v: cam_segsum_t(plans, v, cam, C)),
    ]
    for name, D, n_out, lib_keys, call in cases:
        vals = torch.randn((D, O), generator=gen, device=dev)
        sets = copies(vals)
        lib_out = torch.empty((D, n_out), device=dev)
        lib_idx = lib_keys.long().expand(D, O)

        def lib(v):
            return lib_out.zero_().scatter_add_(1, lib_idx, v)

        ref = lib(vals).double()
        rel = ((call(vals).double() - ref).abs().max() / ref.abs().max()).item()
        if not rel <= 1e-5:
            raise AssertionError(f"{name}: {rel} from scatter_add_")
        cold = replay_ms(torch, [lambda v=v: call(v) for v in sets])
        warm = replay_ms(torch, [lambda: call(vals)])
        eager = event_ms(torch, lambda: call(vals), reps=20, warmup=3)
        lcold = replay_ms(torch, [lambda v=v: lib(v) for v in sets])
        lwarm = replay_ms(torch, [lambda: lib(vals)])
        print(f"{name:24s} {len(sets):2d} copies | {cold:.4f} / {warm:.4f} / {eager:.4f} | "
              f"{lcold:.4f} / {lwarm:.4f}", flush=True)
        del sets, lib_out, lib_idx, vals
    return 0


if __name__ == "__main__":
    sys.exit(main())
