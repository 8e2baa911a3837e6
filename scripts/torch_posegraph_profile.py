#!/usr/bin/env python3
"""Where a pose-graph LM iteration of the PyTorch port spends its time, on a
CUDA card.

    python3 scripts/torch_posegraph_profile.py [--nodes 2000]

Builds ``chip_smoke.py``'s ring (the posegraph command line's ring, built in
one batch), solves it once to warm up, then prints:
  * LM it/s of three timed solves (host clock, ending in a device read);
  * one solve under torch.profiler: wall, device time (kernel and memcpy
    events), busy share, and device and host (self CPU) time by op;
  * the dense solve alone at the same size (a random SPD 12,000² f64 system
    at 2,000 nodes: an LU's work does not depend on the values), median of 5
    CUDA-event timings, under torch's default linear-algebra backend and
    cuSOLVER (``preferred_linalg_library``; the card's torch has no MAGMA),
    beside its operation count (2/3·n³) over the card's peak f64 rate.
Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_F64_FLOPS = 67e12      # H100 SXM, FP64 tensor core, NVIDIA's data sheet


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    import chip_smoke
    from tpu_ba_torch.posegraph import solve_pose_graph

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    init, ei, ej, meas = chip_smoke.pose_graph_ring(torch, args.nodes, dev)
    n6 = 6 * args.nodes

    def timed_solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, cost, it = solve_pose_graph(init, ei, ej, meas)
        cost.item()
        return it, time.perf_counter() - t0

    it, first = timed_solve()
    rates = [it / s for it, s in (timed_solve() for _ in range(3))]
    print(f"[pg] ring of {args.nodes} nodes: {it} LM iterations; first solve {first:.3f} s; "
          f"LM it/s of three more {[round(r, 3) for r in rates]}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        it, wall = timed_solve()
    dev_us = 0.0
    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us += e.device_time_total
            by_kernel[e.name] += e.device_time_total
    print(f"[pg] profiled solve: {it} iterations, wall {1e3 * wall:.3f} ms, device "
          f"{dev_us / 1e3:.3f} ms (kernel and memcpy events), busy "
          f"{100 * dev_us / 1e3 / (1e3 * wall):.2f}%", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[pg]   device {us / 1e3:10.3f} ms  {name[:110]}")
    ops = prof.key_averages()
    for row in sorted(ops, key=lambda r: -r.self_cpu_time_total)[:12]:
        print(f"[pg]   host self {row.self_cpu_time_total / 1e3:10.3f} ms, {row.count:6d} calls  "
              f"{row.key[:80]}")

    # the dense solve alone at the same size
    torch.manual_seed(0)
    A = torch.randn(n6, n6, dtype=torch.float64, device=dev) / n6 ** 0.5
    A = A @ A.T + torch.eye(n6, dtype=torch.float64, device=dev)
    b = torch.randn(n6, dtype=torch.float64, device=dev)
    flops = 2.0 / 3.0 * n6 ** 3
    for lib in ("default", "cusolver"):
        torch.backends.cuda.preferred_linalg_library(lib)
        times = []
        for _ in range(6):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            torch.linalg.solve(A, b)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        ms = statistics.median(times[1:])
        print(f"[pg] torch.linalg.solve {n6}x{n6} f64, backend {lib}: {ms:.3f} ms (median of 5 "
              f"after one); LU bound {1e3 * flops / PEAK_F64_FLOPS:.3f} ms at "
              f"{PEAK_F64_FLOPS / 1e12:.0f} TFLOP/s", flush=True)
    torch.backends.cuda.preferred_linalg_library("default")
    return 0


if __name__ == "__main__":
    sys.exit(main())
