#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's LM solve on one CUDA card.

    python3 scripts/torch_profile.py

1. Whole solves of the ladybug-1723 ring stand-in at its golden config
   (data/goldens/ladybug-1723.json, f32, λ₀ 1e-4), the two matrix-free tiers
   taking turns three times after one warm-up solve each: wall seconds up to
   the final cost's device→host read, LM it/s, cg_total, final cost and its
   gap to the golden.
2. Ten LM iterations of ``schur_pcg_pallas`` under
   torch.profiler. Device time is summed over the kernel and memcpy events
   only: an aten op's own "self CUDA" time repeats the time of the kernels it
   launched, so a sum over every row counts those kernels twice. Printed: the
   device total, its share of the profiled wall clock (busy) and the rest
   (idle), the top kernels, and the same time grouped by the aten op that
   launched it; kernels launched outside any aten op (the hand-written ones,
   called through ctypes) form their own group.
"""

import json
import os
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = "ladybug-1723"
REPEATS = 3
PROFILE_ITERS = 10


def main() -> int:
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.solver.lm import solve

    with open(os.path.join("data", "goldens", f"{PROBLEM}.json")) as fh:
        golden = json.load(fh)
    problem, _ = make_bal_like_problem(PROBLEM, dtype=torch.float32, device="cuda")

    def cfg(tier, iters=golden["max_iters"]):
        return LMConfig(max_iters=iters, cg_max_iters=golden["cg_max_iters"],
                        cg_tol=golden["cg_tol"], init_lambda=1e-4, linear_solver=tier)

    tiers = ("schur_pcg_pallas", "schur_pcg")
    for tier in tiers:
        solve(problem, cfg(tier)).cost.item()
    for rep in range(REPEATS):
        for tier in tiers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(problem, cfg(tier))
            cost = res.cost.item()
            s = time.perf_counter() - t0
            gap = (cost - golden["final_cost"]) / golden["final_cost"]
            print(f"[solve] {tier} repeat {rep}: {s} s, {int(res.iterations) / s} LM it/s, "
                  f"cg_total {int(res.cg_history.sum())}, accepted {int(res.accepted)}, "
                  f"cost {cost} (gap {100 * gap:+.5f}%)", flush=True)

    pcfg = cfg("schur_pcg_pallas", PROFILE_ITERS)
    solve(problem, pcfg).cost.item()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = solve(problem, pcfg)
        res.cost.item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    by_kernel = defaultdict(lambda: [0.0, 0])
    device_us = 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name][0] += e.device_time_total
            by_kernel[e.name][1] += 1
            device_us += e.device_time_total
    # self device time of a CPU-side op: its directly launched kernels
    by_op = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0:
            by_op[e.name][0] += e.self_device_time_total
            by_op[e.name][1] += 1
    outside = device_us - sum(v[0] for v in by_op.values())
    by_op["(launched outside any aten op)"] = [outside, 0]

    device_ms = device_us / 1e3
    print(f"[profile] schur_pcg_pallas, {int(res.iterations)} LM iterations, cg_total "
          f"{int(res.cg_history.sum())}: wall {wall_ms} ms, device {device_ms} ms "
          f"(kernel and memcpy events), busy {100 * device_ms / wall_ms}%, idle "
          f"{100 - 100 * device_ms / wall_ms}%", flush=True)
    for title, table in (("kernel", by_kernel), ("aten op", by_op)):
        print(f"[profile] device time by {title}:")
        for name, (us, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:20]:
            print(f"  {us / 1e3:9.3f} ms {100 * us / device_us:5.1f}%  x{n:6d}  {name[:100]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
