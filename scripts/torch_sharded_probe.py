#!/usr/bin/env python3
"""The sharded solve of the port against one device, on one H100.

    python3 scripts/torch_sharded_probe.py

ladybug-1723 through ``schur_sparse_pallas``: 8 LM iterations (CG 100 at
1e-4) at λ₀ = 1e-4, 1e-2, 1 and 10 on one device, on two gloo ranks sharing
the card and on a 1-rank NCCL group, each compared with the one-device
solve (cost, cameras within rtol 1e-2 / atol 1e-3, CG history); then the
golden config (80 iterations) on two ranks twice, against
``data/goldens/ladybug-1723.json``, with its time, collectives and launches.
It shows at which damping two summation orders keep one trajectory in f32.
Then ladybug-49 at λ₀ = 10 (8 iterations, f32): two gloo ranks on the card
and on the CPU (the kernels' plain versions), one device on the card and on
the CPU, each against the f64 ``schur_sparse`` solve on the CPU (the bounds
of ``tests/test_torch_cuda.py:test_sharded_solve_on_the_card_matches_the_cpu``
are read off it). Prints the card's name and power limit first.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import numpy as np
    import torch

    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.sharding.launch import problem_arrays, run_ranks, solve_jobs
    from tpu_ba_torch.solver.lm import solve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    p, _ = make_bal_like_problem("ladybug-1723", dtype=torch.float32, device=dev)
    with open(os.path.join(HERE, "data", "goldens", "ladybug-1723.json")) as fh:
        gold = json.load(fh)
    lams = (1e-4, 1e-2, 1.0, 10.0)
    short = [dict(linear_solver="schur_sparse_pallas", max_iters=8, cg_max_iters=100,
                  cg_tol=1e-4, init_lambda=lam) for lam in lams]
    gcfg = dict(linear_solver="schur_sparse_pallas", max_iters=gold["max_iters"],
                cg_max_iters=gold["cg_max_iters"], cg_tol=gold["cg_tol"], init_lambda=1e-4)
    singles = [solve(p, LMConfig(**c)) for c in short]
    for i in range(2):
        t0 = time.perf_counter()
        g1 = solve(p, LMConfig(**gcfg))
        torch.cuda.synchronize()
        print(f"one device, golden config: {time.perf_counter() - t0:.3f} s, cost "
              f"{g1.cost.item()}, {int(g1.iterations)} iterations", flush=True)
    arrays = problem_arrays(p)
    jobs = [dict(problem=arrays, config=c) for c in short] + [dict(problem=arrays, config=gcfg)] * 2
    two = run_ranks(2, solve_jobs, (jobs,), backend="gloo")
    one = run_ranks(1, solve_jobs, (jobs[:len(lams)],), backend="nccl")
    for i, lam in enumerate(lams):
        s_cost, s_cams = singles[i].cost.item(), singles[i].cameras.cpu().numpy()
        for name, r in (("2 ranks gloo", two[0][i]), ("1 rank nccl", one[0][i])):
            d = np.abs(r["cameras"] - s_cams)
            ok = bool(np.all(d <= 1e-3 + 1e-2 * np.abs(s_cams)))
            print(f"8 iterations at lam0 {lam:g}, {name}: cost {float(r['cost'])} against one "
                  f"device's {s_cost}, rel {(float(r['cost']) - s_cost) / s_cost:+.3e}; cameras "
                  f"within rtol 1e-2 / atol 1e-3: {ok}, max abs {d.max():.3e}; CG "
                  f"{r['cg_history'].tolist()} (one device {singles[i].cg_history.tolist()})",
                  flush=True)
    for j in (len(lams), len(lams) + 1):
        a, b = two[0][j], two[1][j]
        same = all(np.array_equal(a[k], b[k]) for k in ("cameras", "points", "cost", "cg_history"))
        print(f"2 ranks, golden config: cost {float(a['cost'])}, gap "
              f"{100 * (float(a['cost']) - gold['final_cost']) / gold['final_cost']:+.5f}%, "
              f"{int(a['iterations'])} iterations, cg_total {int(a['cg_history'].sum())}, "
              f"{a['seconds']:.3f} s, ranks equal {same}; collectives {a['collectives']}; "
              f"launches {a['launches']}", flush=True)

    cfg = dict(linear_solver="schur_sparse_pallas", max_iters=8, cg_max_iters=100, cg_tol=1e-4,
               init_lambda=10.0)
    p49, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32, device="cpu")
    jobs = [dict(problem=problem_arrays(p49), config=cfg)]
    costs = {
        "2 ranks, card": float(run_ranks(2, solve_jobs, (jobs,), backend="gloo")[0][0]["cost"]),
        "2 ranks, CPU": float(run_ranks(2, solve_jobs, (jobs,), device="cpu",
                                        threads=1)[0][0]["cost"]),
        "one device, card": solve(make_bal_like_problem("ladybug-49", dtype=torch.float32,
                                                        device=dev)[0], LMConfig(**cfg)).cost.item(),
        "one device, CPU": solve(p49, LMConfig(**cfg)).cost.item()}
    ref = solve(make_bal_like_problem("ladybug-49", dtype=torch.float64, device="cpu")[0],
                LMConfig(**dict(cfg, linear_solver="schur_sparse"))).cost.item()
    for name, c in costs.items():
        print(f"ladybug-49, {name}: cost {c!r}, rel to f64 {(c - ref) / ref:+.3e}", flush=True)
    for a, b in (("2 ranks, card", "one device, card"), ("2 ranks, card", "2 ranks, CPU")):
        print(f"ladybug-49, {a} against {b}: rel {(costs[a] - costs[b]) / costs[b]:+.3e}",
              flush=True)


if __name__ == "__main__":
    main()
