"""Benchmark harness of the port: times one LM solve and prints one JSON line.

Counterpart of the reference's ``bench.py``, with its flags and defaults:

    python -m tpu_ba_torch.bench.harness                  # ladybug-1723 on the CUDA card
    python -m tpu_ba_torch.bench.harness --problem trafalgar-257 --robust huber --max-iters 60
    python -m tpu_ba_torch.bench.harness --quick --device cpu

The headline is LM iterations per second of the ladybug-1723 ring stand-in
through ``schur_sparse_pallas`` (block-Jacobi, CG 100 at 1e-4, 80 LM
iterations, f32): the kernels are built and loaded before any clock starts,
a first call (plans and one solve) is timed apart, then the best of three
solves, each ending in a synchronize and a host read of the cost.
``vs_baseline`` is that rate times the seconds an iteration of the CPU
baseline takes (``tpu_ba_torch/bench/cpu_baseline.py``: scipy Schur and a
dense Cholesky, f64), at the bench problem's own scale unless
``--baseline-problem`` names another.

The detail (``--detail-out``) holds the reference's keys: first-call and
steady-state split, time to 1% of the final cost, f64 parity against
``data/goldens/<problem>.json``, device memory, the solve's roofline share
(``tpu_ba_torch/bench/roofline.py``) and the baseline; and the port's:
``power_limit_w``, ``build_s``, ``launches`` per kernel, the PCG kernel's
forms (``pcg_forms``: resident or streaming) and ``host_reads`` over one
timed solve. It is written before the baseline runs and again
after, so a baseline that crashes leaves the device's numbers on disk.

The harness runs on the CUDA card unless ``--device`` names another; without
a card it raises. A run on the CPU reports under a metric ending in
``_cpu``, never under the card's.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
GOLDENS = REPO_ROOT / "data" / "goldens"
TIMED_RUNS = 3
TIME_TO_1PCT_METHOD = ("uniform: reach / lm_iters of run_s (the reference's method where it has "
                       "no phase profile)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="tpu_ba_torch.bench.harness", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--problem", default="ladybug-1723", help="BAL stand-in name or 'synthetic'")
    ap.add_argument("--covis", default="ring", choices=("ring", "community"),
                    help="stand-in covisibility structure ('community': an unordered "
                         "photo-collection graph)")
    ap.add_argument("--max-iters", type=int, default=80)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--cg-tol", type=float, default=1e-4)
    ap.add_argument("--cg-forcing", type=float, default=0.0,
                    help=">0 enables the Eisenstat-Walker forcing sequence")
    ap.add_argument("--baseline-iters", type=int, default=2)
    ap.add_argument("--baseline-problem", default=None,
                    help="problem for the CPU denominator (default: the bench problem itself)")
    ap.add_argument("--quick", action="store_true",
                    help="ladybug-49 and 20 LM iterations")
    ap.add_argument("--robust", default="none", choices=["none", "huber", "cauchy", "arctan"])
    ap.add_argument("--robust-scale", type=float, default=1.0)
    ap.add_argument("--precond", default="jacobi", choices=["jacobi", "tridiag"],
                    help="PCG preconditioner (tridiag: the PCR block-tridiagonal inverse)")
    ap.add_argument("--solver", default="schur_sparse_pallas",
                    help="linear solver: schur_sparse_pallas (the main path) | schur_sparse | "
                         "schur_dense | schur_pcg[_pallas]")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (fails without one), cpu to run "
                         "on the CPU")
    ap.add_argument("--detail-out", default="bench_detail_torch.json",
                    help="where the detail JSON is written")
    args = ap.parse_args(argv)
    if args.quick:
        args.problem = "ladybug-49"
        args.max_iters = 20
    return args


def build_config(args):
    """The solve's ``LMConfig``, built from the flags as ``bench.py`` builds
    the reference's."""
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.residuals.robust import ROBUST_KINDS

    return LMConfig(max_iters=args.max_iters, linear_solver=args.solver,
                    cg_max_iters=args.cg_iters, cg_tol=args.cg_tol,
                    cg_forcing=args.cg_forcing, robust_kind=ROBUST_KINDS[args.robust],
                    robust_scale=args.robust_scale, init_lambda=1e-4, precond=args.precond)


def final_rmse_px(final_cost: float, n_obs: int) -> float:
    return math.sqrt(2.0 * final_cost / n_obs)


def reach_index(cost_history, final_cost: float) -> int:
    """1 + the first iteration whose cost is within 1% of the final cost
    (``np.argmax`` of a history that never gets there gives 1, as in the
    reference)."""
    hist = np.asarray(cost_history, np.float64)
    return int(np.argmax(hist <= final_cost * 1.01)) + 1


def time_to_1pct(reach: int, iters: int, run_s: float, first_call_s: float) -> dict:
    """Seconds to 1% of the final cost, in a timed solve and counting the
    first call, with the iterations' time split uniformly."""
    frac = reach / max(iters, 1)
    return {"time_to_1pct_run_s": frac * run_s,
            "time_to_1pct_incl_first_call_s": first_call_s - run_s * (1 - frac)}


def load_golden(name: str) -> dict | None:
    """The f64 golden of ``name`` under the repository's ``data/goldens``,
    or None."""
    path = GOLDENS / f"{name}.json"
    if not path.exists():
        return None
    with open(path) as fh:
        return json.load(fh)


def f64_parity(golden: dict | None, final_cost: float, rmse: float) -> dict | None:
    """The final cost and RMSE against the f64 golden, as gaps in percent."""
    if golden is None:
        return None
    return {
        "golden_final_cost_f64": golden["final_cost"],
        "golden_config": {k: golden[k] for k in ("max_iters", "cg_max_iters", "cg_tol",
                                                 "robust", "robust_scale") if k in golden},
        "final_cost_gap_pct": (final_cost - golden["final_cost"]) / golden["final_cost"] * 100,
        "rmse_f64_px": golden["final_rmse_px"],
        "rmse_gap_pct": (rmse - golden["final_rmse_px"]) / golden["final_rmse_px"] * 100,
    }


def _power_limit():
    """(nvidia-smi's ``name, power.limit`` line, the limit in watts)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[0]
    return line, float(line.rsplit(",", 1)[1].strip().split()[0])


def _device_memory(torch, device) -> dict:
    free, total = torch.cuda.mem_get_info(device)
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "max_memory_reserved": torch.cuda.max_memory_reserved(device),
            "mem_get_info_free": free, "mem_get_info_total": total,
            "source": "torch.cuda.max_memory_allocated / max_memory_reserved over the timed "
                      "solves (reset_peak_memory_stats before them); mem_get_info after them"}


def _write(path, detail) -> None:
    with open(path, "w") as fh:
        json.dump(detail, fh, indent=1)


def main(argv=None) -> int:
    import torch

    from tpu_ba_torch.bench.cpu_baseline import solve_cpu_baseline
    from tpu_ba_torch.bench.roofline import solve_roofline
    from tpu_ba_torch.core import resolve_device
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.io.synthetic import make_synthetic_problem
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.kernels import pcg_band as pcg_band_mod
    from tpu_ba_torch.solver import pcg as pcg_mod
    from tpu_ba_torch.solver.lm import solve

    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    build_s = smi = power_w = None
    if on_card:
        smi, power_w = _power_limit()
        t0 = time.perf_counter()
        _lib.build_library()
        _lib.load_library()
        build_s = time.perf_counter() - t0

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    if args.problem == "synthetic":
        problem, gt = make_synthetic_problem(20, 500, dtype=torch.float32, device=device)
    else:
        problem, gt = make_bal_like_problem(args.problem, dtype=torch.float32, device=device,
                                            covis=args.covis)
        if args.covis != "ring":
            args.problem = f"{args.problem}-{args.covis}"
    n_obs = gt.get("n_obs", problem.n_obs)
    sync()
    gen_s = time.perf_counter() - t0
    cfg = build_config(args)

    # first call: the plans and one solve, ending in a host read
    t0 = time.perf_counter()
    res = solve(problem, cfg)
    float(res.cost)
    first_call_s = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    run_s = math.inf
    for _ in range(TIMED_RUNS):
        _lib.reset_launches()
        pcg_band_mod.reset_form_launches()
        pcg_mod.reset_host_reads()
        sync()
        t0 = time.perf_counter()
        res = solve(problem, cfg)
        sync()
        float(res.cost)
        run_s = min(run_s, time.perf_counter() - t0)
    launches, bytes_moved = dict(_lib.launches), dict(_lib.bytes_moved)
    pcg_forms = dict(pcg_band_mod.form_launches)
    host_reads = dict(pcg_mod.host_reads)
    mem = (_device_memory(torch, device) if on_card
           else {"unavailable": "a CPU run: no device memory"})

    iters, accepted = int(res.iterations), int(res.accepted)
    iters_per_sec = iters / max(run_s, 1e-9)
    final_cost = float(res.cost)
    hist = res.cost_history.double().cpu().numpy()
    cg_total = int(res.cg_history.sum())
    rmse = final_rmse_px(final_cost, n_obs)
    reach = reach_index(hist, final_cost)

    roofline = solve_roofline(bytes_moved, iters, run_s, power_w) if on_card else None

    detail = {
        "problem": args.problem,
        "solver": args.solver,
        "n_cameras": problem.n_cameras,
        "n_points": problem.n_points,
        "n_obs": n_obs,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "nvidia_smi": smi,
        "power_limit_w": power_w,
        "dtype": "float32",
        "build_s": build_s,
        "gen_s": gen_s,
        "first_call_s": first_call_s,
        "run_s": run_s,
        "lm_iters": iters,
        "lm_accepted": accepted,
        "iters_per_sec": iters_per_sec,
        "accepted_per_sec": accepted / max(run_s, 1e-9),
        "cg_total": cg_total,
        "initial_cost": float(res.initial_cost),
        "final_cost": final_cost,
        "final_rmse_px": rmse,
        **time_to_1pct(reach, iters, run_s, first_call_s),
        "time_to_1pct_method": TIME_TO_1PCT_METHOD,
        "f64_parity": f64_parity(load_golden(args.problem), final_cost, rmse),
        "device_memory": mem,
        "roofline": roofline,
        "launches": launches,
        "pcg_forms": pcg_forms,
        "host_reads": host_reads,
        "cost_history": hist.tolist(),
        "baseline": None,
        "vs_baseline_speedup": None,
    }
    _write(args.detail_out, detail)

    # the CPU baseline, directly at the bench problem's scale by default
    if args.baseline_problem in (None, args.problem):
        bl_problem, bl_scale, bl_name = problem, 1.0, args.problem
    else:
        bl_problem, bl_gt = make_bal_like_problem(args.baseline_problem, dtype=torch.float32,
                                                  device="cpu")
        bl_scale = n_obs / bl_gt["n_obs"]
        bl_name = args.baseline_problem
    bl = solve_cpu_baseline(bl_problem, max_iters=args.baseline_iters, time_budget_s=300.0)
    bl_sec_per_iter = bl["sec_per_iter"] * bl_scale
    vs_baseline = iters_per_sec * bl_sec_per_iter
    detail["baseline"] = {
        "problem": bl_name,
        "method": "scipy Schur + dense Cholesky in f64 on the host (the MATLAB-class stand-in, "
                  "tpu_ba_torch/bench/cpu_baseline.py)",
        "iters_run": bl["iters"],
        "sec_per_iter": bl["sec_per_iter"],
        "sec_per_iter_at_bench_scale": bl_sec_per_iter,
        "obs_scale_factor": bl_scale,
        "final_cost": bl["final_cost"],
    }
    detail["vs_baseline_speedup"] = vs_baseline
    _write(args.detail_out, detail)

    where = "1gpu" if on_card else device.type
    print(json.dumps({
        "metric": f"ba_iters_per_sec_{args.problem.replace('-', '_')}_{where}",
        "value": iters_per_sec,
        "unit": "LM iters/s",
        "vs_baseline": vs_baseline,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
