"""Command line: bundle-adjust a BAL stand-in problem with the PyTorch port.

Usage:
    python -m tpu_ba_torch.cli ba --problem ladybug-1723 --solver schur_sparse_pallas
    python -m tpu_ba_torch.cli ba --problem synthetic --max-iters 8 --device cpu

Prints one JSON line with the result. Only the ``ba`` subcommand is ported;
the reference's other subcommands (``tpu_ba/cli.py``) follow in later work.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _add_ba(sub):
    p = sub.add_parser("ba", help="bundle-adjust a BAL stand-in problem")
    p.add_argument("--problem", default="ladybug-49",
                   help="BAL stand-in name (tpu_ba_torch.io.bal.BAL_DATASET_DIMS) "
                        "or 'synthetic'")
    p.add_argument("--max-iters", type=int, default=50)
    p.add_argument("--cg-iters", type=int, default=50)
    p.add_argument("--cg-tol", type=float, default=1e-2)
    p.add_argument("--solver", default="schur_pcg",
                   choices=["dense", "schur_pcg", "schur_pcg_pallas", "schur_dense",
                            "schur_dense_pallas", "schur_sparse", "schur_sparse_pallas"],
                   help="linear solver tier (*_pallas: hand-written kernels)")
    p.add_argument("--precond", choices=["jacobi", "tridiag"], default="jacobi",
                   help="PCG preconditioner of the sparse tiers: block-Jacobi, or the "
                        "PCR-factored block-tridiagonal inverse (banded plans)")
    p.add_argument("--robust", choices=["none", "huber", "cauchy", "arctan"], default="none")
    p.add_argument("--robust-scale", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (fails without one), "
                        "cpu to run on the CPU")
    p.add_argument("--config", default=None, help="JSON file of LMConfig overrides")


def cmd_ba(args) -> int:
    from tpu_ba_torch.core import LMConfig, resolve_device
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.io.synthetic import make_synthetic_problem
    from tpu_ba_torch.residuals.robust import ROBUST_KINDS
    from tpu_ba_torch.solver.lm import solve

    device = resolve_device(args.device)
    if args.problem == "synthetic":
        problem, gt = make_synthetic_problem(20, 500, device=device)
    else:
        problem, gt = make_bal_like_problem(args.problem, device=device)
    n_obs = gt["n_obs"]

    kwargs = dict(max_iters=args.max_iters, cg_max_iters=args.cg_iters, cg_tol=args.cg_tol,
                  robust_kind=ROBUST_KINDS[args.robust], robust_scale=args.robust_scale,
                  linear_solver=args.solver, precond=args.precond)
    if args.config:
        with open(args.config) as fh:
            kwargs.update(json.load(fh))  # JSON wins over flags
    cfg = LMConfig(**kwargs)

    t0 = time.time()
    res = solve(problem, cfg)
    final = float(res.cost)
    wall = time.time() - t0
    print(json.dumps({
        "problem": args.problem, "solver": cfg.linear_solver, "precond": cfg.precond,
        "device": str(problem.device),
        "iterations": int(res.iterations), "accepted": int(res.accepted),
        "initial_cost": float(res.initial_cost), "final_cost": final,
        "rmse_px": math.sqrt(2.0 * final / max(n_obs, 1)), "wall_s": wall,
        "converged": bool(res.converged),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_ba_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_ba(sub)
    args = ap.parse_args(argv)
    return {"ba": cmd_ba}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
