"""Command line: bundle-adjust a BAL problem with the PyTorch port.

Usage:
    python -m tpu_ba_torch.cli ba --problem ladybug-1723 --solver schur_sparse_pallas
    python -m tpu_ba_torch.cli ba --bal-file problem.txt --checkpoint ck --checkpoint-every 20
    python -m tpu_ba_torch.cli ba --resume ck --bal-file problem.txt --max-iters 80
    python -m tpu_ba_torch.cli ba --problem synthetic --max-iters 8 --device cpu

Prints one JSON line with the result. Only the ``ba`` subcommand is ported;
the reference's other subcommands (``tpu_ba/cli.py``) and its sharded run
follow in later work.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _add_ba(sub):
    p = sub.add_parser("ba", help="bundle-adjust a BAL problem")
    p.add_argument("--problem", default="ladybug-49",
                   help="BAL stand-in name (tpu_ba_torch.io.bal.BAL_DATASET_DIMS) "
                        "or 'synthetic'")
    p.add_argument("--bal-file", default=None, help="path to a BAL file (.txt or .txt.gz)")
    p.add_argument("--scene", default=None,
                   help="load the problem from a scene file (.npz/.mat)")
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
    p.add_argument("--metrics", default=None, help="JSONL metrics output path")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir to write at the end of the solve")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="with --checkpoint, also dump the state every N LM iterations "
                        "(0 = at the end only)")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument("--config", default=None, help="JSON file of LMConfig overrides")
    p.add_argument("--save-scene", default=None, help="save the optimized scene (.npz/.mat)")
    p.add_argument("--plot-scene", default=None,
                   help="write a 3-D scene plot (PNG) after solving")
    p.add_argument("--plot-convergence", default=None,
                   help="write cost/lambda/CG-history plot (PNG)")
    p.add_argument("--plot-reproj", default=None,
                   help="write a reprojection overlay for camera 0 (PNG)")


def cmd_ba(args) -> int:
    from tpu_ba_torch.bench.metrics import MetricsLogger
    from tpu_ba_torch.core import LMConfig, resolve_device
    from tpu_ba_torch.io.bal import load_bal, make_bal_like_problem
    from tpu_ba_torch.io.synthetic import make_synthetic_problem
    from tpu_ba_torch.residuals.robust import ROBUST_KINDS
    from tpu_ba_torch.solver.lm import save_result, solve

    device = resolve_device(args.device)
    if args.scene:
        from tpu_ba_torch.io.scene import load_scene

        problem = load_scene(args.scene, device=device)
        n_obs = problem.n_obs
    elif args.bal_file:
        problem = load_bal(args.bal_file, device=device)
        n_obs = problem.n_obs
    elif args.problem == "synthetic":
        problem, gt = make_synthetic_problem(20, 500, device=device)
        n_obs = gt["n_obs"]
    else:
        problem, gt = make_bal_like_problem(args.problem, device=device)
        n_obs = gt["n_obs"]

    kwargs = dict(max_iters=args.max_iters, cg_max_iters=args.cg_iters, cg_tol=args.cg_tol,
                  robust_kind=ROBUST_KINDS[args.robust], robust_scale=args.robust_scale,
                  linear_solver=args.solver, precond=args.precond)
    if args.checkpoint and args.checkpoint_every:
        kwargs.update(checkpoint_every=args.checkpoint_every, checkpoint_path=args.checkpoint)
    if args.config:
        with open(args.config) as fh:
            kwargs.update(json.load(fh))  # JSON wins over flags
    cfg = LMConfig(**kwargs)

    log = MetricsLogger(args.metrics)
    t0 = time.time()
    # --resume restores the whole trust-region state: resumed ≡ uninterrupted
    res = solve(problem, cfg, resume_from=args.resume)
    final = float(res.cost)
    wall = time.time() - t0
    label = args.bal_file or args.problem
    log.log_lm_result(res, wall_s=wall, label=label)
    log.close()

    if args.checkpoint:
        # with ν, the warm-start step and g₀, as the chunk dumps: a --resume
        # from it continues this trajectory
        save_result(args.checkpoint, res)
    if args.save_scene:
        from tpu_ba_torch.io.scene import save_scene

        save_scene(args.save_scene, problem.with_params(res.cameras, res.points))
    if args.plot_scene:
        from tpu_ba_torch.viz import plot_scene

        plot_scene(res.cameras, res.points, args.plot_scene, title=label)
    if args.plot_convergence:
        from tpu_ba_torch.viz import plot_convergence

        plot_convergence(res, args.plot_convergence)
    if args.plot_reproj:
        from tpu_ba_torch.viz import plot_reprojection

        plot_reprojection(problem, res.cameras, res.points, args.plot_reproj)

    print(json.dumps({
        "problem": label, "solver": cfg.linear_solver, "precond": cfg.precond,
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
