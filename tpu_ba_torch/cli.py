"""Command line of the PyTorch port: bundle adjustment, SfM, pose graph.

Usage:
    python -m tpu_ba_torch.cli ba --problem ladybug-1723 --solver schur_sparse_pallas
    python -m tpu_ba_torch.cli ba --bal-file problem.txt --checkpoint ck --checkpoint-every 20
    python -m tpu_ba_torch.cli ba --resume ck --bal-file problem.txt --max-iters 80
    python -m tpu_ba_torch.cli ba --problem synthetic --max-iters 8 --device cpu
    python -m tpu_ba_torch.cli ba --sharded --coordinator 127.0.0.1:29500 \
        --num-processes 2 --process-id 0 --solver schur_sparse_pallas    (and id 1)
    python -m tpu_ba_torch.cli sfm --frames 8 --points 300 --out scene.txt
    python -m tpu_ba_torch.cli posegraph --nodes 50 --noise 0.03

Each prints one JSON line with its result (a sharded ``ba``: rank 0 alone)
and runs on the CUDA card unless ``--device`` names another; a sharded rank
takes the card ``cuda:{rank % device_count}``. ``ba --sharded`` runs one
process per rank; without ``--coordinator`` it is a group of one on this
process's device, where the reference's single process spans every local
device. The reference's ``bench`` subcommand (``tpu_ba/cli.py``, which runs
``bench.py``) is not ported.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (fails without one), "
                        "cpu to run on the CPU")


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
    _add_device(p)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32",
                   help="the problem's float type (the kernels take float32)")
    p.add_argument("--sharded", action="store_true",
                   help="observation-sharded solve, one process per rank (see --coordinator); "
                        "without a coordinator a group of one")
    p.add_argument("--coordinator", default=None,
                   help="host:port where rank 0 listens (COORDINATOR_ADDRESS)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks of the sharded solve (NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (PROCESS_ID)")
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


def _add_sfm(sub):
    p = sub.add_parser("sfm", help="incremental SfM on an image sequence")
    p.add_argument("--sequence", default=None,
                   help="TUM or KITTI sequence dir (synthetic render if omitted)")
    p.add_argument("--format", choices=["tum", "kitti"], default="tum")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--points", type=int, default=300)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--corners", type=int, default=512)
    p.add_argument("--out", default=None, help="write resulting scene as BAL file")
    _add_device(p)


def _add_posegraph(sub):
    p = sub.add_parser("posegraph", help="pose-graph refinement demo")
    p.add_argument("--nodes", type=int, default=50)
    p.add_argument("--noise", type=float, default=0.03)
    p.add_argument("--max-iters", type=int, default=30)
    _add_device(p)


def cmd_ba(args) -> int:
    from tpu_ba_torch.core import resolve_device

    mesh = None
    if args.sharded:
        from tpu_ba_torch.sharding import init_distributed, make_mesh

        init_distributed(args.coordinator, args.num_processes, args.process_id,
                         device=args.device)
        mesh = make_mesh(device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    try:
        return _ba(args, device, mesh)
    finally:
        if mesh is not None and mesh.pg is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _ba(args, device, mesh) -> int:
    import torch

    from tpu_ba_torch.bench.metrics import MetricsLogger
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import load_bal, make_bal_like_problem
    from tpu_ba_torch.io.synthetic import make_synthetic_problem
    from tpu_ba_torch.residuals.robust import ROBUST_KINDS
    from tpu_ba_torch.solver.lm import save_result, solve

    where = dict(device=device, dtype=getattr(torch, args.dtype))
    if args.scene:
        from tpu_ba_torch.io.scene import load_scene

        problem = load_scene(args.scene, **where)
        n_obs = problem.n_obs
    elif args.bal_file:
        problem = load_bal(args.bal_file, **where)
        n_obs = problem.n_obs
    elif args.problem == "synthetic":
        problem, gt = make_synthetic_problem(20, 500, **where)
        n_obs = gt["n_obs"]
    else:
        problem, gt = make_bal_like_problem(args.problem, **where)
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

    lead = mesh is None or mesh.rank == 0       # the rank that writes and prints
    log = MetricsLogger(args.metrics if lead else None)
    t0 = time.time()
    # --resume restores the whole trust-region state: resumed ≡ uninterrupted
    if mesh is not None:
        from tpu_ba_torch.sharding import solve_sharded

        res = solve_sharded(problem, cfg, mesh, resume_from=args.resume)
    else:
        res = solve(problem, cfg, resume_from=args.resume)
    final = float(res.cost)
    wall = time.time() - t0
    label = args.bal_file or args.problem
    shard_info = {}
    if mesh is not None:        # every rank takes part
        shard_info = {"ranks": mesh.world, "ranks_equal": _ranks_equal(res, mesh)}
    if not lead:
        return 0
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
        "device": str(problem.device), **shard_info,
        "iterations": int(res.iterations), "accepted": int(res.accepted),
        "initial_cost": float(res.initial_cost), "final_cost": final,
        "rmse_px": math.sqrt(2.0 * final / max(n_obs, 1)), "wall_s": wall,
        "converged": bool(res.converged),
    }))
    return 0


def _ranks_equal(res, mesh) -> bool:
    """Whether every rank of a sharded solve ended with the same bits: a
    digest of each rank's parameters and cost, gathered to all."""
    import hashlib

    import torch

    from tpu_ba_torch.solver.collective import all_gather_cols

    h = hashlib.blake2b(digest_size=8)
    for t in (res.cameras, res.points, res.cost):
        h.update(t.detach().cpu().numpy().tobytes())
    mine = torch.tensor([int.from_bytes(h.digest(), "little", signed=True)], dtype=torch.int64,
                        device=mesh.device)
    return bool((all_gather_cols(mine, mesh) == mine).all())


def cmd_sfm(args) -> int:
    import numpy as np

    from tpu_ba_torch.core import resolve_device
    from tpu_ba_torch.sfm.incremental import SfMConfig, run_incremental_sfm

    device = resolve_device(args.device)
    if args.sequence:
        if args.format == "tum":
            from tpu_ba_torch.io.sequences import read_tum_sequence

            frames, gt = read_tum_sequence(args.sequence, args.max_frames)
        else:
            from tpu_ba_torch.io.sequences import read_kitti_sequence

            frames, gt = read_kitti_sequence(args.sequence, args.max_frames)
        K = gt.get("K")
        if K is None:
            H, W = frames.shape[1:3]
            K = (0.9 * W, 0.9 * W, W / 2.0, H / 2.0)  # rough default intrinsics
    else:
        from tpu_ba_torch.io.sequences import render_blob_sequence

        frames, gt = render_blob_sequence(n_frames=args.frames, n_points=args.points,
                                          device=device)
        K = gt["K"]

    res = run_incremental_sfm(frames, K, SfMConfig(max_corners=args.corners), device=device)
    rmse = math.sqrt(2 * res.final_cost / max(res.report["n_obs"], 1))
    print(json.dumps({**res.report, "final_cost": res.final_cost, "rmse_px": rmse,
                      "device": str(device)}))

    if args.out:
        from tpu_ba_torch.core import make_problem
        from tpu_ba_torch.io.bal import save_bal
        from tpu_ba_torch.sfm.incremental import _to_bal_camera

        fx, fy, cx, cy = K
        reg = np.where(res.registered)[0]
        fmap = {f: i for i, f in enumerate(reg)}
        cams = np.stack([_to_bal_camera(res.poses[f, 0:3], res.poses[f, 3:6],
                                        0.5 * (fx + fy)) for f in reg])
        sel = np.isin(res.track_frame, reg)
        ci = np.asarray([fmap[f] for f in res.track_frame[sel]], np.int32)
        pi = res.track_point[sel].astype(np.int32)
        uv = res.track_xy[sel] - np.array([cx, cy])
        save_bal(args.out, make_problem(cams, res.points, uv, ci, pi, pad_multiple=1,
                                        device=device))
    return 0


def cmd_posegraph(args) -> int:
    import numpy as np
    import torch

    from tpu_ba_torch.core import resolve_device
    from tpu_ba_torch.geometry.se3 import se3_compose, se3_exp, se3_relative
    from tpu_ba_torch.posegraph import pose_graph_cost, solve_pose_graph

    device = resolve_device(args.device)
    t0 = time.time()
    rng = np.random.default_rng(0)
    n = args.nodes
    gt = np.zeros((n, 6))
    for i in range(n):
        ang = 2 * np.pi * i / n
        gt[i] = [0, ang, 0, np.cos(ang), 0, np.sin(ang)]
    gt_t = torch.as_tensor(gt, device=device)
    ei = np.r_[np.arange(1, n), 0].astype(np.int32)
    ej = np.r_[np.arange(0, n - 1), n - 1].astype(np.int32)
    meas = torch.stack([
        se3_compose(se3_exp(torch.as_tensor(args.noise * rng.standard_normal(6), device=device)),
                    se3_relative(gt_t[i], gt_t[j]))
        for i, j in zip(ei, ej)])
    init = gt + 0.1 * rng.standard_normal(gt.shape)
    init[0] = gt[0]
    init = torch.as_tensor(init, device=device)
    c0 = float(pose_graph_cost(init, ei, ej, meas))
    t1 = time.time()
    nodes, cost, iters = solve_pose_graph(init, ei, ej, meas, max_iters=args.max_iters)
    final = float(cost)
    # build_s: the ring and its measurements, edge by edge as the reference builds them
    print(json.dumps({"nodes": n, "initial_cost": c0, "final_cost": final,
                      "iterations": int(iters), "device": str(device),
                      "build_s": t1 - t0, "wall_s": time.time() - t1}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_ba_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_ba(sub)
    _add_sfm(sub)
    _add_posegraph(sub)
    args = ap.parse_args(argv)
    return {"ba": cmd_ba, "sfm": cmd_sfm, "posegraph": cmd_posegraph}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
