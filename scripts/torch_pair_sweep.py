#!/usr/bin/env python3
"""What sets the time of K7 (the pair blocks), for one tree of the port, on
one CUDA card.

    python3 scripts/torch_pair_sweep.py [--root DIR] [--venice] [--lam 1e-4]

On ladybug-1723's pair plan (and with ``--venice`` on venice-1778-community's,
non-banded, 15.8 M pairs), K7 over:
  - the plan's segments;
  - the same pairs with only the longest segment non-empty;
  - every segment longer than T pairs emptied: its pairs taken out of
    ``packed``, which is padded back to its width with zero columns past the
    last segment, so that a tree whose lanes follow the mean segment length
    keeps its lanes;
and, for a tree with K7's schedule (``kernels/pairblocks.py:pair_schedule``),
the plan's segments under a few (pairs a thread, piece length) pairs other
than the tree's own. A tree without the schedule (K7 before it was
split by pairs) is called with the CSR starts, so ``--root`` takes any
checkout of the port (unpack another commit with ``git archive``). Times in
ms a call: ladybug-1723 as 20 calls replayed from a CUDA graph, ``cold`` over
copies of ``packed`` rotating through twice the L2 (read from device memory,
as in a solve) and ``l2`` on one copy; venice-1778-community as the median of
5 calls between CUDA events (its 4 GB of ``packed`` come from device memory
on every call). Prints the card's name and power limit first. The problems
are generated into ``data/cache/`` under the working directory on the first
run (venice-1778-community: ~50 s) and read from there after.
"""

import argparse
import os
import subprocess
import sys

from torch_band_time import event_ms, n_copies, replay_ms, system

TAILS = {"ladybug-1723": (256, 64, 32), "venice-1778-community": (4096, 1024, 256, 64)}
SCHEDULES = ((4, 256), (6, 384), (8, 512), (8, 1024), (16, 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--venice", action="store_true",
                    help="also sweep venice-1778-community's pair plan")
    ap.add_argument("--lam", type=float, default=1e-4)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_pair_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
    from tpu_ba_torch.kernels import pairblocks as pb
    from tpu_ba_torch.solver import pairs as pairs_mod
    from tpu_ba_torch.solver.lm import build_solver_plans
    from tpu_ba_torch.solver.normal import assemble

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    kw = dict(dc=9, diag_floor=LMConfig().diag_floor, diag_ceil=LMConfig().diag_ceil)
    lam = torch.tensor(args.lam, device=dev)
    scheduled = hasattr(pb, "pair_schedule")
    print(f"root {root}; lam {args.lam:g}; K7 "
          f"{'over its pair schedule' if scheduled else 'over CSR starts'}", flush=True)

    def plans(name):
        if name == "ladybug-1723":
            p, _ = make_bal_like_problem(name, dtype=torch.float32, device=dev)
            plan = pairs_mod.build_pair_plan(p.cam_idx, p.pt_idx, p.n_obs, p.n_cameras,
                                             p.n_points, with_kernel_plans=True, symmetric=True)
        else:
            p, _ = make_bal_like_problem("venice-1778", covis="community", dtype=torch.float32,
                                         device=dev)
            _, plan = build_solver_plans(p, LMConfig(linear_solver="schur_sparse_pallas"))
        return plan, pairs_mod.precompute_pair_data(system(p, jacobian_blocks_bal, assemble),
                                                    plan).packed

    def timed(name, what, packed, plan, starts, sched_kw=None):
        if scheduled:
            arg = pb.pair_schedule(starts, device=dev, **(sched_kw or {}))
            shape = (f"G {1 << arg.group_log2}, cut {arg.cut}, {arg.items.shape[1]} items, "
                     f"{arg.pieces.shape[1]} pieces, {arg.fold_seg.shape[0]} split")
        else:
            arg = torch.as_tensor(starts.astype(np.int32), device=dev)
            shape = "CSR starts"

        def call(pk):
            return pb.fused_pair_blocks(pk, plan.pair_seg, lam, plan.k_pad, arg, **kw)

        if name == "ladybug-1723":
            sets = [packed] + [packed.clone()
                               for _ in range(n_copies(packed.numel() * 4) - 1)]
            t = (f"{replay_ms(torch, [lambda s=s: call(s) for s in sets]):.4f} / "
                 f"{replay_ms(torch, [lambda: call(packed)]):.4f}")
            del sets
        else:
            t = f"{event_ms(torch, lambda: call(packed), reps=5):.4f}"
        print(f"{name:22s} {what:40s} | {t} | {shape}", flush=True)

    names = ["ladybug-1723"] + (["venice-1778-community"] if args.venice else [])
    for name in names:
        plan, packed = plans(name)
        starts = plan.seg_start.cpu().numpy().astype(np.int64)
        lens = np.diff(starts)
        ne = lens[lens > 0]
        print(f"{name}: {int(starts[-1])} real pairs into {lens.size} segments, "
              f"{lens.size - ne.size} empty; non-empty median {np.median(ne):.0f}, p99 {np.percentile(ne, 99):.0f}, "
              f"longest {ne.max()}; ms a call: "
              f"{'cold / l2 (graph)' if name == 'ladybug-1723' else 'eager'}", flush=True)
        timed(name, "the plan's segments", packed, plan, starts)
        big = int(np.argmax(lens))
        only = np.where(np.arange(lens.size + 1) <= big, starts[big], starts[big + 1])
        timed(name, f"only the longest ({lens[big]} pairs)", packed, plan, only)
        for T in TAILS[name]:
            keep = np.repeat(lens <= T, lens)
            kept = torch.zeros_like(packed)
            idx = torch.as_tensor(np.flatnonzero(keep), device=dev)
            kept[:, :idx.numel()] = packed[:, idx]
            del idx
            cut = np.concatenate([[0], np.cumsum(np.where(lens <= T, lens, 0))])
            timed(name, f"segments > {T} emptied ({int(keep.sum())} pairs)", kept, plan, cut)
            del kept
            torch.cuda.empty_cache()
        if scheduled:
            for iters, piece in SCHEDULES:
                if (iters, piece) == (pb.SHORT_ITERS, pb.PIECE_PAIRS):
                    continue
                timed(name, f"schedule: {iters} pairs a thread, pieces of {piece}", packed,
                      plan, starts, dict(short_iters=iters, piece_pairs=piece))
        del plan, packed
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
