#!/usr/bin/env python3
"""What sets the time of K2 (linearize + assemble) and K3 (trial cost), for
one tree of the port, on one CUDA card.

    python3 scripts/torch_lin_sweep.py [--root DIR] [--venice]

On ladybug-1723 and trafalgar-257 (and with ``--venice`` on
venice-1778-community, whose largest camera holds 179,458 observations), K2
and K3 as the LM loop calls them (``scripts/torch_band_time.py:lin_calls``,
no robust loss) over:
  - the problem's cameras;
  - only the longest camera's observations (every other camera empty);
  - every observation but the longest camera's (that camera empty);
and, for a tree with K2's schedule (``kernels/linearize.py:
linearize_schedule``), the problem's cameras under a few (threads a block,
observations a piece) other than the tree's own. A tree without the schedule
(K2 with one block per camera) is called with ``cam_start`` alone, so
``--root`` takes any checkout of the port (unpack another commit with ``git
archive``). Each call is first checked against the plain version in f64.
Beside them, a yardstick: the time PyTorch's fill kernel takes to write a
(40, O) tensor, K2's per-observation rows alone.
Times in ms a call: ladybug-1723 and trafalgar-257 as 20 calls replayed from
a CUDA graph, ``cold`` over copies of ``points`` and ``obs_2d`` rotating
through twice the L2 and ``l2`` on one copy; venice-1778-community as the
median of 10 calls between CUDA events. Before that, ``nvcc -Xptxas -v`` on
the tree's ``csrc/linearize.cu`` prints each kernel's registers and spills.
Prints the card's name and power limit first. The problems are generated
into ``data/cache/`` under the working directory on the first run
(venice-1778-community: ~50 s) and read from there after.
"""

import argparse
import os
import subprocess
import sys
import tempfile

from torch_band_time import event_ms, replay_ms, time_lin

SCHEDULES = ((64, 256), (64, 512), (128, 256), (128, 512), (128, 1024), (256, 512),
             (256, 1024))


def ptxas(root):
    """Registers, shared memory and spills of each kernel in the tree's
    linearize.cu, as ptxas reports them for the build's own target."""
    src = os.path.join(root, "tpu_ba_torch", "csrc", "linearize.cu")
    nvcc = "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                               "-O3", "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "lin.o"),
                               src], capture_output=True, text=True, timeout=600)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    if proc.returncode != 0:
        print(f"ptxas: nvcc failed ({proc.returncode})\n{proc.stderr}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--venice", action="store_true",
                    help="also sweep venice-1778-community")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_lin_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.kernels import linearize as lin
    from tpu_ba_torch.solver.plans import build_plans

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    scheduled = hasattr(lin, "linearize_schedule")
    print(f"root {root}; K2 {'over its piece schedule' if scheduled else 'one block a camera'}",
          flush=True)
    ptxas(root)
    dev = torch.device("cuda")
    names = ["ladybug-1723", "trafalgar-257"] + (["venice-1778-community"] if args.venice else [])
    for name in names:
        if name == "venice-1778-community":
            p, _ = make_bal_like_problem("venice-1778", covis="community", dtype=torch.float32,
                                         device=dev)
        else:
            p, _ = make_bal_like_problem(name, dtype=torch.float32, device=dev)
        graph = name != "venice-1778-community"
        C, P = p.n_cameras, p.n_points
        plans = build_plans(p.cam_idx, p.pt_idx, C, P)
        lens = np.diff(plans.cam_start.cpu().numpy().astype(np.int64))
        big = int(np.argmax(lens))
        print(f"{name}: {C} cameras, {p.obs_2d.shape[0]} observations (padded); a camera's "
              f"min {lens.min()}, median {np.median(lens):.0f}, p99 "
              f"{np.percentile(lens, 99):.0f}, max {lens.max()} (camera {big}); ms a call: "
              f"{'cold / l2 (graph)' if graph else 'eager'}", flush=True)
        if scheduled:
            s = plans.lin_sched
            print(f"{name}: schedule {s.threads} threads a block, pieces of at most "
                  f"{s.piece_obs}: {s.pieces.shape[1]} pieces, "
                  f"{int((s.piece_start.diff() > 1).sum())} split cameras, "
                  f"{s.empty.shape[0]} empty", flush=True)
        # a yardstick: K2's 40 rows written alone, by PyTorch's fill kernel
        rows = torch.empty((40, p.obs_2d.shape[0]), device=dev)
        t = (f"{replay_ms(torch, [lambda: rows.zero_()]):.4f} (graph)" if graph
             else f"{event_ms(torch, lambda: rows.zero_()):.4f} (eager events)")
        print(f"{name}: K2's 40 rows written alone (zero_ of a (40, O) tensor): {t}", flush=True)
        del rows
        full = (p.cameras, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
        time_lin(torch, f"{name} cameras", *full, plans, graph=graph)
        for what, keep in (("longest only", p.cam_idx == big), ("longest empty", p.cam_idx != big)):
            sub = [t[keep].contiguous() for t in full[2:]]
            sub_plans = build_plans(sub[1], sub[2], C, P)
            time_lin(torch, f"{name} {what}", p.cameras, p.points, *sub, sub_plans, graph=graph)
            del sub, sub_plans
        if scheduled:
            for threads, piece in SCHEDULES:
                if (threads, piece) == (lin.LIN_THREADS, lin.PIECE_OBS):
                    continue
                alt = dataclasses.replace(plans, lin_sched=lin.linearize_schedule(
                    plans.cam_start, device=dev, threads=threads, piece_obs=piece))
                time_lin(torch, f"{name} {threads}x{piece // threads}", *full, alt, graph=graph)
                del alt
        del p, plans, full
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
