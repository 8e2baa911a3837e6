#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_ba_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (the end-to-end phase a few):
  1. device  — the card's name and, from nvidia-smi, its power limit;
  2. build   — compile the hand-written kernels from tpu_ba_torch/csrc/;
  3. kernels — each kernel against its plain PyTorch version in f64 on the
               same inputs, at the ladybug-1723 shapes of the main path, with
               the median time of kernel and plain version (f32, CUDA events)
               and the least time the card could take (bytes over 3.35 TB/s or
               operations over 67 TFLOP/s, whichever is larger, both counted by
               tpu_ba_torch/bench/roofline.py). K1–K3 on the
               problem's initial parameters, over K2's and K3's piece
               schedule (printed), K2 and K3 timed as replayed CUDA graphs
               and repeated bit for bit; K7, K5, K6, K4 and K8 on that
               linearization's W, V, U and right-hand side and the port's own
               pair plan, whose shapes (and K7's schedule) are printed and
               checked; K7, K5 and K6 timed as replayed CUDA graphs. K8 (the PCG
               kernel with Ul and the preconditioner given) in its
               block-tridiagonal form at λ = 1 and at the smallest λ of a
               short list where the tridiagonal part of S is positive
               definite, in its block-Jacobi form against K4 on the same
               system, and on an indefinite preconditioner, where kernel and
               plain version must freeze alike;
  4. left    — a trafalgar-257 ring with loop closures at random camera pairs,
               whose band is capped at 32 offsets: the off-band leftover
               segments through K4 and K8 against the host loop over
               make_banded_matvec, and five LM iterations through solve();
  5. solve   — the ladybug-1723 ring stand-in at the golden's config (80 LM
               iterations, CG 100 at 1e-4, λ₀ 1e-4), f32, through
               solve(problem, LMConfig(linear_solver=...)) for
               "schur_pcg_pallas" (K1–K3), for "schur_sparse_pallas" (K1–K7,
               the reference's main path) and for "schur_sparse_pallas" with
               precond="tridiag" (K8 in place of K4), each solved twice (the
               repeat must give the same cost and CG total): final cost within
               1% of data/goldens/ladybug-1723.json, every kernel of the path
               launched by that solve, no per-CG-iteration host read on the
               sparse paths; then 5 iterations each of Huber, Cauchy and
               arctan, whose cost must not rise;
  resume   — the user's path around that solve, each result held bit for bit
               (torch.equal) against the schur_sparse_pallas solve above:
               save_bal of the problem to a temporary file, load_bal through
               the native parser and the Python tokenizer (both equal to the
               problem in memory), the loaded problem's solve (K1–K7 launched
               and no other kernel, within 1% of the golden), the same with
               checkpoint_every=20 and =10 (timed against the uninterrupted
               solve), a run killed at 40 (dumps every 10) and resumed to 80,
               the checkpoint's safetensors bytes through the reader, and
               python -m tpu_ba_torch.cli ba --bal-file ... --checkpoint-every
               20 --metrics ... --save-scene ... as a subprocess (the
               library's final cost, metrics ending in lm_solve, the scene
               reloading equal); its timings on one line;
  sharded  — the same problem through "schur_sparse_pallas" on two ranks
               (processes) sharing the card over gloo: the golden config
               twice (within 1% of the golden, both ranks equal bit for bit,
               K1, K2, K3, K4, K5 and K7 launched on each rank and K6 not),
               8 iterations at λ₀ = 10 against the single-device solve (cost
               rtol 1e-5, cameras rtol 1e-2 / atol 1e-3), the same on a 1-rank
               NCCL group; LM it/s beside the single-device solve's, the W
               all-gather's ms and the all-reduced bytes per λ-retry; with
               two cards or more, NCCL a rank per card and the scaling table;
  repeat   — K1's f64 instantiation against its plain version in f64 at
               ladybug-1723's point-keyed shape; the plain tiers on the card
               (schur_pcg and schur_sparse on ladybug-1723, 10 iterations;
               dense in f32 and f64 and schur_dense on a 10-camera synthetic
               problem), each solved twice: the same bits, K1 the only kernel
               launched;
  6. tiers   — heavy tracks (ladybug-49, max_degree=3) and the dense tiers
               (a 10-camera synthetic problem) on the card, each step against
               schur_sparse's in f64 (1e-8), and the dense tiers through
               solve() in f32;
  7. huber   — the trafalgar-257 ring stand-in at its golden's config (Huber
               at scale 1, 60 iterations) through "schur_sparse_pallas":
               final cost within 1% of data/goldens/trafalgar-257.json, K2
               timed at its shape before;
  8. venice  — venice-1778 with community covisibility (1,778 cameras,
               993,923 points, 5,001,946 observations) at its golden's
               config: the plan is not banded, K1 and K7 against their plain
               versions at this problem's shapes (K7's schedule printed), K2
               at its shape (its schedule printed), checked on the cameras
               with the most, the median and the fewest observations and
               repeated bit for bit,
               then two solves through
               "schur_sparse_pallas": final cost within 1% of
               data/goldens/venice-1778-community.json, K7, K1, K2, K3
               launched and K4–K6, K8 not, the same cost and CG total on the
               repeat. Needs about 10 GB of device memory.
  bench    — the benchmark harness as subprocesses: python -m tpu_ba_torch.cli
               bench (ladybug-1723, the headline) and python -m
               tpu_ba_torch.bench.harness at trafalgar-257's golden config
               (Huber, 60 iterations), each with its CPU baseline: the line
               under a _1gpu metric, the detail naming this card, within 1% of
               the golden, a roofline share in (0, 1.05], peak device memory,
               the path's kernels launched (the headline: K1–K7); each line and
               the phase's wall time printed.
Then one JSON line of per-kernel results, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises and exits non-zero; so does a machine without CUDA and a
directory without the package. The first run generates the problems into
data/cache/ (git-ignored) and the kernels into build/ (git-ignored).
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROBLEM = "ladybug-1723"
GOLDEN = os.path.join(HERE, "data", "goldens", f"{PROBLEM}.json")
ROBUST_SCALE = 2.0
# Tolerances of an f32 kernel against its plain version in f64 on the same
# f32 inputs, as max|kernel − ref| / max|ref| per output array:
#   K1 sums a few to a few hundred f32 values: ~n·2⁻²⁴ of the largest sum;
#   K2 runs a ~400-flop chain: P = R X + t cancels |X| ≈ 38 against |t| ≈ 30,
#      so the pixel u (|u| up to ~600) carries ~1e-6 relative error and the
#      residual r = u − uv about 6e-4 px, ~3e-4 relative at |r| ≈ 2 px. That
#      reaches a robust weight w times d log w / d log r: 0 with no loss, ≤ 1
#      (Huber), ≤ 2 (Cauchy), ≤ 4 (arctan), and W, U, gc and gp with it; so
#      "none" is held to 1e-4 and the robust kinds to 5e-3;
#   K3 sums 678,718 values of ρ in a tree; their errors are of both signs.
#   K7, K5, K6 invert the damped 3×3 point blocks V + λ·clip(diag V) and form
#      W V⁻¹ Wᵀ. The entries of a 9×9 block span many orders of magnitude
#      (distortion against rotation and translation terms), so the error is
#      taken per (block entry, band offset) row of the output, each row
#      relative to its own largest |ref|, and the worst row is held. At
#      λ = 1e-4 the blocks of short tracks are near-singular and the product
#      cancels, so any f32 evaluation is far from f64 and two orders of
#      evaluation differ by a few times in their largest error: the worst row
#      is held to 1e-5 or ten times the worst row of the plain version run in
#      f32, whichever is larger; so is the assembled band;
#   K4 against its plain version in f64 after a fixed 5 iterations: x per
#      camera parameter (column), each relative to its own largest |x|, the
#      worst held to 1e-4 or ten times that of the plain version run in f32,
#      whichever is larger (at λ = 1e-4 S is ill-conditioned, and five steps
#      of the f32 recurrence amplify the summation order); at the golden's
#      tolerance with five times its budget, iterations within 2 of the
#      plain run and the same ok (at λ = 1e-4 both break down: the f32 system
#      of the first linearization is not positive definite); where it
#      converged, the true residual ‖b − Sx‖/‖b‖ in f64 within twice the
#      tolerance (the f32 recurrence drifts from the true residual); at
#      λ = 1 it must converge.
#   K8 with the tridiagonal preconditioner as K4: 5 fixed iterations against
#      the plain version in f64 on the same f32 operands (factors included),
#      1e-4 or ten times the plain f32 version's error; run to the golden's
#      tolerance, iterations within max(3, 20%) of the plain run (the
#      reference's own criterion for its kernel) and the true residual in f64
#      within ten times the tolerance. With M⁻¹ given it solves K4's system
#      with an M⁻¹ from another elimination order: the same iteration count,
#      x to 1e-5 of max|x|.
# The plain version run in f32 has errors of the same size; its error is
# printed beside the kernel's.
TOL = {"segsum": 1e-5, "linearize": 5e-3, "cost": 1e-5, "pcg_band": 1e-4,
       "trackband": 1e-5, "slotband": 1e-5, "pairblocks": 1e-5, "pcg_band_given": 1e-4}
TOL_LINEARIZE_NO_LOSS = 1e-4
BAND_PLAIN_FACTOR = 10.0
REPLACES = {
    "segsum": "tpu_ba/kernels/segsum.py:256",
    "linearize": "tpu_ba/kernels/linearize.py:261",
    "cost": "tpu_ba/kernels/linearize.py:322",
    "pcg_band": "tpu_ba/kernels/pcg_band.py:252",
    "trackband": "tpu_ba/kernels/trackband.py:131",
    "slotband": "tpu_ba/kernels/slotband.py:142",
    "pairblocks": "tpu_ba/kernels/pairblocks.py:134",
    "pcg_band_given": "tpu_ba/kernels/pcg_band.py:252",
}
SOURCES = {
    "segsum": "tpu_ba_torch/csrc/segsum.cu",
    "linearize": "tpu_ba_torch/csrc/linearize.cu",
    "cost": "tpu_ba_torch/csrc/linearize.cu",
    "pcg_band": "tpu_ba_torch/csrc/pcg_band.cu",
    "trackband": "tpu_ba_torch/csrc/trackband.cu",
    "slotband": "tpu_ba_torch/csrc/slotband.cu",
    "pairblocks": "tpu_ba_torch/csrc/pairblocks.cu",
    "pcg_band_given": "tpu_ba_torch/csrc/pcg_band.cu",
}
BAND_BUILD = ("trackband", "slotband", "pairblocks")
# the main paths on ladybug-1723: (name, tier, preconditioner, kernels it must launch)
PATHS = (
    ("schur_pcg_pallas", "schur_pcg_pallas", "jacobi", ("segsum", "linearize", "cost")),
    ("schur_sparse_pallas", "schur_sparse_pallas", "jacobi",
     ("segsum", "linearize", "cost", "pcg_band") + BAND_BUILD),
    ("tridiag", "schur_sparse_pallas", "tridiag",
     ("segsum", "linearize", "cost", "pcg_band_given") + BAND_BUILD),
)
VENICE_KERNELS = ("segsum", "linearize", "cost", "pairblocks")
# phase bench: (name, the module and flags run as a subprocess, the metric of
# its line, kernels it must launch)
BENCH_RUNS = (
    ("headline", ["tpu_ba_torch.cli", "bench"], "ba_iters_per_sec_ladybug_1723_1gpu",
     {"segsum", "linearize", "cost", "pcg_band"} | set(BAND_BUILD)),
    ("trafalgar-257 huber", ["tpu_ba_torch.bench.harness", "--problem", "trafalgar-257",
                             "--robust", "huber", "--max-iters", "60"],
     "ba_iters_per_sec_trafalgar_257_1gpu", {"segsum", "linearize", "cost", "pcg_band",
                                             "pairblocks"}),
)
GOLDENS = os.path.join(HERE, "data", "goldens")
# the pose graph's ring ("thousands of nodes at most", tpu_ba/posegraph/solver.py)
# and config 4 of the SfM front end (scripts/sfm_sequence_bench.py)
PG_NODES = 2000
SFM_FRAMES, SFM_POINTS, SFM_SEED = 60, 600, 4
# config 4's bar: the reference registered 60/60 at 0.90 px and ATE 0.080 (sfm_bench.json)
SFM_MIN_FRAMES, SFM_MAX_RMSE_PX, SFM_MAX_ATE = 57, 2.0, 0.25
L2_BYTES = 50 << 20
# the pair plan of the ladybug-1723 ring stand-in, as the reference builds it
EXPECTED_PLAN = {
    "band_offsets": tuple(range(13)) + (1719, 1720, 1721, 1722), "c_pad": 1792,
    "k_band": 30464, "n_segments": 30464, "k_pad": 30720, "n_pairs": 77824,
    "n_heavy_pts": 0, "track_dmax": 5, "track_n_tracked": 108300, "track_pt_pad": 108544,
    "slot_degrees": (4,), "slot_tiles": (1024,), "slot_widths": (1152,),
    "slot_n_tracked": 33630, "slot_pt_pad": (33792,), "slot_l2_len": 38912,
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def median_ms(torch, fn, reps=20, warmup=3):
    """Median over ``reps`` launches of ``fn``, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fns, launches=20, reps=10):
    """Device time of one call: ``launches`` calls, taken in turn from the
    list ``fns`` (or all of the one callable), captured into a CUDA graph and
    the replays timed by CUDA events. A call that the card finishes in a few
    microseconds cannot be timed call by call from Python, where launching it
    takes tens of microseconds: between two events one then reads the host's
    pace. With one callable the replayed calls read the same inputs, and find
    in the 50 MB L2 what fits there; over ``value_copies`` each call reads
    its values from device memory, as a call inside a solve does."""
    fns = fns if isinstance(fns, list) else [fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    return median_ms(torch, graph.replay, reps=reps, warmup=2) / launches


def input_copies(ts, launches=20):
    """The tuple of tensors ``ts`` and clones of it, more than twice the L2's
    size in all (one for each replayed launch at most)."""
    n_bytes = sum(t.numel() * t.element_size() for t in ts)
    n = min(launches, max(1, -(-2 * L2_BYTES // n_bytes) + 1))
    return [ts] + [tuple(t.clone() for t in ts) for _ in range(n - 1)]


def value_copies(vals, launches=20):
    """``vals`` and clones of it, more than twice the L2's size in all."""
    return [c[0] for c in input_copies((vals,), launches)]


def describe_lin_schedule(s):
    """K2's and K3's schedule (``LinSchedule``) in words."""
    n_pieces = s.piece_start.diff()
    return (f"{s.threads} threads a block, pieces of at most {s.piece_obs} observations: "
            f"{s.pieces.shape[1]} pieces, {int((n_pieces > 1).sum())} cameras split, "
            f"{s.empty.shape[0]} empty cameras; longest camera {s.longest} observations in "
            f"{int(n_pieces.max())} pieces")


def describe_schedule(s):
    """K7's schedule (``PairSchedule``) in words."""
    from tpu_ba_torch.kernels.pairblocks import PIECE_PAIRS
    return (f"G {1 << s.group_log2} lanes a short segment (at most {s.cut} pairs): "
            f"{s.items.shape[1]} short items; {s.fold_seg.shape[0]} split segments in "
            f"{s.pieces.shape[1]} pieces of at most {PIECE_PAIRS} pairs; {s.empty.shape[0]} empty "
            f"segments; longest segment {s.longest} pairs")


def err(out, ref):
    """(max abs error, max abs error / max |ref|) of an f32 result against an
    f64 reference."""
    d = (out.double() - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-300)


def err_rows(out, ref, width):
    """(max abs error, worst row's max abs error / that row's max |ref|) of an
    f32 result against an f64 reference of the same shape, both cut into rows
    of ``width`` consecutive entries (for a band-laid output: one row per
    block entry and band offset). A row whose reference is all zero must be
    exactly zero, else the error is infinite."""
    d = (out.double() - ref).abs().reshape(-1, width).amax(1)
    scale = ref.abs().reshape(-1, width).amax(1)
    rel = d / scale.clamp_min(1e-300)
    rel[(scale == 0) & (d > 0)] = math.inf
    rel[(scale == 0) & (d == 0)] = 0.0
    return d.max().item(), rel.max().item()


def tridiag_is_pd(D, B_up):
    """Whether the block-tridiagonal matrix with diagonal blocks D (C, n, n)
    and upper couplings B_up is positive definite: block Cholesky along the
    chain, in f64 on the host."""
    import numpy as np

    D = D.double().cpu().numpy()
    B_up = B_up.double().cpu().numpy()
    S = D[0]
    for c in range(D.shape[0]):
        if c:
            S = D[c] - B_up[c - 1].T @ np.linalg.solve(S, B_up[c - 1])
        if np.linalg.eigvalsh(0.5 * (S + S.T)).min() <= 0.0:
            return False
    return True


def phase_resume(torch, problem, full, cfg, golden, kernels):
    """The ladybug-1723 problem through a BAL file, chunked and resumed
    solves and the command line, each held bit for bit against ``full``,
    the uninterrupted schur_sparse_pallas solve of phase 5 (``cfg``)."""
    import shutil
    import tempfile

    from tpu_ba_torch.checkpoint.state import (load_checkpoint, safetensors_arrays,
                                               safetensors_bytes)
    from tpu_ba_torch.io import native
    from tpu_ba_torch.io.bal import load_bal, save_bal
    from tpu_ba_torch.io.scene import load_scene
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.solver import pcg as pcg_mod
    from tpu_ba_torch.solver.lm import save_result, solve

    fields = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")
    t = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[key] = time.perf_counter() - t0
        return out

    def same(a, b, names, what):
        bad = [f for f in names if not torch.equal(getattr(a, f), getattr(b, f))]
        if bad:
            raise AssertionError(f"{what}: {bad} differ from the uninterrupted solve")

    def solve_counted(key, prob, config, **kw):
        _lib.reset_launches()
        pcg_mod.reset_host_reads()
        res = timed(key, lambda: solve(prob, config, **kw))
        res.cost.item()
        launched = {k: v for k, v in _lib.launches.items() if v}
        if set(launched) != set(kernels):
            raise AssertionError(f"{key}: launched {launched}, the path's kernels are {kernels}")
        return res, dict(pcg_mod.host_reads)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        bal = os.path.join(tmp, "ladybug-1723.txt")
        timed("save_bal_s", lambda: save_bal(bal, problem))
        t["bal_bytes"] = os.path.getsize(bal)
        timed("native_build_s", native.load_library)
        for key, use_native in (("load_bal_native_s", True), ("load_bal_python_s", False)):
            loaded = timed(key, lambda: load_bal(bal, use_native=use_native,
                                                 device=problem.device))
            same(loaded, problem, fields, f"load_bal(use_native={use_native})")
            if (loaded.n_cameras, loaded.n_points, loaded.n_obs) != (
                    problem.n_cameras, problem.n_points, problem.n_obs):
                raise AssertionError(f"load_bal(use_native={use_native}): counts differ")
        say("resume", f"save_bal {t['bal_bytes']} bytes in {t['save_bal_s']:.3f} s; load_bal "
                      f"native {t['load_bal_native_s']:.3f} s (g++ build {t['native_build_s']:.3f}"
                      f" s before), Python tokenizer {t['load_bal_python_s']:.3f} s; both equal "
                      f"the problem in memory bit for bit")

        result_fields = ("cameras", "points", "cost", "initial_cost", "lam", "nu", "warm_dxc",
                         "gnorm0", "iterations", "accepted", "converged", "cost_history",
                         "lam_history", "cg_history")
        res, reads = solve_counted("solve_s", loaded, cfg)
        same(res, full, result_fields, "the solve of the loaded problem")
        gap = (res.cost.item() - golden["final_cost"]) / golden["final_cost"]
        if not abs(gap) < 0.01:
            raise AssertionError(f"loaded problem: cost {res.cost.item()} not within 1% of golden")
        iters = int(res.iterations)
        chunk_reads, configs = {}, {"uninterrupted": cfg}
        for every in (20, 10):
            ck = os.path.join(tmp, f"ck{every}")
            configs[f"every{every}"] = dataclasses.replace(cfg, checkpoint_every=every,
                                                           checkpoint_path=ck)
            res_c, chunk_reads[every] = solve_counted(f"every{every}_s", loaded,
                                                      configs[f"every{every}"])
            same(res_c, full, result_fields, f"checkpoint_every={every}")
            if load_checkpoint(ck)["iteration"] != iters:
                raise AssertionError(f"checkpoint_every={every}: last dump not at {iters}")
        # LM it/s of the three, in turns on one clock; the median of 9 each
        runs = {k: [] for k in configs}
        for _ in range(9):
            for k, c in configs.items():
                timed("run_s", lambda: solve(loaded, c).cost.item())
                runs[k].append(iters / t["run_s"])
        del t["run_s"]
        for k, v in runs.items():
            t[f"lm_it_s_{k}"] = statistics.median(v)
            t[f"lm_it_s_{k}_runs"] = v
        ck = os.path.join(tmp, "dump")
        dumps = []
        for _ in range(5):
            timed("dump_s", lambda: save_result(ck, full))
            dumps.append(t["dump_s"])
        del t["dump_s"]
        t["dump_ms"] = 1e3 * statistics.median(dumps)
        t["dump_bytes"] = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        say("resume", f"{iters} LM iterations, cost {res.cost.item():.6f} (gap {100 * gap:+.5f}%),"
                      f" equal bit for bit to phase 5's, and so are checkpoint_every=20 and =10;"
                      f" LM it/s in turns, median of 9: uninterrupted "
                      f"{t['lm_it_s_uninterrupted']:.3f}, checkpoint_every=20 "
                      f"{t['lm_it_s_every20']:.3f}, =10 {t['lm_it_s_every10']:.3f}; host reads "
                      f"{reads} / {chunk_reads[20]} / {chunk_reads[10]}; a dump "
                      f"{t['dump_ms']:.3f} ms for {t['dump_bytes']} bytes")

        killed = os.path.join(tmp, "killed")
        k_res = solve(loaded, dataclasses.replace(cfg, max_iters=40, checkpoint_every=10,
                                                  checkpoint_path=killed))
        if load_checkpoint(killed)["iteration"] != 40:
            raise AssertionError("the killed run's last dump is not at iteration 40")
        resumed = timed("resumed_s", lambda: solve(loaded, cfg, resume_from=killed))
        same(resumed, full, ("cameras", "points", "cost", "lam", "nu", "iterations"),
             "killed at 40 and resumed")
        for f in ("cost_history", "cg_history", "lam_history"):
            if not torch.equal(getattr(resumed, f)[40:], getattr(full, f)[40:]):
                raise AssertionError(f"killed at 40 and resumed: {f}[40:] differs")
        with open(os.path.join(killed, "state.safetensors"), "rb") as fh:
            raw = fh.read()
        arrays = safetensors_arrays(raw)
        if safetensors_bytes(arrays) != raw or not all(
                np_equal(arrays[k], getattr(k_res, k)) for k in ("cameras", "points")):
            raise AssertionError("the checkpoint's safetensors bytes do not round-trip")
        say("resume", "killed at 40 (dumps every 10) and resumed to 80: cost, cameras, points, "
                      "histories from 40 equal to the uninterrupted run; the checkpoint's "
                      f"{len(raw)} safetensors bytes round-trip through the reader")

        ck, metrics, scene = (os.path.join(tmp, n) for n in ("cli_ck", "m.jsonl", "s.npz"))
        cmd = [sys.executable, "-m", "tpu_ba_torch.cli", "ba", "--bal-file", bal, "--solver",
               "schur_sparse_pallas", "--max-iters", str(cfg.max_iters), "--cg-iters",
               str(cfg.cg_max_iters), "--cg-tol", repr(cfg.cg_tol), "--checkpoint", ck,
               "--checkpoint-every", "20", "--metrics", metrics, "--save-scene", scene]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
        t["cli_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(metrics) as fh:
            last = json.loads(fh.read().strip().splitlines()[-1])
        saved = load_scene(scene, device=problem.device)
        if not (out["final_cost"] == full.cost.item() and out["device"] == str(problem.device)
                and last["event"] == "lm_solve" and last["final_cost"] == out["final_cost"]
                and load_checkpoint(ck)["iteration"] == iters):
            raise AssertionError(f"the command line gave {out}, metrics {last['event']}; the "
                                 f"library {full.cost.item()}")
        same(saved, full, ("cameras", "points"), "the command line's saved scene")
        same(saved, problem, fields[2:], "the command line's saved scene")
        say("resume", f"python -m tpu_ba_torch.cli ba --bal-file ...: final cost "
                      f"{out['final_cost']:.6f} = the library's, {out['wall_s']:.3f} s in its "
                      f"solve, {t['cli_s']:.3f} s the whole process; metrics end in lm_solve; "
                      f"the saved scene reloads equal")
        print("[resume] timings " + json.dumps(t), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pose_graph_ring(torch, n, dev):
    """The posegraph command line's ring of ``n`` nodes (its draws, in
    order), built in one batch on ``dev``: (init, ei, ej, meas)."""
    import numpy as np

    from tpu_ba_torch.geometry.se3 import se3_compose, se3_exp, se3_relative

    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(n) / n
    z = np.zeros(n)
    gt = np.stack([z, ang, z, np.cos(ang), z, np.sin(ang)], axis=1)
    ei = np.r_[np.arange(1, n), 0].astype(np.int32)
    ej = np.r_[np.arange(0, n - 1), n - 1].astype(np.int32)
    noise = 0.03 * rng.standard_normal((n, 6))
    gt_t = torch.as_tensor(gt, device=dev)
    meas = se3_compose(se3_exp(torch.as_tensor(noise, device=dev)),
                       se3_relative(gt_t[ei], gt_t[ej]))
    init = gt + 0.1 * rng.standard_normal(gt.shape)
    init[0] = gt[0]
    return torch.as_tensor(init, device=dev), ei, ej, meas


def phase_posegraph(torch):
    """``python -m tpu_ba_torch.cli posegraph`` on a ring of ``PG_NODES``
    nodes as a subprocess, then the same ring through the library, solved
    twice: the cost must fall below 0.1 × the initial cost and the repeat
    give the same nodes, cost and iterations bit for bit; LM it/s."""
    from tpu_ba_torch.posegraph import pose_graph_cost, solve_pose_graph

    dev = torch.device("cuda")
    cmd = [sys.executable, "-m", "tpu_ba_torch.cli", "posegraph", "--nodes", str(PG_NODES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (out["final_cost"] < 0.1 * out["initial_cost"] and out["device"] == "cuda"):
        raise AssertionError(f"the posegraph command line gave {out}")
    say("posegraph", f"python -m tpu_ba_torch.cli posegraph --nodes {PG_NODES}: cost "
                     f"{out['initial_cost']:.6f} -> {out['final_cost']:.6f} in "
                     f"{out['iterations']} iterations; ring built edge by edge in "
                     f"{out['build_s']:.3f} s, solved in {out['wall_s']:.3f} s, {cli_s:.3f} s "
                     f"the whole process")

    n = PG_NODES
    init, ei, ej, meas = pose_graph_ring(torch, n, dev)
    c0 = pose_graph_cost(init, ei, ej, meas).item()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, cost, it = solve_pose_graph(init, ei, ej, meas)
        c = cost.item()
        runs.append((nodes, cost, it, time.perf_counter() - t0))
        if not c < 0.1 * c0:
            raise AssertionError(f"pose graph of {n} nodes: cost {c0} -> {c}")
    (n1, c1, i1, s1), (n2, c2, i2, s2) = runs
    if not (torch.equal(n1, n2) and torch.equal(c1, c2) and i1 == i2):
        raise AssertionError(f"pose graph of {n} nodes: the repeat differs")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("posegraph", f"library, ring of {n} nodes ({6 * n}x{6 * n} f64 H): cost {c0:.6f} -> "
                     f"{c1.item():.6f} in {i1} iterations, {s1:.3f} s and {s2:.3f} s: LM it/s "
                     f"{i1 / s1:.3f} and {i2 / s2:.3f}; the repeat equal bit for bit; the "
                     f"command line's final cost {out['final_cost']:.9f}; peak device memory "
                     f"{peak:.2f} GiB")


def phase_sfm(torch):
    """Config 4 on the card: a 60-frame rendered sequence through
    ``run_incremental_sfm`` (``SfMConfig`` defaults, seed 4), twice; the
    pose-graph drift recovery of scripts/sfm_sequence_bench.py on its result;
    ``python -m tpu_ba_torch.cli sfm --out ...`` as a subprocess, whose BAL
    file ``load_bal`` reads back."""
    import shutil
    import tempfile

    import numpy as np
    from torch.autograd import DeviceType

    import tpu_ba_torch.sfm.incremental as inc
    from tpu_ba_torch.bench.ate import ate_rmse, camera_centers, rpe_stats
    from tpu_ba_torch.geometry.se3 import se3_compose, se3_exp, se3_relative
    from tpu_ba_torch.io.bal import load_bal
    from tpu_ba_torch.io.sequences import render_blob_sequence
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.sfm.posegraph_bridge import refine_sfm_with_pose_graph

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    frames, gt = render_blob_sequence(n_frames=SFM_FRAMES, n_points=SFM_POINTS, seed=SFM_SEED,
                                      device=dev)
    say("sfm", f"rendered {SFM_FRAMES} frames of {SFM_POINTS} points ({frames.shape[1]}x"
               f"{frames.shape[2]}) in {time.perf_counter() - t0:.3f} s")
    K = gt["K"]
    cfg = inc.SfMConfig(seed=SFM_SEED)

    _lib.reset_launches()
    t0 = time.perf_counter()
    res = inc.run_incremental_sfm(frames, K, cfg, device=dev)
    sfm_s = time.perf_counter() - t0
    launched = {k: v for k, v in _lib.launches.items() if v}
    if set(launched) != {"segsum"}:
        raise AssertionError(f"the SfM path launched {launched}; its windowed BA's sums are "
                             f"K1's and it runs no other kernel")
    rep = res.report
    reg = res.registered
    rmse_px = math.sqrt(2.0 * res.final_cost / max(rep["n_obs"], 1))
    ate = ate_rmse(res.poses, gt["poses"], mask=reg)
    rpe = rpe_stats(res.poses, gt["poses"], mask=reg)
    say("sfm", f"config 4: {int(reg.sum())}/{SFM_FRAMES} registered, {rep['n_points']} map "
               f"points, {rep['n_obs']} observations, reprojection RMSE {rmse_px:.4f} px, ATE "
               f"RMSE {ate['ate_rmse']:.5f} (scale {ate['align_scale']:.4f}), RPE mean "
               f"{rpe['rpe_mean']:.5f} max {rpe['rpe_max']:.5f}; {sfm_s:.3f} s")
    say("sfm", "stage seconds " + json.dumps(rep["stage_s"]))
    say("sfm", "stage split " + json.dumps(rep["stage_split"]))
    if not (reg.sum() >= SFM_MIN_FRAMES and rmse_px < SFM_MAX_RMSE_PX
            and ate["ate_rmse"] < SFM_MAX_ATE):
        raise AssertionError(f"config 4 below its bar ({SFM_MIN_FRAMES} frames, "
                             f"{SFM_MAX_RMSE_PX} px, ATE {SFM_MAX_ATE}): {int(reg.sum())}, "
                             f"{rmse_px}, {ate['ate_rmse']}")

    # the repeat, with each windowed BA timed on the host clock and every
    # tenth also under torch.profiler (device time: kernel and memcpy events)
    orig = inc._bundle_adjust
    calls = []

    def timed_ba(poses, points, obs_f, obs_p, obs_xy, K, frames, iters, *rest):
        args = (poses, points, obs_f, obs_p, obs_xy, K, frames, iters, *rest)
        profiled = len(calls) % 10 == 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                out = orig(*args)
                torch.cuda.synchronize()
            device_s = 1e-6 * sum(e.device_time_total for e in prof.events()
                                  if e.device_type == DeviceType.CUDA)
        else:
            out = orig(*args)
            torch.cuda.synchronize()
            device_s = None
        calls.append((iters == cfg.ba_iters, time.perf_counter() - t0, device_s))
        return out

    inc._bundle_adjust = timed_ba
    try:
        t0 = time.perf_counter()
        res2 = inc.run_incremental_sfm(frames, K, cfg, device=dev)
        sfm2_s = time.perf_counter() - t0
    finally:
        inc._bundle_adjust = orig
    same = (np.array_equal(res.poses, res2.poses) and np.array_equal(res.points, res2.points)
            and np.array_equal(res.track_point, res2.track_point)
            and res.final_cost == res2.final_cost)
    say("sfm", f"repeat: {int(res2.registered.sum())} registered, {res2.report['n_points']} "
               f"points, {res2.report['n_obs']} observations, final cost "
               f"{res2.final_cost:.6f} (first {res.final_cost:.6f}); bits match: {same}; "
               f"{sfm2_s:.3f} s with the windowed BAs timed; K1 launches of the first run "
               f"{launched['segsum']}")
    if not (same and np.array_equal(res.registered, res2.registered)
            and res.report["n_points"] == res2.report["n_points"]):
        raise AssertionError(f"config 4's repeat differs: {int(res2.registered.sum())} / "
                             f"{int(reg.sum())} registered, {res2.report['n_points']} / "
                             f"{rep['n_points']} points, cost {res2.final_cost} / "
                             f"{res.final_cost}")
    win = [c for c in calls if c[0]]
    plain = [w for _, w, d in win if d is None]
    prof = [(w, d) for _, w, d in win if d is not None]
    med_wall = statistics.median(plain)
    med_dev = statistics.median(d for _, d in prof)
    say("sfm", f"windowed BA: {len(win)} calls, median {1e3 * med_wall:.3f} ms a call on the host "
               f"clock (unprofiled calls), device {1e3 * med_dev:.3f} ms a call (median of "
               f"{len(prof)} profiled: {[round(1e3 * d, 3) for _, d in prof]} ms, under the "
               f"profiler {[round(1e3 * w, 3) for w, _ in prof]} ms): device busy "
               f"{100 * med_dev / med_wall:.2f}%, host {100 - 100 * med_dev / med_wall:.2f}%; "
               f"final BA rounds {[round(w, 3) for f, w, _ in calls if not f]} s")

    # pose-graph drift recovery (scripts/sfm_sequence_bench.py): a random-walk
    # drift injected into the trajectory, the pre-drift relative poses of two
    # loop-closure edges distributed by the pose graph
    t0 = time.perf_counter()
    reg_idx = np.where(reg)[0]
    f0, fl = int(reg_idx[0]), int(reg_idx[-1])
    fm = int(reg_idx[len(reg_idx) // 2])
    rng = np.random.default_rng(11)
    drifted = res.poses.copy()
    xi = np.zeros(6)
    host = torch.as_tensor
    for i in reg_idx[2:]:                 # keep the gauge-defining pair
        xi = xi + np.concatenate([rng.normal(0, 0.120, 3), rng.normal(0, 0.010, 3)])
        drifted[i] = se3_compose(se3_exp(host(xi)), host(res.poses[i])).numpy()
    z_loop = se3_relative(host(res.poses[fl]), host(res.poses[f0])).numpy()
    z_mid = se3_relative(host(res.poses[fm]), host(res.poses[f0])).numpy()
    res_rec, pg_cost, pg_iters = refine_sfm_with_pose_graph(
        dataclasses.replace(res, poses=drifted), extra_edges=[(fl, f0, z_loop), (fm, f0, z_mid)],
        device=dev)
    base_c = camera_centers(res.poses)[reg_idx]

    def rmse_vs_base(poses):
        d = camera_centers(poses)[reg_idx] - base_c
        return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))

    drift_rmse, rec_rmse = rmse_vs_base(drifted), rmse_vs_base(res_rec.poses)
    ate_d = ate_rmse(drifted, gt["poses"], mask=reg)["ate_rmse"]
    ate_r = ate_rmse(res_rec.poses, gt["poses"], mask=reg)["ate_rmse"]
    say("sfm", f"drift recovery: center RMSE vs the pre-drift trajectory {drift_rmse:.5f} -> "
               f"{rec_rmse:.5f} ({pg_iters} pose-graph iterations, loop edges {fl}->{f0}, "
               f"{fm}->{f0}); Umeyama ATE {ate_d:.5f} -> {ate_r:.5f}; "
               f"{time.perf_counter() - t0:.3f} s")
    if not rec_rmse < drift_rmse:
        raise AssertionError(f"drift recovery did not recover: {drift_rmse} -> {rec_rmse}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sfm_")
    try:
        bal = os.path.join(tmp, "scene.txt")
        cmd = [sys.executable, "-m", "tpu_ba_torch.cli", "sfm", "--out", bal]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        prob = load_bal(bal, device=dev)
        finite = all(bool(torch.isfinite(t).all()) for t in (prob.cameras, prob.points,
                                                             prob.obs_2d))
        if not ((prob.n_cameras, prob.n_points, prob.n_obs) == (
                out["registered_frames"], out["n_points"], out["n_obs"]) and finite
                and out["device"] == "cuda"):
            raise AssertionError(f"cli sfm gave {out}; load_bal read {prob.n_cameras} cameras, "
                                 f"{prob.n_points} points, {prob.n_obs} observations")
        say("sfm", f"python -m tpu_ba_torch.cli sfm --out ...: {out['registered_frames']} "
                   f"registered, {out['n_points']} points, {out['n_obs']} observations, "
                   f"{out['rmse_px']:.4f} px; load_bal reads the BAL file back with those "
                   f"counts; {cli_s:.3f} s the whole process")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_rank(mesh, jobs, gather_width):
    """One rank of phase ``sharded`` (spawned by ``run_ranks``): the jobs of
    ``solve_jobs``, then the W all-gather alone at the rank's width, timed
    over 5 calls after 2 (each call ends in a synchronize)."""
    import torch

    from tpu_ba_torch.sharding.launch import solve_jobs
    from tpu_ba_torch.solver.collective import all_gather_cols

    out = solve_jobs(mesh, jobs)
    W = torch.randn((27, gather_width), device=mesh.device)
    times = []
    for i in range(7):
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        all_gather_cols(W, mesh)
        torch.cuda.synchronize(mesh.device)
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)


SHARDED_KERNELS = ("segsum", "linearize", "cost", "pairblocks", "trackband", "pcg_band")


def phase_sharded(torch, problem, golden, golden_cfg, single_lm_it_s):
    """ladybug-1723 through ``schur_sparse_pallas`` on two ranks sharing the
    card over gloo: the golden config twice (within 1% of the golden, the
    kernels of the path launched on each rank and K6 not, both ranks' bits
    equal, LM it/s of the second), then 8 iterations at λ₀ = 10 against the
    single-device solve; a 1-rank NCCL group on the same 8 iterations; with
    two cards or more, NCCL with a rank per card and the scaling table.
    Returns rank 0's launch counts of the first golden solve."""
    import numpy as np

    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.sharding import scaling_report
    from tpu_ba_torch.sharding.launch import problem_arrays, run_ranks, solve_jobs
    from tpu_ba_torch.solver.lm import solve

    arrays = problem_arrays(problem)
    gold = dict(golden_cfg, linear_solver="schur_sparse_pallas")
    # at λ₀ = 1e-4 the first f32 systems are not positive definite and any two
    # summation orders part within 8 iterations; at λ₀ = 10 they do not
    short = dict(gold, max_iters=8, init_lambda=10.0)
    jobs = [dict(problem=arrays, config=gold), dict(problem=arrays, config=gold),
            dict(problem=arrays, config=short)]
    width = -(-problem.obs_2d.shape[0] // 256) * 128          # a rank's padded shard
    t0 = time.perf_counter()
    ranks = run_ranks(2, sharded_rank, (jobs, width), backend="gloo")
    spawn_s = time.perf_counter() - t0
    (r0, gather_ms0), (r1, gather_ms1) = ranks
    for j, (a, b) in enumerate(zip(r0, r1)):
        keys = ("cost", "iterations", "cg_history", "cameras", "points")
        if not all(np.array_equal(a[k], b[k]) for k in keys):
            raise AssertionError(f"sharded job {j}: the two ranks differ: cost {a['cost']} / "
                                 f"{b['cost']}, iterations {a['iterations']} / "
                                 f"{b['iterations']}")
    for r in (r0, r1):
        launches = r[0]["launches"]
        missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
        if missing or launches["slotband"] or launches["pcg_band_given"]:
            raise AssertionError(f"rank {r[0]['rank']}: kernels of the sharded path not "
                                 f"launched {missing}, or K6/K8 launched: {launches}")
    g, g2 = r0[0], r0[1]
    gap = (float(g["cost"]) - golden["final_cost"]) / golden["final_cost"]
    iters, cg_total = int(g["iterations"]), int(g["cg_history"].sum())
    say("sharded", f"2 ranks over gloo sharing the card ({g['device']} each), ladybug-1723 "
                   f"schur_sparse_pallas at the golden config: cost {float(g['cost']):.6f}, "
                   f"golden {golden['final_cost']:.6f}, gap {100 * gap:+.5f}% (limit 1%); "
                   f"{iters} LM iterations, cg_total {cg_total}; both ranks equal bit for bit "
                   f"(cost, iterations, CG history, cameras, points) in all 3 solves; launches "
                   f"per rank {g['launches']}; host reads {g['host_reads']}")
    if not (math.isfinite(float(g["cost"])) and abs(gap) < 0.01):
        raise AssertionError(f"sharded: final cost {float(g['cost'])} not within 1% of "
                             f"{golden['final_cost']}")
    if not (float(g2["cost"]) == float(g["cost"]) and int(g2["cg_history"].sum()) == cg_total):
        raise AssertionError(f"sharded: the repeat gave {float(g2['cost'])}, "
                             f"{int(g2['cg_history'].sum())}")
    c = g2["collectives"]
    n_lin = c["all_gather"]
    say("sharded", f"LM it/s: 2 ranks sharing one card {iters / g2['seconds']:.3f} (second "
                   f"golden solve, {g2['seconds']:.3f} s), one device without collectives "
                   f"{single_lm_it_s:.3f} (phase solve, same call); two ranks on one card time-"
                   f"slice it and pass every collective through the host (gloo), so this is "
                   f"not a scaling figure. Per rank: {n_lin} W all-gathers of "
                   f"{c['all_gather_bytes'] / max(n_lin, 1) / 2**20:.2f} MiB, one a "
                   f"linearization, {gather_ms0:.3f} / {gather_ms1:.3f} ms each alone (ranks 0 "
                   f"/ 1, median of 5); {c['all_reduce']} all-reduces of "
                   f"{c['all_reduce_bytes'] / 2**20:.2f} MiB in all, "
                   f"{c['all_reduce_bytes'] / iters / 2**20:.3f} MiB per λ-retry; spawn and "
                   f"3 solves {spawn_s:.1f} s")
    single = solve(problem, LMConfig(**short))
    s_cost, s_cams = single.cost.item(), single.cameras.cpu().numpy()
    ones = run_ranks(1, solve_jobs, (jobs[2:],), backend="nccl")[0][0]
    for name, r in (("2 ranks gloo", r0[2]), ("1 rank nccl", ones)):
        rel = (float(r["cost"]) - s_cost) / s_cost
        cam_ok = bool(np.all(np.abs(r["cameras"] - s_cams) <= 1e-3 + 1e-2 * np.abs(s_cams)))
        say("sharded", f"8 iterations at λ₀ = 10, {name} ({r['backend']}, {r['device']}): cost "
                       f"{float(r['cost']):.6f} against the single-device solve's {s_cost:.6f}, "
                       f"rel {rel:+.3e} (limit 1e-5); cameras within rtol 1e-2 / atol 1e-3: "
                       f"{cam_ok}; CG {r['cg_history'].tolist()} (single "
                       f"{single.cg_history.tolist()})")
        if not (abs(rel) <= 1e-5 and cam_ok and int(r["iterations"]) == 8):
            raise AssertionError(f"sharded {name}: 8 iterations differ from the single-device "
                                 f"solve: cost {float(r['cost'])} / {s_cost}, cameras {cam_ok}")
    if ones["backend"] != "nccl":
        raise AssertionError(f"the 1-rank group ran over {ones['backend']}")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        walls = {1: ones["seconds"]}
        per_card = run_ranks(2, solve_jobs, (jobs[2:],), backend="nccl")
        walls[2] = max(r[0]["seconds"] for r in per_card)
        say("sharded", f"NCCL, a rank per card: scaling {json.dumps(scaling_report(walls))}")
    else:
        say("sharded", "scaling not measured: one card")
    return dict(g["launches"])


def phase_repeat(torch, problem, golden_cfg):
    """The plain tiers on the card, each solved twice: the same bits. Their
    sums are K1's over starts built on the device (``segment_sum_t``) and
    the dense tier writes H in passes, so no sum adds with atomics."""
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.synthetic import make_synthetic_problem
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.kernels.segsum import segment_sum_t, sorted_segment_sum_t_plain
    from tpu_ba_torch.solver.lm import solve

    # K1's f64 instantiation as the f64 tiers' point-keyed sums call it (keys
    # not sorted: a stable argsort, read through as perm), against the plain
    # version in f64
    gen = torch.Generator(device="cuda").manual_seed(5)
    vals = torch.randn((3, problem.obs_2d.shape[0]), dtype=torch.float64, generator=gen,
                       device="cuda")
    out = segment_sum_t(vals, problem.pt_idx, problem.n_points)
    ref = sorted_segment_sum_t_plain(vals, problem.pt_idx, problem.n_points)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    again = torch.equal(out, segment_sum_t(vals, problem.pt_idx, problem.n_points))
    say("repeat", f"K1 in f64, (3,{vals.shape[1]}) by point through a stable argsort: rel err "
                  f"{rel:.2e} against the plain version in f64 (limit 1e-12), a second call "
                  f"equal bit for bit: {again}")
    if not (rel <= 1e-12 and again):
        raise AssertionError(f"K1 in f64: rel err {rel}, repeat {again}")

    small = {dt: make_synthetic_problem(10, 100, obs_per_point=4, seed=11, dtype=dt,
                                        device="cuda")[0]
             for dt in (torch.float32, torch.float64)}
    cases = [("schur_pcg", problem, 10), ("schur_sparse", problem, 10),
             ("dense", small[torch.float32], 8), ("dense", small[torch.float64], 8),
             ("schur_dense", small[torch.float32], 8)]
    for tier, prob, iters in cases:
        cfg = LMConfig(linear_solver=tier, **dict(golden_cfg, max_iters=iters))
        _lib.reset_launches()
        t0 = time.perf_counter()
        a = solve(prob, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = {k: v for k, v in _lib.launches.items() if v}
        b = solve(prob, cfg)
        same = all(torch.equal(x, y) for x, y in ((a.cameras, b.cameras), (a.points, b.points),
                                                   (a.cost, b.cost),
                                                   (a.cg_history, b.cg_history)))
        say("repeat", f"{tier} {str(prob.cameras.dtype)[6:]}, {prob.n_cameras} cameras, {iters} "
                      f"iterations: cost {a.cost.item():.9g} twice, bits equal {same}; launches "
                      f"{launched}; {first_s:.3f} s")
        if not same or set(launched) != {"segsum"}:
            raise AssertionError(f"repeat {tier}: the second solve differs ({same}) or the "
                                 f"launches are not K1's alone: {launched}")


def phase_bench(kind):
    """The benchmark harness on the card, each run a subprocess: ``python -m
    tpu_ba_torch.cli bench`` (the headline: ladybug-1723 through
    schur_sparse_pallas at the golden's config) and the trafalgar-257 golden's
    config through ``python -m tpu_ba_torch.bench.harness``. Each must exit 0
    and print its line under a ``_1gpu`` metric; its detail must name this
    card, stay within 1% of the f64 golden, hold a roofline share in
    (0, 1.05], a peak of device memory above 0 and the CPU baseline; the
    headline must launch K1–K7."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        for i, (name, cmd, metric, kernels) in enumerate(BENCH_RUNS):
            detail_path = os.path.join(tmp, f"detail{i}.json")
            cmd = [sys.executable, "-m", *cmd, "--detail-out", detail_path]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
            wall_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
            line = proc.stdout.strip().splitlines()[-1]
            say("bench", f"{name}: {line}")
            out = json.loads(line)
            with open(detail_path) as fh:
                d = json.load(fh)
            if not (out["metric"] == metric and out["value"] > 0 and d["device"] == kind):
                raise AssertionError(f"{name}: the line {out} or the device {d['device']} is "
                                     f"not this card's ({kind})")
            gap = d["f64_parity"]["final_cost_gap_pct"]
            if not abs(gap) < 1.0:
                raise AssertionError(f"{name}: final cost {gap}% from the golden (limit 1%)")
            launched = {k for k, v in d["launches"].items() if v}
            if not kernels <= launched:
                raise AssertionError(f"{name}: launched {sorted(launched)}, the path's kernels "
                                     f"are {sorted(kernels)}")
            roof, mem, bl = d["roofline"], d["device_memory"], d["baseline"]
            if not 0.0 < roof["share_of_peak"] <= 1.05:
                raise AssertionError(f"{name}: roofline share {roof['share_of_peak']} outside "
                                     f"(0, 1.05]")
            unbilled = [k for k in launched if not roof["bytes_by_kernel"][k] > 0]
            if unbilled:
                raise AssertionError(f"{name}: launched {unbilled} with no bytes counted")
            if not (mem["max_memory_allocated"] > 0 and bl is not None
                    and out["vs_baseline"] > 0):
                raise AssertionError(f"{name}: peak memory {mem}, baseline {bl}")
            say("bench", f"{name}: {d['lm_iters']} LM iterations ({d['lm_accepted']} accepted), "
                         f"cg_total {d['cg_total']}, {d['iters_per_sec']:.3f} LM it/s (best of 3, "
                         f"{d['run_s']:.4f} s; first call {d['first_call_s']:.3f} s, build "
                         f"{d['build_s']:.3f} s); gap {gap:+.6f}% from the f64 golden; roofline "
                         f"share {roof['share_of_peak']:.4f} ({roof['bytes_total']} bytes over "
                         f"{roof['peak_gbps']:g} GB/s) at {d['power_limit_w']} W; peak "
                         f"{mem['max_memory_allocated'] / 2**20:.1f} MiB allocated; launches "
                         f"{d['launches']}; PCG forms {d['pcg_forms']}; bytes by kernel "
                         f"{roof['bytes_by_kernel']}; host reads {d['host_reads']}; baseline "
                         f"{bl['sec_per_iter']:.3f} s an iteration ({bl['iters_run']} run), "
                         f"vs_baseline {d['vs_baseline_speedup']:.1f}; {wall_s:.3f} s the whole "
                         f"process")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def np_equal(a, t):
    """A host array equal, in dtype, shape and values, to a tensor."""
    b = t.detach().cpu().numpy()
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    from tpu_ba_torch.bench import roofline
    from tpu_ba_torch.core import LMConfig, make_problem
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.io.synthetic import make_synthetic_problem
    from tpu_ba_torch.jacobians.analytic import jacobian_blocks_bal
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.kernels.linearize import (fused_cost, fused_cost_plain,
                                                fused_linearize_assemble,
                                                fused_linearize_assemble_plain)
    from tpu_ba_torch.kernels.pairblocks import fused_pair_blocks, fused_pair_blocks_plain
    from tpu_ba_torch.kernels import pcg_band as pcg_band_mod
    from tpu_ba_torch.kernels.pcg_band import (band_l2_bytes, exchange_floor, fold_damp_prologue,
                                               pcg_banded, pcg_banded_plain, resident_cams)
    from tpu_ba_torch.kernels.segsum import (fill_threads, group_log2, sorted_segment_sum_t,
                                             sorted_segment_sum_t_plain)
    from tpu_ba_torch.kernels.slotband import slot_band_blocks, slot_band_blocks_plain
    from tpu_ba_torch.kernels.trackband import fused_track_blocks, fused_track_blocks_plain
    from tpu_ba_torch.residuals.robust import ROBUST_KINDS
    from tpu_ba_torch.solver import pairs as pairs_mod
    from tpu_ba_torch.solver import pcg as pcg_mod
    from tpu_ba_torch.solver.batched_linalg import inv_spd_small
    from tpu_ba_torch.solver.dense import solve_dense
    from tpu_ba_torch.solver.lm import build_solver_plans, solve
    from tpu_ba_torch.solver.normal import BlockSystem, assemble, damp_blocks
    from tpu_ba_torch.solver.plans import build_plans, pt_segsum_t
    from tpu_ba_torch.solver.schur import inv3x3_rows, schur_rhs
    from tpu_ba_torch.solver.tridiag import pcr_factor, tridiag_from_band

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    import scipy

    say("device", f"{kind}; {count} visible; torch {torch.__version__}, CUDA {torch.version.cuda}"
                  f", scipy {scipy.__version__}")
    print(smi.stdout.strip(), flush=True)

    # 2. build
    t0 = time.perf_counter()
    _lib.build_library()
    _lib.load_library()
    say("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
                 f"({_lib.library_path().name})")

    # 3. kernels against their plain versions, at the main path's shapes
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    problem, _ = make_bal_like_problem(PROBLEM, dtype=torch.float32, device=dev)
    plans = build_plans(problem.cam_idx, problem.pt_idx, problem.n_cameras, problem.n_points)
    torch.cuda.synchronize()
    C, P, O = problem.n_cameras, problem.n_points, problem.obs_2d.shape[0]
    say("data", f"{PROBLEM} ring stand-in: {C} cameras, {P} points, {problem.n_obs} observations "
                f"padded to {O}; made and planned in {time.perf_counter() - t0:.1f} s")
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    golden_cfg = dict(max_iters=golden["max_iters"], cg_max_iters=golden["cg_max_iters"],
                      cg_tol=golden["cg_tol"], init_lambda=1e-4)
    cfg_floor, cfg_ceil = LMConfig().diag_floor, LMConfig().diag_ceil
    args32 = (problem.cameras, problem.points, problem.obs_2d, problem.cam_idx,
              problem.pt_idx, problem.mask)
    args64 = (problem.cameras.double(), problem.points.double(), problem.obs_2d.double(),
              problem.cam_idx, problem.pt_idx, problem.mask)
    results = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None} for k in TOL}

    def set_bound(name, counts):
        """The kernel's bound from its (bytes, operations) (``bench/roofline.py``)."""
        results[name]["bound_ms"], results[name]["bound_by"] = roofline.bound(*counts)

    def record(name, abs_err, rel_err, what, tol=None):
        tol = TOL[name] if tol is None else tol
        if not rel_err <= tol:
            raise AssertionError(f"{name} {what}: relative error {rel_err:.3e} > {tol:.0e}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
        results[name]["max_rel_err"] = max(results[name]["max_rel_err"], rel_err)

    # K1. Device times from replayed CUDA graphs over copies of the values
    # that rotate through more than twice the L2 (ms: each call reads its
    # values from device memory, as in a solve, and that is what the bound
    # assumes); ms_l2: the same on one copy, which the replays find in L2
    # where it fits; ms_eager: one call launched from Python between two
    # events, which for these sizes is the host's pace. Yardsticks, on the
    # same clocks: scatter_add_ into a cleared output (for a call through
    # perm: by the unsorted keys on the ungathered values, the one PyTorch
    # call for the same function) and, through perm, the earlier route (an
    # index gather into sorted order, then the kernel on the copy).
    K1_MARGIN = 1.05     # the kernel may read this much above its yardstick (noise) and pass

    def k1_case(what, tag, vals, keys, n_out, starts, longest, perm=None, unsorted_keys=None):
        D, n_obs = vals.shape
        kw1 = dict(longest=longest) if perm is None else dict(longest=longest, perm=perm)
        out = sorted_segment_sum_t(vals, keys, n_out, starts, **kw1)
        ref = sorted_segment_sum_t_plain(vals.double(), keys, n_out, perm=perm)
        a, r = err(out, ref)
        record("segsum", a, r, what)
        again = sorted_segment_sum_t(vals, keys, n_out, starts, **kw1)
        if not torch.equal(out, again):
            raise AssertionError(f"K1 {what}: two runs differ")
        del out, ref, again
        sets = value_copies(vals)
        lib_out = torch.empty((D, n_out), device=dev)
        lib_idx = (keys if perm is None else unsorted_keys).long().expand(D, n_obs)

        def kernel(v):
            return sorted_segment_sum_t(v, keys, n_out, starts, **kw1)

        def plain(v):
            return sorted_segment_sum_t_plain(v, keys, n_out, perm=perm)

        def lib(v):
            return lib_out.zero_().scatter_add_(1, lib_idx, v)

        fig = {"max_rel_err": r}
        for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", lib)):
            fig[key] = device_ms(torch, [lambda v=v: fn(v) for v in sets])
            fig[key.replace("ms", "ms_l2")] = device_ms(torch, lambda: fn(vals))
        fig["ms_eager"] = median_ms(torch, lambda: kernel(vals))
        line = ""
        if perm is not None:
            perm64 = perm.long()

            def old_route(v):
                return sorted_segment_sum_t(v[:, perm64], keys, n_out, starts, longest=longest)

            fig["index_then_kernel_ms"] = device_ms(torch, [lambda v=v: old_route(v)
                                                            for v in sets])
            line = f", index then K1 {fig['index_then_kernel_ms']:.4f} ms"
        sched = group_log2(n_obs, n_out, D, longest, fill_threads(dev), perm is not None)
        fig["bound_ms"], b_by = roofline.bound(*roofline.segsum_counts(D, n_obs, n_out, perm is not None))
        say("kernel", f"K1 segsum {what}: rel err {r:.2e} (tol {TOL['segsum']:.0e}), abs {a:.2e}; "
                      f"{fig['ms']:.4f} ms over {len(sets)} rotating copies ({fig['ms_l2']:.4f} "
                      f"from L2, {fig['ms_eager']:.4f} launched call by call from Python), "
                      f"plain {fig['plain_ms']:.4f} ms{line}, scatter_add_"
                      f"{' by the unsorted keys' if perm is not None else ''} "
                      f"{fig['library_ms']:.4f} ms ({fig['library_ms_l2']:.4f} from L2), bound "
                      f"{fig['bound_ms']:.4f} ms ({b_by}); schedule "
                      f"{sched}")
        for clock in ("ms", "ms_l2"):
            lib_key = clock.replace("ms", "library_ms")
            if not fig[clock] <= K1_MARGIN * fig[lib_key]:
                raise AssertionError(f"K1 {what}: {fig[clock]:.4f} ms ({clock}) is slower than "
                                     f"scatter_add_'s {fig[lib_key]:.4f} ms")
        results["segsum"].setdefault("by_shape", {})[tag] = fig
        return fig

    # the payloads of the main path: point-keyed (12 = VtV|gp per
    # linearization, 3 = matvec / back-substitution), as the solver calls them
    # (the values in camera-sorted order, gathered through perm_pt) and on
    # sorted values; camera-keyed (9 = matvec / rhs, 81 = preconditioner blocks)
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_main = []
    for D in (12, 3):
        vals = torch.randn((D, O), generator=gen, device=dev, dtype=torch.float32)
        k1_case(f"({D},{O})->{P} point-keyed, sorted values", f"({D},O)->point", vals,
                plans.pt_sorted_keys, P, plans.pt_start, plans.pt_longest)
        fig = k1_case(f"({D},{O})->{P} point-keyed through perm (one kernel)",
                      f"({D},O)->point, perm", vals, plans.pt_sorted_keys, P, plans.pt_start,
                      plans.pt_longest, perm=plans.perm_pt, unsorted_keys=problem.pt_idx)
        if D == 3:
            k1_main.append(fig)
    for D in (9, 81):
        vals = torch.randn((D, O), generator=gen, device=dev, dtype=torch.float32)
        fig = k1_case(f"({D},{O})->{C} camera-keyed", f"({D},O)->camera", vals, problem.cam_idx, C,
                      plans.cam_start, plans.cam_longest)
        if D == 9:
            k1_main.append(fig)
    del vals
    # one CG iteration of the matrix-free matvec, and one back-substitution
    # and rhs of the main path: (3, O) by point through perm, (9, O) by camera
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        results["segsum"][key] = sum(f[key] for f in k1_main)
    # an empty segment comes out exactly 0
    keys = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 2, 2, 5, 5, 5, 6], dtype=torch.int32, device=dev)
    out = sorted_segment_sum_t(torch.ones((2, 6), device=dev), keys, 6, starts)
    assert out.cpu().tolist() == [[2, 0, 3, 0, 0, 1]] * 2, out

    lsched = plans.lin_sched
    say("kernel", f"K2/K3 schedule: {describe_lin_schedule(lsched)}")
    for rname, rk in ROBUST_KINDS.items():
        kw = dict(robust_kind=rk, robust_scale=ROBUST_SCALE)
        ref = fused_linearize_assemble_plain(*args64, **kw)

        def k2_errs(out):
            parts = {"U": 0, "gc": 1, "W": 2}
            e = {k: err(out[i], ref[i]) for k, i in parts.items()}
            for k, rows in {"VtV": slice(0, 9), "gp": slice(9, 12), "rho": 12}.items():
                e[k] = err(out[3][rows], ref[3][rows])
            return e

        out = fused_linearize_assemble(*args32, plans.cam_start, sched=lsched, **kw)
        again = fused_linearize_assemble(*args32, plans.cam_start, sched=lsched, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"K2 {rname}: two calls differ")
        errs = k2_errs(out)
        del out, again
        plain_errs = k2_errs(fused_linearize_assemble_plain(*args32, **kw))
        worst = max(errs, key=lambda k: errs[k][1])
        k2_tol = TOL_LINEARIZE_NO_LOSS if rk == 0 else TOL["linearize"]
        for k, (a, r) in errs.items():
            record("linearize", a, r, f"{rname} {k}", k2_tol)
        cref = fused_cost_plain(*args64, **kw).item()
        cost = fused_cost(*args32, sched=lsched, **kw)
        if not torch.equal(cost, fused_cost(*args32, sched=lsched, **kw)):
            raise AssertionError(f"K3 {rname}: two calls differ")
        ca = abs(cost.item() - cref)
        pa = abs(fused_cost_plain(*args32, **kw).item() - cref)
        record("cost", ca, ca / abs(cref), rname)
        line = (f"K2 linearize {rname}: worst rel err {errs[worst][1]:.2e} ({worst}; plain f32 "
                f"{max(v[1] for v in plain_errs.values()):.2e}; tol {k2_tol:.0e}); "
                f"K3 cost {rname}: rel err {ca / abs(cref):.2e} (plain f32 {pa / abs(cref):.2e};"
                f" tol {TOL['cost']:.0e})")
        if rname == "none":
            # device time as in a solve: replayed CUDA graphs over copies of
            # points and observations rotating through twice the L2 (ms),
            # and on one copy (ms_l2)
            sets = input_copies((problem.points, problem.obs_2d))
            rest = (problem.cam_idx, problem.pt_idx, problem.mask)
            for name, fn in (
                    ("linearize", lambda pts, obs: fused_linearize_assemble(
                        problem.cameras, pts, obs, *rest, plans.cam_start, sched=lsched, **kw)),
                    ("cost", lambda pts, obs: fused_cost(problem.cameras, pts, obs, *rest,
                                                         sched=lsched, **kw))):
                results[name]["ms"] = device_ms(torch, [lambda s=s, fn=fn: fn(*s) for s in sets])
                results[name]["ms_l2"] = device_ms(torch, lambda fn=fn: fn(*sets[0]))
            del sets
            results["linearize"]["plain_ms"] = median_ms(
                torch, lambda: fused_linearize_assemble_plain(*args32, **kw), reps=5)
            results["cost"]["plain_ms"] = median_ms(
                torch, lambda: fused_cost_plain(*args32, **kw), reps=5)
            k2_counts, k3_counts = roofline.lin_counts(C, P, O, lsched)
            set_bound("linearize", k2_counts)
            set_bound("cost", k3_counts)
            r2, r3 = results["linearize"], results["cost"]
            line += (f"; K2 {r2['ms']:.4f} ms ({r2['ms_l2']:.4f} from L2), plain "
                     f"{r2['plain_ms']:.4f} ms, bound {r2['bound_ms']:.4f} ms; K3 "
                     f"{r3['ms']:.4f} ms ({r3['ms_l2']:.4f} from L2), plain "
                     f"{r3['plain_ms']:.4f} ms, bound {r3['bound_ms']:.4f} ms (what it reads: "
                     f"no camera index)")
        say("kernel", line)
    del ref, args64

    # the sparse tier's kernels, on the linearization the solve starts from
    # (K2's outputs at the initial parameters) and the port's own pair plan
    t0 = time.perf_counter()
    plan = pairs_mod.build_pair_plan(problem.cam_idx, problem.pt_idx, problem.n_obs, C, P,
                                     with_kernel_plans=True, symmetric=True)
    tl, sl = plan.track, plan.slot
    got = {"band_offsets": plan.band_offsets, "c_pad": plan.c_pad, "k_band": plan.k_band,
           "n_segments": plan.n_segments, "k_pad": plan.k_pad, "n_pairs": plan.n_pairs,
           "n_heavy_pts": plan.n_heavy_pts,
           "track_dmax": tl and tl.dmax, "track_n_tracked": tl and tl.n_tracked,
           "track_pt_pad": tl and tl.pt_pad, "slot_degrees": sl and sl.degrees,
           "slot_tiles": sl and sl.tiles, "slot_widths": sl and sl.widths,
           "slot_n_tracked": sl and sl.n_tracked, "slot_pt_pad": sl and sl.pt_pad,
           "slot_l2_len": sl and sl.l2_len}
    say("plan", f"pair plan built in {time.perf_counter() - t0:.1f} s: {len(plan.band_offsets)} "
                f"band offsets {plan.band_offsets}, c_pad {plan.c_pad}, k_band {plan.k_band} = "
                f"n_segments {plan.n_segments} (fully banded), k_pad {plan.k_pad}; tracks dmax "
                f"{got['track_dmax']}, {got['track_n_tracked']} points (pt_pad "
                f"{got['track_pt_pad']}); slots degrees {got['slot_degrees']}, tiles "
                f"{got['slot_tiles']}, widths {got['slot_widths']}, {got['slot_n_tracked']} points"
                f" (pt_pad {got['slot_pt_pad']}, l2_len {got['slot_l2_len']}, spans {sl.spans}, "
                f"{[int(i.numel()) for i in sl.inc]} incidences); {plan.n_pairs} "
                f"padded pairs; PCG working set {band_l2_bytes(plan) / 2**20:.2f} MiB")
    say("plan", f"K7 schedule: {describe_schedule(plan.pair_sched)}")
    if got != EXPECTED_PLAN:
        diff = {k: (got[k], EXPECTED_PLAN[k]) for k in got if got[k] != EXPECTED_PLAN[k]}
        raise AssertionError(f"pair plan differs from the reference's (got, expected): {diff}")
    plain_plan = dataclasses.replace(
        plan, seg_start=None, pair_sched=None, track=dataclasses.replace(tl, key_start=None),
        slot=dataclasses.replace(sl, inc_start=None, inc=None))

    def linearize(prob, pl):
        """The BlockSystem of ``prob`` at its initial parameters, through K2 and K1."""
        U, gc, W, pt_vals = fused_linearize_assemble(
            prob.cameras, prob.points, prob.obs_2d, prob.cam_idx, prob.pt_idx, prob.mask,
            pl.cam_start, sched=pl.lin_sched)
        ptp = pt_segsum_t(pl, pt_vals[:12], prob.pt_idx, prob.n_points)
        return BlockSystem(U=U, V=ptp[:9], W=W, gc=gc, gp=ptp[9:12],
                           cost=0.5 * torch.sum(pt_vals[12]), cam_idx=prob.cam_idx,
                           pt_idx=prob.pt_idx)

    def f64(Bs):
        return Bs._replace(U=Bs.U.double(), V=Bs.V.double(), W=Bs.W.double(), gc=Bs.gc.double(),
                           gp=Bs.gp.double())

    B = linearize(problem, plans)
    B64 = f64(B)
    pd = pairs_mod.precompute_pair_data(B, plan)
    pd64 = pairs_mod.precompute_pair_data(B64, plan)
    kw = dict(dc=9, diag_floor=cfg_floor, diag_ceil=cfg_ceil)
    band_calls = {
        "pairblocks": (
            lambda d, l, p: fused_pair_blocks(d.packed, p.pair_seg, l, p.k_pad, p.pair_sched,
                                              **kw),
            lambda d, l, p: fused_pair_blocks_plain(d.packed, p.pair_seg, l, p.k_pad, **kw)),
        "trackband": (
            lambda d, l, p: fused_track_blocks(d.trk_W, d.trk_V, l, p.track, **kw),
            lambda d, l, p: fused_track_blocks_plain(d.trk_W, d.trk_V, l, p.track, **kw)),
        "slotband": (
            lambda d, l, p: slot_band_blocks(d.slot_W, d.slot_V, l, p.slot, **kw),
            lambda d, l, p: slot_band_blocks_plain(d.slot_W, d.slot_V, l, p.slot, **kw)),
        "blk": (
            lambda d, l, p: pairs_mod._compact_blocks(B, l, p, d, cfg_floor, cfg_ceil),
            lambda d, l, p: pairs_mod._compact_blocks(B if d is pd else B64, l, plain_plan, d,
                                                      cfg_floor, cfg_ceil)),
    }
    for lam in (1e-4, 1.0):
        lam32 = torch.tensor(lam, device=dev)
        lam64 = lam32.double()
        for name, (kernel_fn, plain_fn) in band_calls.items():
            out = kernel_fn(pd, lam32, plan)
            if not torch.equal(out, kernel_fn(pd, lam32, plan)):
                raise AssertionError(f"{name} at lam {lam:g}: two runs differ")
            ref = plain_fn(pd64, lam64, plan)
            plain = plain_fn(pd, lam32, plan)
            if name == "pairblocks":    # the padding pairs' trash segment: zero from the kernel
                if out[:, -1].abs().max().item() != 0.0:
                    raise AssertionError("K7 wrote into the trash segment of the padding pairs")
                ref[:, -1] = 0.0
                plain[:, -1] = 0.0
            # cells nothing reaches are exact zeros
            if not bool(torch.all(out[ref == 0] == 0)):
                raise AssertionError(f"{name}: a cell that no pair reaches is not exactly 0")
            # one row per (block entry, band offset); the columns behind the
            # band grid hold nothing (checked exactly above)
            if name in ("pairblocks", "blk"):
                out, ref, plain = (t[:, :plan.k_band] for t in (out, ref, plain))
            a, r = err_rows(out, ref, plan.c_pad)
            _, pr = err_rows(plain, ref, plan.c_pad)
            _, whole = err(out, ref)
            tol = max(1e-5, BAND_PLAIN_FACTOR * pr)
            if name != "blk":
                record(name, a, r, f"lam {lam:g}", tol)
            elif not r <= tol:
                raise AssertionError(f"assembled band at lam {lam:g}: {r:.3e} > {tol:.3e}")
            say("kernel", f"{name} lam {lam:g}: worst (entry, offset) row rel err {r:.2e} (plain "
                          f"f32 {pr:.2e}; tol {tol:.1e} = max(1e-5, {BAND_PLAIN_FACTOR:g} x "
                          f"plain)), abs {a:.2e}; over the whole output {whole:.2e}")
            del out, ref, plain
    lam32 = torch.tensor(1e-4, device=dev)
    for name in ("pairblocks", "trackband", "slotband"):
        kernel_fn, plain_fn = band_calls[name]
        results[name]["plain_ms"] = median_ms(torch, lambda: plain_fn(pd, lam32, plan), reps=5)
    # K7, and K5 and K6 as the band build calls them, adding into the band
    # under assembly, on K1's clock (replayed CUDA graphs; ms: over copies of
    # packed or W that rotate through twice the L2, ms_l2: on one copy), and
    # the band build as a whole (K7, then K5 and K6 adding into the band)
    # launched from Python
    k7_fn = band_calls["pairblocks"][0]
    packed_sets = value_copies(pd.packed)
    results["pairblocks"]["ms"] = device_ms(
        torch, [lambda pk=pk: k7_fn(pd._replace(packed=pk), lam32, plan) for pk in packed_sets])
    results["pairblocks"]["ms_l2"] = device_ms(torch, lambda: k7_fn(pd, lam32, plan))
    n_packed = len(packed_sets)
    del packed_sets
    band_buf = torch.zeros((81, plan.k_pad), device=dev)
    w_sets = [[w.clone() for w in pd.slot_W]
              for _ in range(len(value_copies(pd.slot_W[0])) - 1)] + [pd.slot_W]
    tw_sets = value_copies(pd.trk_W)

    def k6_into_band(ws):
        return slot_band_blocks(ws, pd.slot_V, lam32, sl, out=band_buf, **kw)

    def k5_into_band(tw):
        return fused_track_blocks(tw, pd.trk_V, lam32, tl, out=band_buf, **kw)

    results["slotband"]["ms"] = device_ms(torch, [lambda ws=ws: k6_into_band(ws) for ws in w_sets])
    results["slotband"]["ms_l2"] = device_ms(torch, lambda: k6_into_band(pd.slot_W))
    results["trackband"]["ms"] = device_ms(torch, [lambda tw=tw: k5_into_band(tw)
                                                   for tw in tw_sets])
    results["trackband"]["ms_l2"] = device_ms(torch, lambda: k5_into_band(pd.trk_W))
    build_ms = median_ms(torch, lambda: band_calls["blk"][0](pd, lam32, plan))
    say("kernel", f"K7 over {n_packed} copies of packed "
                  f"{results['pairblocks']['ms']:.4f} ms ({results['pairblocks']['ms_l2']:.4f} "
                  f"from L2); adding into a given band: K5 over {len(tw_sets)} copies of W "
                  f"{results['trackband']['ms']:.4f} ms ({results['trackband']['ms_l2']:.4f} "
                  f"from L2), K6 over {len(w_sets)} copies {results['slotband']['ms']:.4f} ms "
                  f"({results['slotband']['ms_l2']:.4f} from L2); the whole band build (K7, "
                  f"then K5 and K6 adding into the band): {build_ms:.4f} ms")
    del band_buf, w_sets, tw_sets
    set_bound("pairblocks", roofline.pairblocks_counts(plan))
    set_bound("trackband", roofline.trackband_counts(plan))
    set_bound("slotband", roofline.slotband_counts(plan))
    for name, k in (("pairblocks", "K7"), ("trackband", "K5"), ("slotband", "K6")):
        say("kernel", f"{k} {name}: {results[name]['ms']:.4f} ms, plain "
                      f"{results[name]['plain_ms']:.4f} ms, bound {results[name]['bound_ms']:.4f} "
                      f"ms ({results[name]['bound_by']})")

    # K4 on that band and the real right-hand side. At the golden's first λ
    # (1e-4) the f32 system of the first linearization is not positive
    # definite and PCG breaks down, in the kernel as in the plain version (the
    # LM loop rejects such a step and raises λ); at λ = 1 it converges.
    gtol, gmax = golden_cfg["cg_tol"], golden_cfg["cg_max_iters"]
    k4 = {}
    for lam in (1e-4, 1.0):
        lam32 = torch.tensor(lam, device=dev)
        blk = pairs_mod._compact_blocks(B, lam32, plan, pd, cfg_floor, cfg_ceil)
        _, Vl = damp_blocks(B, lam32, cfg_floor, cfg_ceil)
        rhs = schur_rhs(B, inv3x3_rows(Vl), plans).contiguous()
        pkw = dict(U_t=pd.U_t, lam=lam32, diag_floor=cfg_floor, diag_ceil=cfg_ceil)
        pkw64 = dict(pkw, U_t=pd.U_t.double(), lam=lam32.double())
        blk64, rhs64 = blk.double(), rhs.double()
        x5, k5, ok5 = pcg_banded(blk, None, None, rhs, plan, max_iters=5, tol=0.0, **pkw)
        x5p, k5p, ok5p = pcg_banded_plain(blk, None, None, rhs, plan, max_iters=5, tol=0.0, **pkw)
        x5r, _, _ = pcg_banded_plain(blk64, None, None, rhs64, plan, max_iters=5, tol=0.0, **pkw64)
        a, r = err_rows(x5.T.contiguous(), x5r.T.contiguous(), C)
        _, plain5 = err_rows(x5p.T.contiguous(), x5r.T.contiguous(), C)
        tol5 = max(TOL["pcg_band"], BAND_PLAIN_FACTOR * plain5)
        if not (int(k5) == int(k5p) == 5 and bool(ok5) and bool(ok5p)):
            raise AssertionError(f"K4 fixed run at lam {lam:g}: {int(k5)} / {int(k5p)} "
                                 f"iterations, ok {bool(ok5)}")
        record("pcg_band", a, r, f"lam {lam:g}, 5 fixed iterations", tol5)
        # the kernel's streaming form (bands that do not fit the shared
        # memory of the card at once) on the same system: the same checks
        x5s, k5s, ok5s = pcg_banded(blk, None, None, rhs, plan, max_iters=5, tol=0.0,
                                    resident=False, **pkw)
        a_s, r_s = err_rows(x5s.T.contiguous(), x5r.T.contiguous(), C)
        if not (int(k5s) == 5 and bool(ok5s)):
            raise AssertionError(f"K4 streaming, fixed run at lam {lam:g}: {int(k5s)} iterations")
        record("pcg_band", a_s, r_s, f"lam {lam:g}, 5 fixed iterations, streaming form", tol5)
        say("kernel", f"K4 pcg_band lam {lam:g}, streaming form: 5 fixed iterations, worst "
                      f"column of x rel err {r_s:.2e} (resident form {r:.2e}; tol {tol5:.1e})")
        # to the golden's tolerance with room to converge
        budget = 5 * gmax
        xg, kg, okg = pcg_banded(blk, None, None, rhs, plan, max_iters=budget, tol=gtol, **pkw)
        xgp, kgp, okgp = pcg_banded_plain(blk, None, None, rhs, plan, max_iters=budget, tol=gtol,
                                          **pkw)
        Ul64, _ = fold_damp_prologue(blk64, pkw64["U_t"], pkw64["lam"], C, 9, cfg_floor, cfg_ceil)
        mv64 = pairs_mod.make_banded_matvec(blk64, Ul64, plan, 9)
        true_res = ((rhs64 - mv64(xg.double())).norm() / rhs64.norm()).item()
        true_res_p = ((rhs64 - mv64(xgp.double())).norm() / rhs64.norm()).item()
        kg, kgp, okg, okgp = int(kg), int(kgp), bool(okg), bool(okgp)
        say("kernel", f"K4 pcg_band lam {lam:g}: 5 fixed iterations, worst column of x rel err "
                      f"{r:.2e} (plain f32 "
                      f"{plain5:.2e}; tol {tol5:.1e}); at tol {gtol:g}, budget {budget}: {kg} "
                      f"iterations (plain {kgp}), ok {okg} (plain {okgp}), true residual in f64 "
                      f"{true_res:.3e} (plain {true_res_p:.3e})")
        if okg != okgp or abs(kg - kgp) > 2:
            raise AssertionError(f"K4 at lam {lam:g}, tol {gtol}: {kg} iterations ok {okg}, plain "
                                 f"{kgp} ok {okgp}")
        if okg and kg < budget and not true_res <= 2 * gtol:
            raise AssertionError(f"K4 at lam {lam:g} stopped at {kg} iterations with a true "
                                 f"residual of {true_res}")
        k4[lam] = (okg, kg)
    if not (k4[1.0][0] and k4[1.0][1] < budget):
        raise AssertionError(f"K4 did not converge at lam 1 within {budget} iterations: {k4[1.0]}")

    # times at λ = 1 with the golden's budget, as the solve calls it
    def k4_call(**kw):
        return pcg_banded(blk, None, None, rhs, plan, **dict(pkw, **kw))

    def pcg_times(call):
        """(ms a CG iteration, ms for 5, ms for 55, ms to the golden's
        tolerance, iterations) of a PCG kernel call in both of its forms:
        {"resident": ..., "streaming": ...}; each form must take the same
        number of iterations to the tolerance, within 2."""
        out = {}
        for form_name, resident in (("resident", True), ("streaming", False)):
            lo = median_ms(torch, lambda: call(max_iters=5, tol=0.0, resident=resident))
            hi = median_ms(torch, lambda: call(max_iters=55, tol=0.0, resident=resident))
            n_it = int(call(max_iters=gmax, tol=gtol, resident=resident)[1])
            whole = median_ms(torch, lambda: call(max_iters=gmax, tol=gtol, resident=resident))
            out[form_name] = ((hi - lo) / 50.0, lo, hi, whole, n_it)
        if abs(out["resident"][4] - out["streaming"][4]) > 2:
            raise AssertionError(f"the PCG kernel's forms take {out['resident'][4]} and "
                                 f"{out['streaming'][4]} iterations on one system")
        return out

    # the resident form is the one the wrapper picks for this band
    form_cams = resident_cams(0, plan.band_offsets, C, dev)
    if form_cams != 16:
        raise AssertionError(f"the {PROBLEM} band does not fit the resident form at 16 cameras a "
                             f"group: resident_cams = {form_cams}")
    pcg_band_mod.reset_form_launches()
    k4_call(max_iters=5, tol=0.0)
    if pcg_band_mod.form_launches != {"resident": 1, "streaming": 0}:
        raise AssertionError(f"K4 by default: {pcg_band_mod.form_launches}")
    k4_t = pcg_times(k4_call)
    per_iter_ms, t_lo, t_hi, results["pcg_band"]["ms"], kt = k4_t["resident"]
    per_iter_str, s_lo, s_hi, results["pcg_band"]["ms_streaming"], _ = k4_t["streaming"]
    if not per_iter_ms < per_iter_str:
        raise AssertionError(f"K4: the resident form takes {per_iter_ms:.5f} ms a CG iteration, "
                             f"the streaming form {per_iter_str:.5f}: the solves launch the slower")
    # the floor of an iteration of the resident form: its two device-wide
    # exchanges of partial sums (grid.sync() and a re-summation from L2) and
    # nothing else, on the same grid with the same shared memory
    n_ex = 2000
    n_groups = -(-C // form_cams)
    got_sum = float(exchange_floor(0, plan.band_offsets, C, n_ex, dev))
    if got_sum != float(n_ex * n_groups):
        raise AssertionError(f"exchange floor: the {n_ex} exchanges of {n_groups} blocks "
                             f"summed to {got_sum}")
    ex0 = median_ms(torch, lambda: exchange_floor(0, plan.band_offsets, C, 0, dev))
    ex_ms = (median_ms(torch, lambda: exchange_floor(0, plan.band_offsets, C, n_ex, dev))
             - ex0) / n_ex
    results["pcg_band"]["floor_ms_per_cg_iteration"] = 2 * ex_ms
    results["pcg_band"]["exchange_ms"] = ex_ms
    reads0 = pcg_mod.host_reads["cg"]
    results["pcg_band"]["plain_ms"] = median_ms(
        torch, lambda: pcg_banded_plain(blk, None, None, rhs, plan, max_iters=gmax, tol=gtol,
                                        **pkw), reps=3, warmup=1)
    pcg_mod.host_reads["cg"] = reads0
    set_bound("pcg_band", roofline.pcg_band_counts(plan, kt))
    results["pcg_band"]["iterations"] = kt
    results["pcg_band"]["ms_per_cg_iteration"] = per_iter_ms
    results["pcg_band"]["ms_per_cg_iteration_streaming"] = per_iter_str
    say("kernel", f"K4 pcg_band lam 1, tol {gtol:g}, budget {gmax}, resident form ({n_groups} "
                  f"blocks of {form_cams} cameras): {results['pcg_band']['ms']:.4f}"
                  f" ms for {kt} iterations, {per_iter_ms:.5f} ms a CG iteration ({t_lo:.4f} ms "
                  f"for 5, {t_hi:.4f} ms for 55); streaming form "
                  f"{results['pcg_band']['ms_streaming']:.4f} ms, {per_iter_str:.5f} ms a CG "
                  f"iteration ({s_lo:.4f} ms for 5, {s_hi:.4f} ms for 55); plain "
                  f"{results['pcg_band']['plain_ms']:.3f} ms, "
                  f"bound {results['pcg_band']['bound_ms']:.4f} ms "
                  f"({results['pcg_band']['bound_by']})")
    say("kernel", f"K4 floor of an iteration's synchronisation on this grid: {2 * ex_ms:.5f} ms "
                  f"(two exchanges of partial sums at {ex_ms:.5f} ms each, three of them, the "
                  f"streaming form's, {3 * ex_ms:.5f} ms)")
    del pd64, blk, blk64, mv64, Ul64

    # K8 on the same band: Ul, M⁻¹ and the PCR factors as solve_schur_sparse
    # makes them per retry
    def given_system(Bs, pl, pdata, pls, lam):
        lam32 = torch.tensor(lam, device=dev)
        blk = pairs_mod._compact_blocks(Bs, lam32, pl, pdata, cfg_floor, cfg_ceil)
        Ul, Vl = damp_blocks(Bs, lam32, cfg_floor, cfg_ceil)
        rhs = schur_rhs(Bs, inv3x3_rows(Vl), pls).contiguous()
        n = pl.n_cameras
        diag_S = Ul - blk[:, :n].reshape(9, 9, n).permute(2, 0, 1)
        return dict(lam=lam32, blk=blk, Ul=Ul, Minv=inv_spd_small(diag_S), rhs=rhs,
                    tri=tridiag_from_band(blk, diag_S, pl, 9))

    def check_tridiag_kernel(sysd, pl, what, counter="pcg_band_given"):
        """K8 with the PCR preconditioner against its plain version: 5 fixed
        iterations against f64, then to the golden's tolerance."""
        blk, Ul, rhs, pcr = sysd["blk"], sysd["Ul"], sysd["rhs"], sysd["pcr"]
        blk64, Ul64, rhs64 = blk.double(), Ul.double(), rhs.double()
        pcr64 = tuple(t.double() for t in pcr)
        n = pl.n_cameras
        x5, k5, ok5 = pcg_banded(blk, Ul, None, rhs, pl, max_iters=5, tol=0.0, tridiag=pcr)
        x5p, k5p, ok5p = pcg_banded_plain(blk, Ul, None, rhs, pl, max_iters=5, tol=0.0,
                                          tridiag=pcr)
        x5r, _, _ = pcg_banded_plain(blk64, Ul64, None, rhs64, pl, max_iters=5, tol=0.0,
                                     tridiag=pcr64)
        a, r = err_rows(x5.T.contiguous(), x5r.T.contiguous(), n)
        _, plain5 = err_rows(x5p.T.contiguous(), x5r.T.contiguous(), n)
        tol5 = max(TOL[counter], BAND_PLAIN_FACTOR * plain5)
        if not (int(k5) == int(k5p) == 5 and bool(ok5) and bool(ok5p)):
            raise AssertionError(f"K8 fixed run, {what}: {int(k5)} / {int(k5p)} iterations, ok "
                                 f"{bool(ok5)} / {bool(ok5p)}")
        record(counter, a, r, f"{what}, 5 fixed iterations", tol5)
        x5s, k5s, ok5s = pcg_banded(blk, Ul, None, rhs, pl, max_iters=5, tol=0.0, tridiag=pcr,
                                    resident=False)
        a_s, r_s = err_rows(x5s.T.contiguous(), x5r.T.contiguous(), n)
        if not (int(k5s) == 5 and bool(ok5s)):
            raise AssertionError(f"K8 streaming, fixed run, {what}: {int(k5s)} iterations")
        record(counter, a_s, r_s, f"{what}, 5 fixed iterations, streaming form", tol5)
        budget = 5 * gmax
        xg, kg, okg = pcg_banded(blk, Ul, None, rhs, pl, max_iters=budget, tol=gtol, tridiag=pcr)
        xgp, kgp, okgp = pcg_banded_plain(blk, Ul, None, rhs, pl, max_iters=budget, tol=gtol,
                                          tridiag=pcr)
        mv = pairs_mod.make_banded_matvec(blk64, Ul64, pl, 9)
        true_res = ((rhs64 - mv(xg.double())).norm() / rhs64.norm()).item()
        true_res_p = ((rhs64 - mv(xgp.double())).norm() / rhs64.norm()).item()
        kg, kgp, okg, okgp = int(kg), int(kgp), bool(okg), bool(okgp)
        say("kernel", f"K8 tridiag {what}: 5 fixed iterations, worst column of x rel err {r:.2e} "
                      f"(streaming form {r_s:.2e}; plain f32 {plain5:.2e}; tol {tol5:.1e}); at tol {gtol:g}, budget "
                      f"{budget}: {kg} iterations (plain {kgp}), ok {okg} (plain {okgp}), true "
                      f"residual in f64 {true_res:.3e} (plain {true_res_p:.3e})")
        if not (okg and okgp and kg < budget and abs(kg - kgp) <= max(3, 0.2 * kgp)):
            raise AssertionError(f"K8 tridiag {what}: {kg} iterations ok {okg}, plain {kgp} ok "
                                 f"{okgp}")
        if not true_res <= 10 * gtol:
            raise AssertionError(f"K8 tridiag {what}: true residual {true_res} > {10 * gtol}")
        return kg

    lam_pd = None
    for lam in (1e-4, 1e-3, 1e-2, 1e-1, 1.0):
        sysd = given_system(B, plan, pd, plans, lam)
        is_pd = tridiag_is_pd(*sysd["tri"])
        say("kernel", f"the block-tridiagonal part of S at lam {lam:g}: "
                      f"{'positive definite' if is_pd else 'indefinite'}")
        if is_pd:
            lam_pd = lam
            break
        sys_indef = sysd
    if lam_pd is None:
        raise AssertionError("the tridiagonal part of S is indefinite up to lam 1")
    k8_iters = {}
    for lam in sorted({lam_pd, 1.0}):
        sysd = given_system(B, plan, pd, plans, lam)
        t0 = time.perf_counter()
        sysd["pcr"] = pcr_factor(*sysd["tri"])
        torch.cuda.synchronize()
        factor_s = time.perf_counter() - t0
        k8_iters[lam] = check_tridiag_kernel(sysd, plan, f"lam {lam:g}")
        # the block-Jacobi form against K4 on the same system
        xj, kj, okj = pcg_banded(sysd["blk"], sysd["Ul"], sysd["Minv"], sysd["rhs"], plan,
                                 max_iters=5 * gmax, tol=gtol)
        x4, k4_, ok4 = pcg_banded(sysd["blk"], None, None, sysd["rhs"], plan, max_iters=5 * gmax,
                                  tol=gtol, U_t=pd.U_t, lam=sysd["lam"], diag_floor=cfg_floor,
                                  diag_ceil=cfg_ceil)
        _, rj = err(xj, x4.double())
        say("kernel", f"K8 block-Jacobi (Ul, M⁻¹ given) lam {lam:g}: {int(kj)} iterations, ok "
                      f"{bool(okj)}; K4 on the same system {int(k4_)}, ok {bool(ok4)}; x apart by "
                      f"{rj:.2e} of max|x|{' (limit 1e-5)' if lam == 1.0 else ''}; tridiag took "
                      f"{k8_iters[lam]}")
        # the same count and x where CG is stable (λ = 1); at weak damping the
        # two M⁻¹ round differently and the counts may part by a few
        slack = 0 if lam == 1.0 else max(3, 0.2 * int(k4_))
        if not (abs(int(kj) - int(k4_)) <= slack and bool(okj) == bool(ok4)):
            raise AssertionError(f"K8 block-Jacobi at lam {lam:g}: {int(kj)} iterations ok "
                                 f"{bool(okj)}, K4 {int(k4_)} ok {bool(ok4)}")
        if lam == 1.0:
            record("pcg_band_given", 0.0, rj, "block-Jacobi form against K4, lam 1", 1e-5)
    # an indefinite preconditioner: −D⁻¹ in the last PCR step breaks down at
    # the first step; the weakly damped system itself, where it is indefinite
    P_, Q_, D_ = sysd["pcr"]
    x0 = torch.randn(sysd["rhs"].shape, generator=gen, device=dev)
    bkw = dict(max_iters=gmax, tol=gtol, x0=x0, tridiag=(P_, Q_, -D_))
    xb, kb, okb = pcg_banded(sysd["blk"], sysd["Ul"], None, sysd["rhs"], plan, **bkw)
    xbp, kbp, okbp = pcg_banded_plain(sysd["blk"], sysd["Ul"], None, sysd["rhs"], plan, **bkw)
    if not (not bool(okb) and not bool(okbp) and int(kb) == int(kbp) == 1
            and torch.equal(xb, x0) and torch.equal(xbp, x0)):
        raise AssertionError(f"K8 on a negated preconditioner: {int(kb)} iterations ok "
                             f"{bool(okb)}, plain {int(kbp)} ok {bool(okbp)}, x frozen "
                             f"{torch.equal(xb, x0)}")
    line = "K8 on a negated preconditioner: ok False after 1 iteration, x frozen, plain alike"
    if lam_pd > 1e-4:
        sys_indef["pcr"] = pcr_factor(*sys_indef["tri"])
        ikw = dict(max_iters=gmax, tol=gtol, tridiag=sys_indef["pcr"])
        _, ki, oki = pcg_banded(sys_indef["blk"], sys_indef["Ul"], None, sys_indef["rhs"], plan,
                                **ikw)
        _, kip, okip = pcg_banded_plain(sys_indef["blk"], sys_indef["Ul"], None,
                                        sys_indef["rhs"], plan, **ikw)
        line += (f"; at lam {float(sys_indef['lam']):g} (indefinite tridiagonal part): kernel "
                 f"{int(ki)} iterations ok {bool(oki)}, plain {int(kip)} ok {bool(okip)}")
        if bool(oki) != bool(okip):
            raise AssertionError(line)
        del sys_indef
    say("kernel", line)

    # K8's times at λ = 1 with the golden's budget, as path A calls it
    def k8_call(**kw):
        return pcg_banded(sysd["blk"], sysd["Ul"], None, sysd["rhs"], plan, tridiag=sysd["pcr"],
                          **kw)

    res8 = results["pcg_band_given"]
    k8_t = pcg_times(k8_call)
    k8_per_iter, t_lo, t_hi, res8["ms"], kt8 = k8_t["resident"]
    k8_per_iter_str, s_lo, s_hi, res8["ms_streaming"], _ = k8_t["streaming"]
    reads0 = pcg_mod.host_reads["cg"]
    res8["plain_ms"] = median_ms(
        torch, lambda: pcg_banded_plain(sysd["blk"], sysd["Ul"], None, sysd["rhs"], plan,
                                        max_iters=gmax, tol=gtol, tridiag=sysd["pcr"]),
        reps=3, warmup=1)
    pcg_mod.host_reads["cg"] = reads0
    factor_ms = median_ms(torch, lambda: pcr_factor(*sysd["tri"]), reps=5, warmup=1)
    levels = int(sysd["pcr"][0].shape[0])
    set_bound("pcg_band_given", roofline.pcg_band_given_counts(plan, levels, kt8))
    res8["iterations"] = kt8
    res8["ms_per_cg_iteration"] = k8_per_iter
    res8["ms_per_cg_iteration_streaming"] = k8_per_iter_str
    levels_floor = (2 + levels) * ex_ms
    res8["floor_ms_per_cg_iteration"] = levels_floor
    res8["pcr_levels"] = levels
    res8["pcr_factor_ms"] = factor_ms
    say("kernel", f"K8 pcg_band tridiag lam 1, tol {gtol:g}, budget {gmax}, resident form: "
                  f"{res8['ms']:.4f} ms for "
                  f"{kt8} iterations ({levels} PCR levels; K4 took {kt} on the same system), "
                  f"{k8_per_iter:.5f} ms a CG iteration ({t_lo:.4f} ms for 5, {t_hi:.4f} ms for "
                  f"55; K4 {per_iter_ms:.5f}; floor of its {2 + levels} exchanges "
                  f"{levels_floor:.5f}); streaming form {res8['ms_streaming']:.4f} ms, "
                  f"{k8_per_iter_str:.5f} ms a CG iteration ({s_lo:.4f} ms for 5, {s_hi:.4f} ms "
                  f"for 55); plain {res8['plain_ms']:.3f} ms, bound "
                  f"{res8['bound_ms']:.4f} ms ({res8['bound_by']}); PCG working set "
                  f"{band_l2_bytes(plan, 9, levels) / 2**20:.2f} MiB; pcr_factor "
                  f"{factor_ms:.3f} ms a call between CUDA events (about a thousand small ops "
                  f"launched from the host), {factor_s:.4f} s on the host's clock the first time")
    del B, B64, pd, sysd

    # 4. off-band leftovers: a ring whose band is capped at 32 offsets
    base, _ = make_bal_like_problem("trafalgar-257", dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    n_base, n_close = base.n_obs, 120
    close_pt = rng.choice(base.n_points, n_close, replace=False)
    close_cam = rng.integers(0, base.n_cameras, n_close)
    lp = make_problem(
        base.cameras.numpy(), base.points.numpy(),
        np.concatenate([base.obs_2d.numpy()[:n_base], np.zeros((n_close, 2), np.float32)]),
        np.concatenate([base.cam_idx.numpy()[:n_base], close_cam]),
        np.concatenate([base.pt_idx.numpy()[:n_base], close_pt]), device=dev)
    lplans = build_plans(lp.cam_idx, lp.pt_idx, lp.n_cameras, lp.n_points)
    lplan = pairs_mod.build_pair_plan(lp.cam_idx, lp.pt_idx, lp.n_obs, lp.n_cameras, lp.n_points,
                                      with_kernel_plans=True, symmetric=True)
    n_left = lplan.n_segments - lplan.k_band
    say("left", f"trafalgar-257 ring with {n_close} loop closures: {len(lplan.band_offsets)} band "
                f"offsets, k_band {lplan.k_band}, {n_left} off-band leftover segments")
    if not (lplan.banded and n_left > 0 and lplan.left is not None
            and lplan.band_offsets[1] == 1):
        raise AssertionError("the loop-closure problem's plan keeps no off-band leftovers")
    LB = linearize(lp, lplans)
    lpd = pairs_mod.precompute_pair_data(LB, lplan)
    lsys = given_system(LB, lplan, lpd, lplans, 1.0)
    lsys["pcr"] = pcr_factor(*lsys["tri"])
    check_tridiag_kernel(lsys, lplan, "with leftovers, lam 1")
    lkw = dict(U_t=lpd.U_t, lam=lsys["lam"], diag_floor=cfg_floor, diag_ceil=cfg_ceil)
    lkw64 = dict(lkw, U_t=lpd.U_t.double(), lam=lsys["lam"].double())
    lblk, lrhs = lsys["blk"], lsys["rhs"]
    x5, k5, ok5 = pcg_banded(lblk, None, None, lrhs, lplan, max_iters=5, tol=0.0, **lkw)
    x5p, _, _ = pcg_banded_plain(lblk, None, None, lrhs, lplan, max_iters=5, tol=0.0, **lkw)
    x5r, _, _ = pcg_banded_plain(lblk.double(), None, None, lrhs.double(), lplan, max_iters=5,
                                 tol=0.0, **lkw64)
    band_only = dataclasses.replace(lplan, n_segments=lplan.k_band, left=None)
    x5n, _, _ = pcg_banded_plain(lblk.double(), None, None, lrhs.double(), band_only, max_iters=5,
                                 tol=0.0, **lkw64)
    a, r = err_rows(x5.T.contiguous(), x5r.T.contiguous(), lp.n_cameras)
    _, plain5 = err_rows(x5p.T.contiguous(), x5r.T.contiguous(), lp.n_cameras)
    _, effect = err_rows(x5n.T.contiguous(), x5r.T.contiguous(), lp.n_cameras)
    tol5 = max(TOL["pcg_band"], BAND_PLAIN_FACTOR * plain5)
    record("pcg_band", a, r, "with leftovers, lam 1, 5 fixed iterations", tol5)
    left_cams = resident_cams(0, lplan.band_offsets, lp.n_cameras, dev)
    x5s, _, _ = pcg_banded(lblk, None, None, lrhs, lplan, max_iters=5, tol=0.0, resident=False,
                           **lkw)
    a_s, r_s = err_rows(x5s.T.contiguous(), x5r.T.contiguous(), lp.n_cameras)
    record("pcg_band", a_s, r_s, "with leftovers, lam 1, 5 fixed iterations, streaming form", tol5)
    if left_cams != 8:
        raise AssertionError(f"a band of {len(lplan.band_offsets)} offsets should fit the resident "
                             f"form at 8 cameras a group, not {left_cams}")
    xg, kg, okg = pcg_banded(lblk, None, None, lrhs, lplan, max_iters=5 * gmax, tol=gtol, **lkw)
    _, kgp, okgp = pcg_banded_plain(lblk, None, None, lrhs, lplan, max_iters=5 * gmax, tol=gtol,
                                    **lkw)
    say("left", f"K4 with leftovers, lam 1 (resident form, groups of {left_cams} cameras): 5 fixed "
                f"iterations, worst column of x rel err {r:.2e} "
                f"(streaming form {r_s:.2e}; plain f32 {plain5:.2e}; tol {tol5:.1e}; leaving the leftovers out moves x by "
                f"{effect:.2e}); at tol {gtol:g}: {int(kg)} iterations ok {bool(okg)} (plain "
                f"{int(kgp)} ok {bool(okgp)})")
    if not (bool(okg) and bool(okgp) and abs(int(kg) - int(kgp)) <= max(3, 0.2 * int(kgp))
            and effect > 10 * r):
        raise AssertionError("K4 with leftovers disagrees with the host loop, or the leftovers "
                             "do not matter on this problem")
    for precond, counter in (("jacobi", "pcg_band"), ("tridiag", "pcg_band_given")):
        pcg_mod.reset_host_reads()
        _lib.reset_launches()
        pcg_band_mod.reset_form_launches()
        lres = solve(lp, LMConfig(linear_solver="schur_sparse_pallas", precond=precond,
                                  **dict(golden_cfg, max_iters=5)))
        hist = [lres.initial_cost.item()] + lres.cost_history.tolist()
        say("left", f"solve, precond {precond}: cost {hist[0]:.6g} -> {lres.cost.item():.6g} in "
                    f"{int(lres.iterations)} iterations, cg {lres.cg_history.tolist()}, "
                    f"{_lib.launches[counter]} PCG kernel launches, host reads "
                    f"{dict(pcg_mod.host_reads)}")
        if not (_lib.launches[counter] == 5 and pcg_mod.host_reads["cg"] == 0
                and pcg_band_mod.form_launches == {"resident": 5, "streaming": 0}
                and all(math.isfinite(v) for v in hist)
                and all(b <= a for a, b in zip(hist, hist[1:]))):
            raise AssertionError(f"solve over a band with leftovers, precond {precond}: {hist}, "
                                 f"launches {_lib.launches}, reads {pcg_mod.host_reads}")
    del lp, LB, lpd, lsys, lblk, lrhs, base

    # 5. the main paths end to end: each with the launch counts set to 0 just
    # before its solve and read just after
    def run_path(prob, name, cfg, kernels, gold, sparse_path):
        """Solve twice; hold parity, launches, repeatability. Returns the
        launch counts of the first solve and a few figures."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pcg_mod.reset_host_reads()
        _lib.reset_launches()
        pcg_band_mod.reset_form_launches()
        t0 = time.perf_counter()
        res = solve(prob, cfg)
        final = res.cost.item()
        first_s = time.perf_counter() - t0
        launches = dict(_lib.launches)
        forms = dict(pcg_band_mod.form_launches)
        n_pcg = launches["pcg_band"] + launches["pcg_band_given"]
        if forms != {"resident": n_pcg, "streaming": 0}:
            raise AssertionError(f"{name}: the PCG kernel ran {forms}, expected its resident "
                                 f"form on each of its {n_pcg} launches")
        reads = dict(pcg_mod.host_reads)
        peak = torch.cuda.max_memory_allocated()
        missing = [k for k in kernels if launches[k] == 0]
        extra = [k for k in launches if launches[k] and k not in kernels]
        if missing or extra:
            raise AssertionError(f"{name}: kernels of the path not launched by the solve: "
                                 f"{missing}; launched and not of the path: {extra}")
        t0 = time.perf_counter()
        res2 = solve(prob, cfg)
        final2 = res2.cost.item()
        steady_s = time.perf_counter() - t0
        iters = int(res2.iterations)
        cg_total, cg_total2 = int(res.cg_history.sum()), int(res2.cg_history.sum())
        gap = (final - gold["final_cost"]) / gold["final_cost"]
        say("solve", f"{name} f32: {int(res.iterations)} LM iterations "
                     f"({int(res.accepted)} accepted, converged {bool(res.converged)}), cg_total "
                     f"{cg_total}; first call {first_s:.3f} s, steady state {steady_s:.3f} s = "
                     f"{iters / steady_s:.3f} LM it/s")
        say("solve", f"final cost {final:.6f} (repeat {final2:.6f}, cg_total {cg_total2}), "
                     f"golden {gold['final_cost']:.6f}, gap {100 * gap:+.5f}% (limit 1%); "
                     f"host reads {reads['cg']} CG + {reads['lm']} LM; peak device memory "
                     f"{peak / 2**20:.1f} MiB; launches {launches}; PCG kernel forms {forms}")
        if not (math.isfinite(final) and abs(gap) < 0.01):
            raise AssertionError(f"{name}: final cost {final} is not within 1% of "
                                 f"{gold['final_cost']}")
        if (final2, cg_total2) != (final, cg_total):
            raise AssertionError(f"{name}: the repeat gave cost {final2} and cg_total {cg_total2},"
                                 f" the first solve {final} and {cg_total}")
        if sparse_path and reads["cg"] != 0:
            raise AssertionError(f"{name}: {reads['cg']} per-CG-iteration host reads, expected 0")
        return launches, dict(lm_it_s=iters / steady_s, cg_total=cg_total, gap_pct=100 * gap,
                              iterations=iters, peak_mib=peak / 2**20), res

    path_launches, path_figures, path_results = {}, {}, {}
    for name, tier, precond, kernels in PATHS:
        cfg = LMConfig(linear_solver=tier, precond=precond, **golden_cfg)
        path_launches[name], path_figures[name], path_results[name] = run_path(
            problem, f"{PROBLEM} {tier} precond {precond}", cfg, kernels, golden,
            tier == "schur_sparse_pallas")
    fa, fj = path_figures["tridiag"], path_figures["schur_sparse_pallas"]
    say("solve", f"path A (tridiag) against the Jacobi solve: cg_total {fa['cg_total']} / "
                 f"{fj['cg_total']}, {fa['lm_it_s']:.3f} / {fj['lm_it_s']:.3f} LM it/s, "
                 f"{fa['iterations']} retries with one pcr_factor each "
                 f"({results['pcg_band_given']['pcr_factor_ms']:.3f} ms between CUDA events)")

    for rname in ("huber", "cauchy", "arctan"):
        rcfg = LMConfig(**dict(golden_cfg, max_iters=5), linear_solver="schur_pcg_pallas",
                        robust_kind=ROBUST_KINDS[rname], robust_scale=ROBUST_SCALE)
        r = solve(problem, rcfg)
        hist = r.cost_history.tolist()
        c0, c1 = r.initial_cost.item(), r.cost.item()
        ok = (all(math.isfinite(v) for v in hist + [c0, c1]) and c1 <= c0
              and all(b <= a for a, b in zip(hist, hist[1:])))
        say("solve", f"{rname}: cost {c0:.6f} -> {c1:.6f} in {int(r.iterations)} iterations "
                     f"({int(r.accepted)} accepted)")
        if not ok:
            raise AssertionError(f"{rname}: cost not finite or rising: {c0} -> {hist}")

    # 5b. the user's path around the main solve: BAL file, checkpointed
    # chunks, kill and resume, the command line
    sparse_kernels = next(k for n, _, _, k in PATHS if n == "schur_sparse_pallas")
    phase_resume(torch, problem, path_results["schur_sparse_pallas"],
                 LMConfig(linear_solver="schur_sparse_pallas", **golden_cfg), golden,
                 sparse_kernels)
    # 5c. the sharded solve on two ranks sharing the card, then the plain
    # tiers' repeat
    t0 = time.perf_counter()
    sharded_launches = phase_sharded(torch, problem, golden, golden_cfg,
                                     path_figures["schur_sparse_pallas"]["lm_it_s"])
    say("sharded", f"phase wall time {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    phase_repeat(torch, problem, golden_cfg)
    say("repeat", f"phase wall time {time.perf_counter() - t0:.3f} s")
    del problem, plans, plan, plain_plan, path_results

    # 6. heavy tracks and the dense tiers on the card: each linear step against
    # schur_sparse's on the same system in f64 (plain PyTorch on the card)
    skw = dict(cg_max_iters=500, cg_tol=1e-12, diag_floor=cfg_floor, diag_ceil=cfg_ceil)
    lam64 = torch.tensor(1.0, dtype=torch.float64, device=dev)

    def system64(prob):
        r, Jc, Jp = jacobian_blocks_bal(prob.cameras, prob.points, prob.obs_2d, prob.cam_idx,
                                        prob.pt_idx, prob.mask)
        return assemble(r, Jc, Jp, prob.cam_idx, prob.pt_idx, prob.n_cameras, prob.n_points,
                        mask=prob.mask)

    def pair_plan(prob, **kw):
        return pairs_mod.build_pair_plan(prob.cam_idx, prob.pt_idx, prob.n_obs, prob.n_cameras,
                                         prob.n_points, **kw)

    def step_err(out, ref, what):
        worst = max(err(out[i], ref[i])[1] for i in (0, 1))
        say("tiers", f"{what}: step against schur_sparse in f64 {worst:.2e} of max|step| "
                     f"(limit 1e-8), {int(out[2])} CG iterations")
        if not (bool(out[3]) and worst <= 1e-8):
            raise AssertionError(f"{what}: step {worst} from schur_sparse's, ok {bool(out[3])}")

    p49, _ = make_bal_like_problem("ladybug-49", dtype=torch.float64, device=dev)
    B49 = system64(p49)
    ref49 = pairs_mod.solve_schur_sparse(B49, lam64, pair_plan(p49, symmetric=True), **skw)
    for banded in (True, False):
        hplan = pair_plan(p49, symmetric=True, max_degree=3, banded=banded)
        if not (hplan.n_heavy_pts > 0 and hplan.banded == banded):
            raise AssertionError(f"ladybug-49 with max_degree=3: {hplan.n_heavy_pts} heavy "
                                 f"points, banded {hplan.banded}")
        step_err(pairs_mod.solve_schur_sparse(B49, lam64, hplan, **skw), ref49,
                 f"heavy tracks ({hplan.n_heavy_pts} heavy points, "
                 f"{'banded' if banded else 'non-banded'} plan)")
    del p49, B49, ref49
    ps64, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, dtype=torch.float64,
                                     device=dev)
    Bs = system64(ps64)
    refs = pairs_mod.solve_schur_sparse(Bs, lam64, pair_plan(ps64, symmetric=True), **skw)
    step_err(pairs_mod.solve_schur_dense(Bs, lam64, pair_plan(ps64, symmetric=False), **skw),
             refs, "schur_dense (T-major reduced system)")
    dxc, dxp = solve_dense(Bs, lam64, cfg_floor, cfg_ceil)
    step_err((dxc, dxp, 0, torch.ones((), dtype=torch.bool)), refs, "dense (full H)")
    ps32, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, device=dev)
    tcfg = dict(max_iters=6, init_lambda=10.0)
    want = solve(ps32, LMConfig(linear_solver="schur_sparse", **tcfg)).cost.item()
    for tier in ("schur_dense", "schur_dense_pallas", "dense"):
        got = solve(ps32, LMConfig(linear_solver=tier, **tcfg)).cost.item()
        say("tiers", f"solve() {tier} f32, 6 iterations: cost {got:.6f} (schur_sparse "
                     f"{want:.6f})")
        if not abs(got - want) <= 1e-3 * abs(want):
            raise AssertionError(f"{tier}: cost {got} against schur_sparse's {want}")
    del ps64, ps32, Bs, refs

    # 7. Trafalgar-257, Huber, at its golden's config
    with open(os.path.join(GOLDENS, "trafalgar-257.json")) as fh:
        tgold = json.load(fh)
    tp, _ = make_bal_like_problem("trafalgar-257", dtype=torch.float32, device=dev)
    tcfg = LMConfig(linear_solver="schur_sparse_pallas", max_iters=tgold["max_iters"],
                    cg_max_iters=tgold["cg_max_iters"], cg_tol=tgold["cg_tol"], init_lambda=1e-4,
                    robust_kind=ROBUST_KINDS[tgold["robust"]], robust_scale=tgold["robust_scale"])
    tplans, tplan = build_solver_plans(tp, tcfg)
    tsched = tplans.lin_sched
    results["linearize"]["ms_trafalgar"] = device_ms(torch, [
        lambda s=s: fused_linearize_assemble(tp.cameras, *s, tp.cam_idx, tp.pt_idx, tp.mask,
                                             tplans.cam_start, sched=tsched)
        for s in input_copies((tp.points, tp.obs_2d))])
    results["linearize"]["bound_ms_trafalgar"], _ = roofline.bound(*roofline.lin_counts(
        tp.n_cameras, tp.n_points, tp.obs_2d.shape[0], tsched)[0])
    say("huber", f"K2 at trafalgar-257's shape ({describe_lin_schedule(tsched)}): "
                 f"{results['linearize']['ms_trafalgar']:.4f} ms (replayed CUDA graphs over "
                 f"rotating copies), bound {results['linearize']['bound_ms_trafalgar']:.4f} ms")
    t_kernels = (("segsum", "linearize", "cost", "pcg_band", "pairblocks")
                 + (("trackband",) if tplan.track is not None else ())
                 + (("slotband",) if tplan.slot is not None else ()))
    t_launches, _, _ = run_path(tp, f"trafalgar-257 schur_sparse_pallas {tgold['robust']}", tcfg,
                             t_kernels, tgold, True)
    del tp

    # 8. path B: venice-1778 with community covisibility, a non-banded plan
    with open(os.path.join(GOLDENS, "venice-1778-community.json")) as fh:
        vgold = json.load(fh)
    t0 = time.perf_counter()
    vp, _ = make_bal_like_problem("venice-1778", covis="community", dtype=torch.float32,
                                  device=dev)
    gen_s = time.perf_counter() - t0
    vcfg = LMConfig(linear_solver="schur_sparse_pallas", max_iters=vgold["max_iters"],
                    cg_max_iters=vgold["cg_max_iters"], cg_tol=vgold["cg_tol"], init_lambda=1e-4)
    t0 = time.perf_counter()
    vplans, vplan = build_solver_plans(vp, vcfg)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    Cv, Pv, Ov = vp.n_cameras, vp.n_points, vp.obs_2d.shape[0]
    n_real = int((vplan.pair_key < Cv * Cv).sum())
    say("venice", f"venice-1778-community: {Cv} cameras, {Pv} points, {vp.n_obs} observations "
                  f"padded to {Ov}; generated in {gen_s:.1f} s, plans built in {plan_s:.1f} s: "
                  f"banded {vplan.banded}, {vplan.n_segments} segments (k_pad {vplan.k_pad}), "
                  f"{n_real} pairs padded to {vplan.n_pairs}, {vplan.n_heavy_pts} heavy points")
    say("venice", f"K7 schedule: {describe_schedule(vplan.pair_sched)}")
    say("venice", f"K2/K3 schedule: {describe_lin_schedule(vplans.lin_sched)}")
    if (vplan.banded or vplan.track is not None or vplan.slot is not None
            or vplan.ci_start is None or vplan.cj_start is None):
        raise AssertionError("the community plan is banded or lacks the compact matvec's starts")
    # K1 at the compact matvec's shapes, as make_compact_matvec calls it:
    # (9, k_pad) by row camera on sorted values, and by column camera through
    # the plan's cj-sorted permutation
    kp = vplan.k_pad
    vals = torch.randn((9, kp), generator=gen, device=dev)
    cj_unsorted = torch.empty_like(vplan.cj_keys)
    cj_unsorted[vplan.seg_perm_cj.long()] = vplan.cj_keys
    k1_venice = [
        k1_case(f"(9,{kp})->{Cv + 1} by seg_ci (venice-1778-community)", "venice (9,k_pad) by ci",
                vals, vplan.seg_ci, Cv + 1, vplan.ci_start, vplan.ci_longest),
        k1_case(f"(9,{kp})->{Cv + 1} by cj_keys through seg_perm_cj (venice-1778-community)",
                "venice (9,k_pad) by cj, perm", vals, vplan.cj_keys, Cv + 1, vplan.cj_start,
                vplan.cj_longest, perm=vplan.seg_perm_cj, unsorted_keys=cj_unsorted)]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        results["segsum"][f"{key}_venice"] = sum(f[key] for f in k1_venice)
    say("venice", f"longest segment by seg_ci {vplan.ci_longest}, by cj_keys {vplan.cj_longest} "
                  f"(mean {kp / (Cv + 1):.1f})")
    del vals, cj_unsorted
    # K7 over all pairs, on the first linearization; the f64 plain version in chunks of pairs
    VB = linearize(vp, vplans)
    vpd = pairs_mod.precompute_pair_data(VB, vplan)
    kw7 = dict(dc=9, diag_floor=cfg_floor, diag_ceil=cfg_ceil)
    for lam in (1e-4, 1.0):
        lam32 = torch.tensor(lam, device=dev)
        out = fused_pair_blocks(vpd.packed, vplan.pair_seg, lam32, kp, vplan.pair_sched, **kw7)
        if out[:, -1].abs().max().item() != 0.0:
            raise AssertionError("K7 wrote into the trash segment of the padding pairs")
        plain = fused_pair_blocks_plain(vpd.packed, vplan.pair_seg, lam32, kp, **kw7)
        plain[:, -1] = 0.0
        ref = torch.zeros((81, kp), dtype=torch.float64, device=dev)
        step = 1 << 20
        for a0 in range(0, n_real, step):
            a1 = min(a0 + step, n_real)
            ref += fused_pair_blocks_plain(vpd.packed[:, a0:a1].double(), vplan.pair_seg[a0:a1],
                                           lam32.double(), kp, **kw7)
        a, r = err_rows(out, ref, kp)
        _, pr = err_rows(plain, ref, kp)
        tol = max(1e-5, BAND_PLAIN_FACTOR * pr)
        record("pairblocks", a, r, f"venice-1778-community, lam {lam:g}", tol)
        say("venice", f"K7 pairblocks over {n_real} pairs -> (81,{kp}), lam {lam:g}: worst block-"
                      f"entry row rel err {r:.2e} (plain f32 {pr:.2e}; tol {tol:.1e})")
        del out, plain, ref
    lam32 = torch.tensor(1e-4, device=dev)
    r7 = results["pairblocks"]
    r7["ms_venice"] = median_ms(torch, lambda: fused_pair_blocks(
        vpd.packed, vplan.pair_seg, lam32, kp, vplan.pair_sched, **kw7), reps=10)
    r7["plain_ms_venice"] = median_ms(torch, lambda: fused_pair_blocks_plain(
        vpd.packed, vplan.pair_seg, lam32, kp, **kw7), reps=3, warmup=1)
    r7["bound_ms_venice"], by7 = roofline.bound(*roofline.pairblocks_counts(vplan))
    say("venice", f"K7 pairblocks at this shape: {r7['ms_venice']:.4f} ms, plain "
                  f"{r7['plain_ms_venice']:.3f} ms, bound {r7['bound_ms_venice']:.4f} ms ({by7})")
    del VB, vpd
    # K2 at this shape; held against f64 on the observations of the cameras
    # with the most, the median and the fewest (their U, gc, W and pt_vals
    # depend on those alone)
    vsched = vplans.lin_sched
    vargs = (vp.cameras, vp.points, vp.obs_2d, vp.cam_idx, vp.pt_idx, vp.mask)
    out = fused_linearize_assemble(*vargs, vplans.cam_start, sched=vsched)
    again = fused_linearize_assemble(*vargs, vplans.cam_start, sched=vsched)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("K2 at venice-1778-community: two calls differ")
    del again
    lens = vplans.cam_start.diff()
    order = torch.argsort(lens, stable=True)
    cams = [int(order[-1]), int(order[Cv // 2]), int(order[int((lens == 0).sum())])]
    keep = torch.isin(vp.cam_idx, torch.tensor(cams, dtype=torch.int32, device=dev))
    sub = (vp.obs_2d[keep], vp.cam_idx[keep], vp.pt_idx[keep], vp.mask[keep])
    ref = fused_linearize_assemble_plain(vp.cameras.double(), vp.points.double(),
                                         sub[0].double(), *sub[1:])
    plain = fused_linearize_assemble_plain(vp.cameras, vp.points, *sub)
    ci = torch.tensor(cams, device=dev)
    for what, got, want, pl32 in (
            ("U", out[0][ci], ref[0][ci], plain[0][ci]), ("gc", out[1][ci], ref[1][ci], plain[1][ci]),
            ("W", out[2][:, keep], ref[2], plain[2]), ("pt_vals", out[3][:, keep], ref[3], plain[3])):
        a, r = err(got, want)
        _, pr = err(pl32, want)
        record("linearize", a, r, f"venice-1778-community {what}", TOL_LINEARIZE_NO_LOSS)
        say("venice", f"K2 {what} on cameras {cams} ({[int(lens[c]) for c in cams]} "
                      f"observations): rel err {r:.2e} (plain f32 {pr:.2e}; tol "
                      f"{TOL_LINEARIZE_NO_LOSS:.0e})")
    del out, ref, plain, sub, keep
    r2 = results["linearize"]
    r2["ms_venice"] = median_ms(torch, lambda: fused_linearize_assemble(
        *vargs, vplans.cam_start, sched=vsched), reps=10)
    r2["bound_ms_venice"], _ = roofline.bound(*roofline.lin_counts(Cv, Pv, Ov, vsched)[0])
    say("venice", f"K2 linearize at this shape: {r2['ms_venice']:.4f} ms (eager events), bound "
                  f"{r2['bound_ms_venice']:.4f} ms")
    v_launches, v_fig, _ = run_path(vp, "venice-1778-community schur_sparse_pallas", vcfg,
                                 VENICE_KERNELS, vgold, False)
    del vp

    # the pose graph and the SfM front end: plain PyTorch, no kernel
    for name, phase in (("posegraph", phase_posegraph), ("sfm", phase_sfm)):
        t0 = time.perf_counter()
        phase(torch)
        say(name, f"phase wall time {time.perf_counter() - t0:.3f} s")
    # the benchmark harness, through the command line and its own entry point
    t0 = time.perf_counter()
    phase_bench(kind)
    say("bench", f"phase wall time {time.perf_counter() - t0:.3f} s")

    # max_rel_err is the number held to its tolerance; max_abs_err is in the
    # outputs' own units (K2's U entries reach ~4e11, so its absolute error is
    # large). launches: by the schur_sparse_pallas solve of ladybug-1723, the
    # path of K1–K7, and for K8 by the same solve with precond="tridiag";
    # launches_<path>: by each other path's first solve. K1's ms, plain_ms,
    # library_ms and bound_ms are the two sums of a CG iteration or a
    # back-substitution on ladybug-1723 ((3, O) by point through perm, (9, O)
    # by camera), each call reading its values from device memory; by_shape
    # holds every call timed, with the same from L2. The *_venice figures of K1
    # (both keyed sums of one compact matvec) and K7 are at
    # venice-1778-community's shapes, K2's *_trafalgar and *_venice at
    # trafalgar-257's (replayed CUDA graphs) and venice-1778-community's
    # (eager events); K2's and K3's ms and ms_l2 are replayed CUDA graphs,
    # read from device memory and from L2. K4's and K8's ms are the resident form's
    # (the one the solves launch), ms_streaming the streaming form's on the
    # same system; floor_ms_per_cg_iteration is the measured time of an
    # iteration's device-wide exchanges alone.
    sparse = path_launches["schur_sparse_pallas"]
    print(json.dumps({"kernels": [
        dict({"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
              "launches": (sparse if k != "pcg_band_given" else path_launches["tridiag"])[k],
              "launches_schur_pcg_pallas": path_launches["schur_pcg_pallas"][k],
              "launches_tridiag": path_launches["tridiag"][k],
              "launches_trafalgar_huber": t_launches[k],
              "launches_venice_community": v_launches[k],
              "launches_sharded": sharded_launches[k]}, **results[k])
        for k in TOL]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
