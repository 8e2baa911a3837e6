#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_ba_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (the end-to-end phase a few):
  1. device  — the card's name and, from nvidia-smi, its power limit;
  2. build   — compile the hand-written kernels from tpu_ba_torch/csrc/;
  3. kernels — each kernel against its plain PyTorch version in f64 on the
               same inputs, at the ladybug-1723 shapes of the main path, with
               the median time of kernel and plain version (f32, CUDA events);
  4. solve   — the ladybug-1723 ring stand-in through
               solve(problem, LMConfig(linear_solver="schur_pcg_pallas")) at
               the golden's config (80 LM iterations, CG 100 at 1e-4, λ₀ 1e-4),
               f32; final cost within 1% of data/goldens/ladybug-1723.json, and
               every kernel launched by that solve; then 5 iterations each of
               Huber, Cauchy and arctan, whose cost must not rise.
Then one JSON line of per-kernel results, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises and exits non-zero; so does a machine without CUDA and a
directory without the package. The first run generates the problem into
data/cache/ (git-ignored) and the kernels into build/ (git-ignored).
"""

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
# The plain version run in f32 has errors of the same size; its error is
# printed beside the kernel's.
TOL = {"segsum": 1e-5, "linearize": 5e-3, "cost": 1e-5}
TOL_LINEARIZE_NO_LOSS = 1e-4
REPLACES = {
    "segsum": "tpu_ba/kernels/segsum.py:256",
    "linearize": "tpu_ba/kernels/linearize.py:261",
    "cost": "tpu_ba/kernels/linearize.py:322",
}
SOURCES = {
    "segsum": "tpu_ba_torch/csrc/segsum.cu",
    "linearize": "tpu_ba_torch/csrc/linearize.cu",
    "cost": "tpu_ba_torch/csrc/linearize.cu",
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


def err(out, ref):
    """(max abs error, max abs error / max |ref|) of an f32 result against an
    f64 reference."""
    d = (out.double() - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-300)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    from tpu_ba_torch.core import LMConfig
    from tpu_ba_torch.io.bal import make_bal_like_problem
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.kernels.linearize import (fused_cost, fused_cost_plain,
                                                fused_linearize_assemble,
                                                fused_linearize_assemble_plain)
    from tpu_ba_torch.kernels.segsum import sorted_segment_sum_t, sorted_segment_sum_t_plain
    from tpu_ba_torch.residuals.robust import ROBUST_KINDS
    from tpu_ba_torch.solver import pcg as pcg_mod
    from tpu_ba_torch.solver.lm import solve
    from tpu_ba_torch.solver.plans import build_plans

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    say("device", f"{kind}; {count} visible; torch {torch.__version__}, CUDA {torch.version.cuda}")
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
    args32 = (problem.cameras, problem.points, problem.obs_2d, problem.cam_idx,
              problem.pt_idx, problem.mask)
    args64 = (problem.cameras.double(), problem.points.double(), problem.obs_2d.double(),
              problem.cam_idx, problem.pt_idx, problem.mask)
    results = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in TOL}

    def record(name, abs_err, rel_err, what, tol=None):
        tol = TOL[name] if tol is None else tol
        if not rel_err <= tol:
            raise AssertionError(f"{name} {what}: relative error {rel_err:.3e} > {tol:.0e}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
        results[name]["max_rel_err"] = max(results[name]["max_rel_err"], rel_err)

    # K1 on the payloads of the main path: point-keyed (12 = VtV|gp per
    # linearization, 3 = matvec / back-substitution), camera-keyed (9 =
    # matvec / rhs, 81 = preconditioner blocks)
    gen = torch.Generator(device=dev).manual_seed(0)
    point_keys = (plans.pt_sorted_keys, P, plans.pt_start)
    cam_keys = (problem.cam_idx, C, plans.cam_start)
    for D, (keys, n_out, starts), side in [(12, point_keys, "point"), (3, point_keys, "point"),
                                           (9, cam_keys, "camera"), (81, cam_keys, "camera")]:
        vals = torch.randn((D, O), generator=gen, device=dev, dtype=torch.float32)
        out = sorted_segment_sum_t(vals, keys, n_out, starts)
        ref = sorted_segment_sum_t_plain(vals.double(), keys, n_out)
        a, r = err(out, ref)
        record("segsum", a, r, f"({D},{O}) {side}-keyed")
        ms = median_ms(torch, lambda: sorted_segment_sum_t(vals, keys, n_out, starts))
        pms = median_ms(torch, lambda: sorted_segment_sum_t_plain(vals, keys, n_out))
        if D in (3, 9):  # one CG iteration reduces (3, O) by point and (9, O) by camera
            results["segsum"]["ms"] += ms
            results["segsum"]["plain_ms"] += pms
        say("kernel", f"K1 segsum ({D},{O})->{n_out} {side}-keyed: rel err {r:.2e} "
                      f"(tol {TOL['segsum']:.0e}), abs {a:.2e}; {ms:.4f} ms, plain {pms:.4f} ms")
    # an empty segment comes out exactly 0
    keys = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 2, 2, 5, 5, 5, 6], dtype=torch.int32, device=dev)
    out = sorted_segment_sum_t(torch.ones((2, 6), device=dev), keys, 6, starts)
    assert out.cpu().tolist() == [[2, 0, 3, 0, 0, 1]] * 2, out

    for rname, rk in ROBUST_KINDS.items():
        kw = dict(robust_kind=rk, robust_scale=ROBUST_SCALE)
        ref = fused_linearize_assemble_plain(*args64, **kw)

        def k2_errs(out):
            parts = {"U": 0, "gc": 1, "W": 2}
            e = {k: err(out[i], ref[i]) for k, i in parts.items()}
            for k, rows in {"VtV": slice(0, 9), "gp": slice(9, 12), "rho": 12}.items():
                e[k] = err(out[3][rows], ref[3][rows])
            return e

        errs = k2_errs(fused_linearize_assemble(*args32, plans.cam_start, **kw))
        plain_errs = k2_errs(fused_linearize_assemble_plain(*args32, **kw))
        worst = max(errs, key=lambda k: errs[k][1])
        k2_tol = TOL_LINEARIZE_NO_LOSS if rk == 0 else TOL["linearize"]
        for k, (a, r) in errs.items():
            record("linearize", a, r, f"{rname} {k}", k2_tol)
        cref = fused_cost_plain(*args64, **kw).item()
        ca = abs(fused_cost(*args32, **kw).item() - cref)
        pa = abs(fused_cost_plain(*args32, **kw).item() - cref)
        record("cost", ca, ca / abs(cref), rname)
        line = (f"K2 linearize {rname}: worst rel err {errs[worst][1]:.2e} ({worst}; plain f32 "
                f"{max(v[1] for v in plain_errs.values()):.2e}; tol {k2_tol:.0e}); "
                f"K3 cost {rname}: rel err {ca / abs(cref):.2e} (plain f32 {pa / abs(cref):.2e};"
                f" tol {TOL['cost']:.0e})")
        if rname == "none":
            results["linearize"]["ms"] = median_ms(
                torch, lambda: fused_linearize_assemble(*args32, plans.cam_start, **kw))
            results["linearize"]["plain_ms"] = median_ms(
                torch, lambda: fused_linearize_assemble_plain(*args32, **kw), reps=5)
            results["cost"]["ms"] = median_ms(torch, lambda: fused_cost(*args32, **kw))
            results["cost"]["plain_ms"] = median_ms(
                torch, lambda: fused_cost_plain(*args32, **kw), reps=5)
            line += (f"; K2 {results['linearize']['ms']:.4f} ms, plain "
                     f"{results['linearize']['plain_ms']:.4f} ms; K3 {results['cost']['ms']:.4f}"
                     f" ms, plain {results['cost']['plain_ms']:.4f} ms")
        say("kernel", line)
    del ref, args64

    # 4. the main path end to end
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    cfg = LMConfig(max_iters=golden["max_iters"], cg_max_iters=golden["cg_max_iters"],
                   cg_tol=golden["cg_tol"], init_lambda=1e-4, linear_solver="schur_pcg_pallas")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    pcg_mod.reset_host_reads()
    t0 = time.perf_counter()
    res = solve(problem, cfg)
    final = res.cost.item()
    first_s = time.perf_counter() - t0
    launches = dict(_lib.launches)
    reads = dict(pcg_mod.host_reads)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the solve: {missing}")
    t0 = time.perf_counter()
    res2 = solve(problem, cfg)
    final2 = res2.cost.item()
    steady_s = time.perf_counter() - t0
    iters = int(res2.iterations)
    gap = (final - golden["final_cost"]) / golden["final_cost"]
    say("solve", f"{PROBLEM} schur_pcg_pallas f32: {int(res.iterations)} LM iterations "
                 f"({int(res.accepted)} accepted), cg_total {int(res.cg_history.sum())}; "
                 f"first call {first_s:.3f} s, steady state {steady_s:.3f} s = "
                 f"{iters / steady_s:.3f} LM it/s")
    say("solve", f"final cost {final:.6f} (repeat {final2:.6f}), golden "
                 f"{golden['final_cost']:.6f}, gap {100 * gap:+.5f}% (limit 1%); "
                 f"host reads {reads['cg']} CG + {reads['lm']} LM; peak device memory "
                 f"{peak / 2**20:.1f} MiB; launches {launches}")
    if not (math.isfinite(final) and abs(gap) < 0.01):
        raise AssertionError(f"final cost {final} is not within 1% of {golden['final_cost']}")

    for rname in ("huber", "cauchy", "arctan"):
        rcfg = LMConfig(max_iters=5, cg_max_iters=golden["cg_max_iters"], cg_tol=golden["cg_tol"],
                        init_lambda=1e-4, linear_solver="schur_pcg_pallas",
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

    # max_rel_err is the number held to TOL; max_abs_err is in the outputs'
    # own units (K2's U entries reach ~4e11, so its absolute error is large)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "max_rel_err": results[k]["max_rel_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"]} for k in TOL]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
