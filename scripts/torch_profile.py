#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's LM solve on one CUDA card.

    python3 scripts/torch_profile.py

1. Whole solves of the ladybug-1723 ring stand-in at its golden config
   (data/goldens/ladybug-1723.json, f32, λ₀ 1e-4): the sparse-Schur tier
   with the kernels (``schur_sparse_pallas``) under both preconditioners
   (block-Jacobi: K4; ``tridiag``: K8) and the two matrix-free tiers taking
   turns three times after one warm-up solve each, so that the tiers are
   compared within one process on one card: wall seconds up to the final
   cost's device→host read, LM it/s, cg_total, host reads, final cost and
   its gap to the golden.
2. Ten LM iterations of ``schur_sparse_pallas`` (block-Jacobi, then
   ``tridiag``) and then of ``schur_pcg_pallas`` under torch.profiler. Device time is summed over the
   kernel and memcpy events only: an aten op's own "self CUDA" time repeats
   the time of the kernels it launched, so a sum over every row counts those
   kernels twice. Printed: the device total, its share of the profiled wall
   clock (busy) and the rest (idle), the top kernels, the same time grouped
   by the aten op that launched it (kernels launched outside any aten op,
   the hand-written ones called through ctypes, form their own group), and
   the host's launch and synchronisation calls.
3. The banded PCG (K4) beside the host-loop PCG of its plain version over
   band sizes from inside the card's L2 to ten times beyond it, on
   synthetic diagonally dominant bands (random blocks, no problem behind
   them): milliseconds per CG iteration of each, from runs of two fixed
   lengths, and the two results after 5 iterations against each other.
4. venice-1778 with community covisibility (a non-banded plan, about 10 GB of
   device memory) at its golden config through ``schur_sparse_pallas``: one
   warm-up solve, two timed solves, and five LM iterations under the
   profiler.
"""

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = "ladybug-1723"
REPEATS = 3
PROFILE_ITERS = 10
# (cameras, band offsets 0..w-1) of the synthetic bands of phase 3
BAND_SWEEP = ((1723, 13), (30011, 3), (30011, 13), (120011, 13))


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
    from tpu_ba_torch.solver import pcg as pcg_mod
    from tpu_ba_torch.solver.lm import solve

    with open(os.path.join("data", "goldens", f"{PROBLEM}.json")) as fh:
        golden = json.load(fh)
    problem, _ = make_bal_like_problem(PROBLEM, dtype=torch.float32, device="cuda")

    def cfg(tier, iters=None, gold=golden):
        # "tridiag" names the sparse tier with the block-tridiagonal preconditioner
        precond = "tridiag" if tier == "tridiag" else "jacobi"
        solver = "schur_sparse_pallas" if tier == "tridiag" else tier
        return LMConfig(max_iters=gold["max_iters"] if iters is None else iters,
                        cg_max_iters=gold["cg_max_iters"], cg_tol=gold["cg_tol"],
                        init_lambda=1e-4, linear_solver=solver, precond=precond)

    def timed_solve(prob, tier, gold, label):
        torch.cuda.synchronize()
        pcg_mod.reset_host_reads()
        t0 = time.perf_counter()
        res = solve(prob, cfg(tier, gold=gold))
        cost = res.cost.item()
        s = time.perf_counter() - t0
        gap = (cost - gold["final_cost"]) / gold["final_cost"]
        print(f"[solve] {label}: {s} s, {int(res.iterations) / s} LM it/s, "
              f"cg_total {int(res.cg_history.sum())}, accepted {int(res.accepted)}, "
              f"host reads {dict(pcg_mod.host_reads)}, cost {cost} (gap {100 * gap:+.5f}%)",
              flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(f"[device] {smi.stdout.strip()}; torch {torch.__version__}", flush=True)

    tiers = ("schur_sparse_pallas", "tridiag", "schur_pcg_pallas", "schur_pcg")
    for tier in tiers:
        solve(problem, cfg(tier)).cost.item()
    for rep in range(REPEATS):
        for tier in tiers:
            timed_solve(problem, tier, golden, f"{tier} repeat {rep}")

    for tier in ("schur_sparse_pallas", "tridiag", "schur_pcg_pallas"):
        profile(torch, DeviceType, solve, problem, cfg(tier, PROFILE_ITERS), tier)
    del problem
    for n_cameras, width in BAND_SWEEP:
        band_sweep(torch, n_cameras, width)

    with open(os.path.join("data", "goldens", "venice-1778-community.json")) as fh:
        vgold = json.load(fh)
    t0 = time.perf_counter()
    venice, _ = make_bal_like_problem("venice-1778", covis="community", dtype=torch.float32,
                                      device="cuda")
    print(f"[venice] generated in {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    solve(venice, cfg("schur_sparse_pallas", gold=vgold)).cost.item()
    print(f"[venice] first solve, plans included: {time.perf_counter() - t0} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20} MiB", flush=True)
    for rep in range(2):
        timed_solve(venice, "schur_sparse_pallas", vgold, f"venice-1778-community repeat {rep}")
    profile(torch, DeviceType, solve, venice, cfg("schur_sparse_pallas", 5, vgold),
            "venice-1778-community schur_sparse_pallas")
    return 0


def event_ms(torch, fn, reps):
    """Median over ``reps`` calls of ``fn`` (after one warm-up), by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def band_sweep(torch, n_cameras, width):
    """K4 and its plain version on a synthetic band of ``width`` offsets."""
    from types import SimpleNamespace

    from tpu_ba_torch.kernels.pcg_band import band_l2_bytes, pcg_banded, pcg_banded_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n_cameras + width)
    C, c_pad = n_cameras, -(-(n_cameras + 5) // 128) * 128
    offsets = tuple(range(width))
    plan = SimpleNamespace(
        n_cameras=C, c_pad=c_pad, band_offsets=offsets, banded=True, n_heavy_pts=0,
        band_offsets_t=torch.tensor(offsets, dtype=torch.int32, device=dev),
        k_band=width * c_pad, n_segments=width * c_pad, k_pad=width * c_pad)
    # T blocks small against U = (width + 1)·I, zero where camera c + off does
    # not exist; the offset-0 block symmetric: S = U − T is positive definite
    blk = 0.03 * torch.randn((9, 9, width, c_pad), generator=gen, device=dev)
    blk[:, :, 0] = 0.5 * (blk[:, :, 0] + blk[:, :, 0].transpose(0, 1))
    cam = torch.arange(c_pad, device=dev)
    for o in offsets:
        blk[:, :, o, cam + o >= C] = 0.0
    blk = blk.reshape(81, width * c_pad).contiguous()
    U_t = torch.zeros((81, c_pad), device=dev)
    U_t[0::10, :C] = width + 1.0
    b = torch.randn((C, 9), generator=gen, device=dev)
    kw = dict(U_t=U_t, lam=torch.zeros((), device=dev), tol=0.0, diag_floor=1e-6, diag_ceil=1e32)

    def run(fn, iters):
        return fn(blk, None, None, b, plan, max_iters=iters, **kw)

    x, k, ok = run(pcg_banded, 5)
    xp, kp, okp = run(pcg_banded_plain, 5)
    rel = ((x - xp).abs().max() / xp.abs().max()).item()
    if not (int(k) == int(kp) == 5 and bool(ok) and bool(okp) and rel <= 1e-4):
        raise AssertionError(f"band sweep C={C}, {width} offsets: kernel {int(k)} iterations ok "
                             f"{bool(ok)}, plain {int(kp)} ok {bool(okp)}, x apart by {rel}")
    k_ms = (event_ms(torch, lambda: run(pcg_banded, 55), 5)
            - event_ms(torch, lambda: run(pcg_banded, 5), 5)) / 50.0
    p_ms = (event_ms(torch, lambda: run(pcg_banded_plain, 15), 3)
            - event_ms(torch, lambda: run(pcg_banded_plain, 5), 3)) / 10.0
    print(f"[band] {C} cameras, {width} offsets, working set "
          f"{band_l2_bytes(plan) / 2**20:.1f} MiB: K4 {k_ms} ms a CG iteration, host-loop plain "
          f"version {p_ms} ms a CG iteration ({p_ms / k_ms:.1f}x); x after 5 iterations apart "
          f"by {rel:.2e} of max|x|", flush=True)


def profile(torch, DeviceType, solve, problem, pcfg, tier):
    """PROFILE_ITERS LM iterations of ``tier`` under torch.profiler."""
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
    print(f"[profile] {tier}, {int(res.iterations)} LM iterations, cg_total "
          f"{int(res.cg_history.sum())}: wall {wall_ms} ms, device {device_ms} ms "
          f"(kernel and memcpy events), busy {100 * device_ms / wall_ms}%, idle "
          f"{100 - 100 * device_ms / wall_ms}%", flush=True)
    for title, table in (("kernel", by_kernel), ("aten op", by_op)):
        print(f"[profile] device time by {title}:")
        for name, (us, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:20]:
            print(f"  {us / 1e3:9.3f} ms {100 * us / device_us:5.1f}%  x{n:6d}  {name[:100]}")
    host = {e.key: (e.count, e.self_cpu_time_total) for e in prof.key_averages()
            if e.key.startswith("cuda")}
    for name, (n, us) in sorted(host.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile] host call {name}: x{n}, {us / 1e3:.3f} ms of CPU time")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))


if __name__ == "__main__":
    sys.exit(main())
