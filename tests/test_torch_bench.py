"""The port's benchmark harness (``tpu_ba_torch/bench/harness.py``), its
``cli.py bench`` subcommand and the byte counts of ``bench/roofline.py``, on
the CPU: the harness's line and detail, its solve and baseline bit for bit
against direct calls, its config and derived numbers against the
reference's ``bench.py``."""

import contextlib
import dataclasses
import io
import json
import math
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_ba.core import LMConfig as RefLMConfig
from tpu_ba.residuals.robust import ROBUST_KINDS as REF_ROBUST_KINDS
from tpu_ba_torch import cli
from tpu_ba_torch.bench import cpu_baseline, harness, roofline
from tpu_ba_torch.io.bal import make_bal_like_problem
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.kernels import _lib
from tpu_ba_torch.solver import lm

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

# bench.py:327-354, the reference's detail
REF_DETAIL_KEYS = (
    "problem", "solver", "n_cameras", "n_points", "n_obs", "device", "dtype", "gen_s",
    "first_call_s", "run_s", "lm_iters", "lm_accepted", "iters_per_sec", "accepted_per_sec",
    "cg_total", "initial_cost", "final_cost", "final_rmse_px", "time_to_1pct_run_s",
    "time_to_1pct_incl_first_call_s", "f64_parity", "device_memory", "roofline",
    "cost_history", "baseline", "vs_baseline_speedup")
PORT_DETAIL_KEYS = ("power_limit_w", "build_s", "launches", "pcg_forms", "host_reads",
                    "time_to_1pct_method")


def _run(main, argv):
    """(exit code, the last line of standard output) of ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines()[-1]


def _recording(calls, fn):
    """``fn``, appending (args, kwargs, result) to ``calls`` at each call."""
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        calls.append((args, kwargs, res))
        return res
    return wrapped


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """One ``bench --quick --device cpu`` run through the command line, from
    a working directory outside the repository (the goldens are found from
    the package's own path), its calls of ``solve`` and of the CPU baseline
    recorded: (exit code, last line, detail, solves, baselines)."""
    work = tmp_path_factory.mktemp("bench")
    detail_path = work / "detail.json"
    solves, baselines = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setattr(lm, "solve", _recording(solves, lm.solve))
        mp.setattr(cpu_baseline, "solve_cpu_baseline",
                   _recording(baselines, cpu_baseline.solve_cpu_baseline))
        rc, line = _run(cli.main, ["bench", "--quick", "--device", "cpu",
                                   "--detail-out", str(detail_path)])
    with open(detail_path) as fh:
        return rc, line, json.load(fh), solves, baselines


def test_the_line_has_the_four_keys_under_a_cpu_metric(quick):
    rc, line, detail, _, _ = quick
    out = json.loads(line)
    assert rc == 0
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["metric"] == "ba_iters_per_sec_ladybug_49_cpu"
    assert out["unit"] == "LM iters/s"
    assert out["value"] == detail["iters_per_sec"] > 0
    assert out["vs_baseline"] == detail["vs_baseline_speedup"] > 0


def test_the_detail_has_the_reference_keys_and_the_port_s(quick):
    _, _, detail, _, _ = quick
    assert set(REF_DETAIL_KEYS) | set(PORT_DETAIL_KEYS) <= set(detail)
    assert detail["device"] == "cpu" and detail["power_limit_w"] is None
    assert detail["build_s"] is None and detail["roofline"] is None
    assert "unavailable" in detail["device_memory"]
    # on the CPU the wrappers take their plain versions: no kernel launched
    assert set(detail["launches"]) == set(_lib.launches) and not any(
        detail["launches"].values())
    assert detail["pcg_forms"] == {"resident": 0, "streaming": 0}
    assert detail["host_reads"]["lm"] == detail["lm_iters"]
    # the golden is found from outside the repository
    parity = detail["f64_parity"]
    assert parity["golden_final_cost_f64"] == pytest.approx(20121.646702982736)
    assert abs(parity["final_cost_gap_pct"]) < 1.0


def test_the_solve_equals_a_direct_solve_bit_for_bit(quick):
    """The harness's solves are ``solve`` on the problem and ``LMConfig`` a
    caller builds directly; the first call and the three timed solves agree
    bit for bit, so a direct solve would too, and the detail reports them.
    The baseline is ``solve_cpu_baseline(max_iters=2)`` on the same problem,
    and the detail reports its result."""
    _, _, detail, solves, baselines = quick
    problem, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32, device="cpu")
    cfg = harness.build_config(harness.parse_args(["--quick"]))
    assert len(solves) == 1 + harness.TIMED_RUNS
    for (p, c), kwargs, _ in solves:
        assert c == cfg and not kwargs
        for f in dataclasses.fields(problem):
            a, b = getattr(p, f.name), getattr(problem, f.name)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    first = solves[0][2]
    for _, _, res in solves[1:]:
        assert int(res.iterations) == int(first.iterations)
        assert torch.equal(res.cost_history, first.cost_history)
        assert torch.equal(res.cg_history, first.cg_history)
        assert torch.equal(res.cameras, first.cameras) and torch.equal(res.points, first.points)
    res = solves[-1][2]
    assert detail["lm_iters"] == int(res.iterations)
    assert detail["lm_accepted"] == int(res.accepted)
    assert detail["cg_total"] == int(res.cg_history.sum())
    assert detail["cost_history"] == res.cost_history.double().tolist()
    assert detail["final_cost"] == float(res.cost)
    (args, kwargs, bl), = baselines
    assert args == (solves[0][0][0],) and kwargs == {"max_iters": 2, "time_budget_s": 300.0}
    assert detail["baseline"]["final_cost"] == bl["final_cost"]
    assert detail["baseline"]["iters_run"] == 2


def test_synthetic_problem_without_a_golden(tmp_path):
    """The synthetic branch (no golden: no parity) through the harness's own
    entry point, cut short."""
    detail_path = tmp_path / "d.json"
    rc, line = _run(harness.main, ["--problem", "synthetic", "--max-iters", "2", "--cg-iters",
                                   "10", "--baseline-iters", "1", "--device", "cpu",
                                   "--detail-out", str(detail_path)])
    with open(detail_path) as fh:
        detail = json.load(fh)
    assert rc == 0 and json.loads(line)["metric"] == "ba_iters_per_sec_synthetic_cpu"
    assert detail["f64_parity"] is None and detail["baseline"]["iters_run"] == 1
    _, gt = make_synthetic_problem(20, 500, dtype=torch.float32, device="cpu")
    assert detail["n_obs"] == gt["n_obs"] and detail["lm_iters"] == 2


def test_the_command_line_passes_its_flags_and_raises_without_a_card(monkeypatch, tmp_path):
    """``cli.py bench`` passes the flags it was given and no others, so the
    harness's defaults are the only ones."""
    seen = []
    monkeypatch.setattr(harness, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main(["bench", "--problem", "synthetic", "--device", "cpu"]) == 0
    assert cli.main(["bench"]) == 0
    assert cli.main(["bench", "--quick", "--detail-out", "d.json"]) == 0
    assert seen == [["--problem", "synthetic", "--device", "cpu"], [],
                    ["--quick", "--detail-out", "d.json"]]
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(["bench", "--problem", "synthetic"])
    assert not (tmp_path / "bench_detail_torch.json").exists()


@pytest.mark.parametrize("forcing", [0.0, 0.5])
@pytest.mark.parametrize("precond", ["jacobi", "tridiag"])
@pytest.mark.parametrize("robust", ["none", "huber", "cauchy", "arctan"])
@pytest.mark.parametrize("solver", ["schur_sparse_pallas", "schur_sparse", "schur_dense",
                                    "schur_pcg", "schur_pcg_pallas"])
def test_config_carries_over_as_in_the_reference(solver, robust, precond, forcing):
    args = harness.parse_args(["--solver", solver, "--robust", robust, "--precond", precond,
                               "--cg-forcing", str(forcing), "--robust-scale", "2.5"])
    port = harness.build_config(args)
    # bench.py:199-205
    ref = RefLMConfig(max_iters=args.max_iters, linear_solver=args.solver,
                      cg_max_iters=args.cg_iters, cg_tol=args.cg_tol,
                      cg_forcing=args.cg_forcing,
                      robust_kind=REF_ROBUST_KINDS[args.robust],
                      robust_scale=args.robust_scale, init_lambda=1e-4,
                      precond=args.precond)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_flags_keep_the_reference_defaults():
    args = harness.parse_args([])
    assert (args.problem, args.covis, args.max_iters, args.cg_iters, args.cg_tol,
            args.cg_forcing, args.baseline_iters, args.baseline_problem, args.robust,
            args.robust_scale, args.precond, args.solver) == (
        "ladybug-1723", "ring", 80, 100, 1e-4, 0.0, 2, None, "none", 1.0, "jacobi",
        "schur_sparse_pallas")
    quick = harness.parse_args(["--quick", "--problem", "venice-1778"])
    assert (quick.problem, quick.max_iters) == ("ladybug-49", 20)


def _ref_derived(hist, final_cost, iters, run_s, first_call_s, n_obs, golden):
    """bench.py:229 and 270-314 with no phase profile. ``bench.py`` computes
    these inline in its ``main``, so they cannot be called piecewise; this
    is a copy, and ``test_the_copy_matches_bench_py`` holds each of its
    formulas to the reference's text."""
    rmse = math.sqrt(2.0 * final_cost / n_obs)
    target = final_cost * 1.01
    reach = int(np.argmax(hist <= target)) + 1
    frac = reach / max(iters, 1)
    time_to_1pct_run_s = frac * run_s
    time_to_1pct_total_s = first_call_s - run_s * (1 - frac)
    parity = {
        "final_cost_gap_pct": round(
            (final_cost - golden["final_cost"]) / golden["final_cost"] * 100, 3),
        "rmse_gap_pct": round(
            (rmse - golden["final_rmse_px"]) / golden["final_rmse_px"] * 100, 3),
    }
    return rmse, reach, time_to_1pct_run_s, time_to_1pct_total_s, parity


def test_the_copy_matches_bench_py():
    """Every formula of ``_ref_derived`` stands in ``bench.py``, whitespace
    aside."""
    import inspect

    ref = "".join((Path(__file__).resolve().parents[1] / "bench.py").read_text().split())
    body = inspect.getsource(_ref_derived).split('"""')[2]
    formulas = [f for f in ("".join(line.split()) for line in body.splitlines()
                            if "=" in line and not line.strip().startswith("return"))]
    formulas.append("round((final_cost-golden[\"final_cost\"])/golden[\"final_cost\"]*100,3)")
    formulas.append("round((rmse-golden[\"final_rmse_px\"])/golden[\"final_rmse_px\"]*100,3)")
    assert len(formulas) >= 8
    for f in formulas:
        f = f.rstrip("(")
        assert f in ref, f


@pytest.mark.parametrize("hist,final_cost", [
    ([100.0, 50.0, 20.0, 10.05, 10.0, 10.0], 10.0),      # reaches 1% at the fourth
    ([9.0, 9.0, 9.0], 9.0),                              # there from the first
    ([100.0, 80.0, 60.0], 50.0),                         # never within 1%: argmax gives reach 1
])
def test_derived_numbers_follow_the_reference(hist, final_cost):
    hist = np.asarray(hist, np.float64)
    iters, run_s, first_call_s, n_obs = len(hist), 2.5, 4.0, 1234
    golden = {"final_cost": 9.8, "final_rmse_px": 0.12}
    rmse, reach, t_run, t_total, parity = _ref_derived(hist, final_cost, iters, run_s,
                                                       first_call_s, n_obs, golden)
    assert harness.final_rmse_px(final_cost, n_obs) == rmse
    assert harness.reach_index(hist, final_cost) == reach
    assert harness.time_to_1pct(reach, iters, run_s, first_call_s) == {
        "time_to_1pct_run_s": t_run, "time_to_1pct_incl_first_call_s": t_total}
    got = harness.f64_parity(golden, final_cost, rmse)
    # the port keeps the gaps unrounded; the reference rounds them to 0.001%
    for k in ("final_cost_gap_pct", "rmse_gap_pct"):
        assert round(got[k], 3) == parity[k]
    assert got["final_cost_gap_pct"] == pytest.approx((final_cost - 9.8) / 9.8 * 100, rel=1e-12)
    assert harness.f64_parity(None, final_cost, rmse) is None


@pytest.fixture(scope="module")
def ladybug49():
    problem, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32, device="cpu")
    cfg = harness.build_config(harness.parse_args(["--quick"]))
    plans, pair_plan = lm.build_solver_plans(problem, cfg)
    return problem, plans, pair_plan


def test_k1_and_k3_bytes_at_ladybug_49_against_a_hand_count(ladybug49):
    problem, plans, _ = ladybug49
    C, P, O = problem.n_cameras, problem.n_points, problem.obs_2d.shape[0]
    assert (C, P, O) == (49, 7776, 32768)
    # K1, VtV|gp by point through perm: 12 rows of values, perm and the P+1
    # starts read (4 bytes each), 12 rows of sums written
    assert roofline.segsum_counts(12, O, P, perm=True) == (
        4 * 12 * O + 4 * O + 4 * (P + 1) + 4 * 12 * P, 12 * O)
    assert roofline.segsum_counts(9, O, C) == (4 * 9 * O + 4 * (C + 1) + 4 * 9 * C, 9 * O)
    # in f64 the values and sums take 8 bytes each, the int32 starts 4
    assert roofline.segsum_counts(9, O, C, itemsize=8) == (
        8 * 9 * O + 4 * (C + 1) + 8 * 9 * C, 9 * O)
    # K3: cameras, points, observations and the point index (4 bytes), the
    # mask (1 byte), its pieces (3 int32 each) read; one float written
    n_pieces = plans.lin_sched.pieces.shape[1]
    k3 = 4 * 9 * C + 4 * 3 * P + 4 * 2 * O + 4 * O + O + 4 * 3 * n_pieces + 4
    assert roofline.lin_counts(C, P, O, plans.lin_sched)[1] == (k3, 100 * O)


def test_each_launch_s_bytes_at_ladybug_49(ladybug49):
    """The bytes a wrapper adds at a launch equal the kernel's counts on the
    plan. K4 and K8 move theirs once a call, whatever their CG iterations:
    the band and U_t (or Ul and the preconditioner) read once, b, x0 and x
    (9·C each) once."""
    _, _, plan = ladybug49
    C = plan.n_cameras
    assert plan.n_segments == plan.k_band                # no leftover segments
    assert roofline.pairblocks_bytes(plan.n_pairs, plan.k_pad) == \
        roofline.pairblocks_counts(plan)[0]
    assert roofline.trackband_bytes(plan.track) == roofline.trackband_counts(plan)[0]
    k4 = 4 * (81 * plan.k_band + 27 * C + 81 * plan.c_pad + 2)
    assert roofline.pcg_band_bytes(plan) == k4
    assert roofline.pcg_band_counts(plan, 1)[0] == roofline.pcg_band_counts(plan, 55)[0] == k4
    for levels in (0, 6):
        k8 = 4 * (81 * plan.k_band + 27 * C + 81 * C * (2 + 2 * levels) + 1)
        assert roofline.pcg_band_given_bytes(plan, levels) == k8
        assert roofline.pcg_band_given_counts(plan, levels, 9)[0] == k8


def test_k6_bytes_split_over_its_degree_buckets():
    """K6 launches once per degree bucket; the first launch carries what the
    call reads and writes once (the offsets' index, λ, the band)."""
    inc = [torch.zeros(7, dtype=torch.int32), torch.zeros(11, dtype=torch.int32)]
    layout = types.SimpleNamespace(degrees=(2, 3), pt_pad=(128, 256), inc=inc, c_pad=64,
                                   n_off_loc=5, n_out=17 * 64)
    got = roofline.slotband_bytes(layout)
    bucket = [4 * (29 * 2 * 128 + 9 * 128 + 65 + 7), 4 * (29 * 3 * 256 + 9 * 256 + 65 + 11)]
    assert got == [bucket[0] + 4 * (5 + 1 + 81 * 17 * 64), bucket[1]]


def test_the_wrappers_count_launches_and_bytes(monkeypatch):
    monkeypatch.setattr(_lib, "launches", dict.fromkeys(_lib.launches, 0))
    monkeypatch.setattr(_lib, "bytes_moved", dict.fromkeys(_lib.launches, 0))
    _lib.count("segsum", 100)
    _lib.count("segsum", 20)
    _lib.count("pcg_band", 7)
    assert _lib.launches["segsum"] == 2 and _lib.bytes_moved["segsum"] == 120
    assert _lib.launches["pcg_band"] == 1 and _lib.bytes_moved["pcg_band"] == 7
    _lib.reset_launches()
    assert not any(_lib.launches.values()) and not any(_lib.bytes_moved.values())


def test_solve_roofline_sums_the_kernels_bytes():
    by_kernel = {"segsum": 3_000_000, "linearize": 2_000_000, "pcg_band": 5_000_000}
    line = roofline.solve_roofline(by_kernel, 20, 0.5, 700.0)
    assert line["bytes_total"] == 10_000_000
    assert line["bytes_per_lm_iter"] == 500_000
    assert line["share_of_peak"] == 10_000_000 / 3.35e12 / 0.5
    assert line["achieved_gbps"] == 10_000_000 / 0.5 / 1e9
    assert line["power_limit_w"] == 700.0 and line["bytes_by_kernel"] is by_kernel
