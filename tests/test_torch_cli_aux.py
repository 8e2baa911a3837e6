"""The port's ``cli.py ba`` with the flags of this slice, its metrics log
and profiler trace, the plots, and the autodiff Jacobian oracle against
``tpu_ba``'s and against the port's analytic blocks (1e-10 in f64)."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_ba.bench.metrics import MetricsLogger as RefMetricsLogger
from tpu_ba.jacobians.autodiff import jacobian_blocks_bal_autodiff as ref_autodiff
from tpu_ba_torch.bench.metrics import MetricsLogger, profile_trace
from tpu_ba_torch.checkpoint import load_checkpoint
from tpu_ba_torch.cli import main
from tpu_ba_torch.core import LMConfig
from tpu_ba_torch.io.bal import save_bal
from tpu_ba_torch.io.scene import load_scene
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.jacobians import jacobian_blocks_bal, jacobian_blocks_bal_autodiff
from tpu_ba_torch.solver.lm import solve
from tpu_ba_torch.viz import plot_convergence, plot_reprojection, plot_scene

torch.set_num_threads(1)

SOLVE = ["--solver", "schur_sparse_pallas", "--cg-iters", "100", "--cg-tol", "1e-4",
         "--device", "cpu"]


def _problem(dtype=torch.float32, **kw):
    return make_synthetic_problem(8, 120, obs_per_point=4, seed=17, pad_multiple=64, dtype=dtype,
                                  device="cpu", **kw)[0]


def _run(capsys, *args):
    assert main(["ba", *args]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_ba_with_every_new_flag(tmp_path, capsys):
    """--bal-file with --metrics, --checkpoint(-every), --save-scene and the
    three plots; then --scene reads the saved scene back."""
    p = _problem()
    bal = str(tmp_path / "p.txt")
    save_bal(bal, p)
    t = {k: str(tmp_path / k) for k in ("metrics.jsonl", "ck", "out.npz", "scene.png",
                                         "conv.png", "reproj.png")}
    out = _run(capsys, "--bal-file", bal, "--max-iters", "6", *SOLVE, "--metrics",
               t["metrics.jsonl"], "--checkpoint", t["ck"], "--checkpoint-every", "2",
               "--save-scene", t["out.npz"], "--plot-scene", t["scene.png"],
               "--plot-convergence", t["conv.png"], "--plot-reproj", t["reproj.png"])
    assert out["problem"] == bal and out["iterations"] == 6
    assert out["final_cost"] < out["initial_cost"] and out["device"] == "cpu"
    res = solve(p, LMConfig(max_iters=6, cg_max_iters=100, cg_tol=1e-4,
                            linear_solver="schur_sparse_pallas"))
    assert out["final_cost"] == float(res.cost)
    events = [json.loads(line) for line in open(t["metrics.jsonl"])]
    assert events[-1]["event"] == "lm_solve" and events[-1]["label"] == bal
    assert events[-1]["final_cost"] == out["final_cost"]
    ck = load_checkpoint(t["ck"])
    assert ck["iteration"] == 6 and ck["cost"] == out["final_cost"]
    assert sorted(ck["extra_tensors"]) == ["gnorm0", "nu", "warm_dxc"]
    np.testing.assert_array_equal(ck["cameras"], res.cameras.numpy())
    scene = load_scene(t["out.npz"], pad_multiple=64, device="cpu")
    assert torch.equal(scene.cameras, res.cameras) and torch.equal(scene.points, res.points)
    assert torch.equal(scene.obs_2d, p.obs_2d) and torch.equal(scene.pt_idx, p.pt_idx)
    for k in ("scene.png", "conv.png", "reproj.png"):
        assert os.path.getsize(t[k]) > 1024, k
    again = _run(capsys, "--scene", t["out.npz"], "--max-iters", "2", *SOLVE)
    assert again["initial_cost"] == pytest.approx(out["final_cost"], rel=1e-6)


def test_cli_resume_continues_the_uninterrupted_run(tmp_path, capsys):
    """3 iterations with --checkpoint, then --resume to 8: the 8-iteration
    run's cost and parameters, bit for bit."""
    bal = str(tmp_path / "p.txt")
    save_bal(bal, _problem())
    common = ["--bal-file", bal, *SOLVE]
    full = _run(capsys, *common, "--max-iters", "8", "--save-scene", str(tmp_path / "full.npz"))
    part = _run(capsys, *common, "--max-iters", "3", "--checkpoint", str(tmp_path / "ck"))
    assert part["iterations"] == 3
    res = _run(capsys, *common, "--max-iters", "8", "--resume", str(tmp_path / "ck"),
               "--save-scene", str(tmp_path / "resumed.npz"))
    assert res["iterations"] == full["iterations"] == 8
    assert res["final_cost"] == full["final_cost"]
    a = load_scene(str(tmp_path / "full.npz"), device="cpu")
    b = load_scene(str(tmp_path / "resumed.npz"), device="cpu")
    assert torch.equal(a.cameras, b.cameras) and torch.equal(a.points, b.points)


def test_metrics_logger_writes_the_reference_records(tmp_path):
    p = _problem()
    res = solve(p, LMConfig(max_iters=3, linear_solver="schur_pcg"))
    logs = {}
    for name, cls in (("port", MetricsLogger), ("tpu_ba", RefMetricsLogger)):
        log = cls(str(tmp_path / f"{name}.jsonl"))
        log.log("start", problem="p")
        # the reference's logger reads numpy; the port's takes the tensors
        log.log_lm_result(res if name == "port" else _as_numpy(res), wall_s=1.5, label="p")
        log.close()
        logs[name] = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
    for a, b in zip(logs["port"], logs["tpu_ba"], strict=True):
        a.pop("t"), b.pop("t")
        assert a == b
    assert logs["port"][-1]["event"] == "lm_solve" and len(logs["port"][-1]["cost_history"]) == 3
    MetricsLogger(None).log("nothing")          # no path: records nothing


def _as_numpy(res):
    import dataclasses

    return type("R", (), {f.name: getattr(res, f.name).numpy()
                          for f in dataclasses.fields(res)})()


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        torch.ones(64).cumsum(0).sum().item()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces and os.path.getsize(tmp_path / traces[0]) > 0
    with profile_trace(None):                   # no logdir: no trace
        pass


@pytest.mark.parametrize("plot", ["scene", "convergence", "reprojection"])
def test_plots_render(tmp_path, plot):
    p = _problem()
    res = solve(p, LMConfig(max_iters=3, linear_solver="schur_pcg"))
    path = str(tmp_path / f"{plot}.png")
    if plot == "scene":
        assert plot_scene(res.cameras, res.points, path, max_points=50) == path
    elif plot == "convergence":
        assert plot_convergence(res, path) == path
    else:
        assert plot_reprojection(p, res.cameras, res.points, path, camera=1) == path
    assert os.path.getsize(path) > 1024


@pytest.mark.parametrize("angle", [1.0, 1e-8, 1e-12])
def test_autodiff_blocks_match_reference_and_analytic(angle):
    """Against tpu_ba's jax.jacfwd blocks at 1e-10 in f64, rotations scaled
    by ``angle`` and camera 0's at θ = 0. Against the port's analytic blocks
    at 1e-10 too, except at θ ≈ 1e-8: below θ² = 1e-12 the analytic blocks
    switch to the first-order −[X]×, off by O(θ), which the reference holds
    to rtol 1e-5, atol 1e-6 (tests/test_jacobians.py); so is it here."""
    p = _problem(torch.float64)
    cams = p.cameras.clone()
    cams[:, :3] *= angle
    cams[0, :3] = 0.0
    args = (cams, p.points, p.obs_2d, p.cam_idx, p.pt_idx, p.mask)
    got = jacobian_blocks_bal_autodiff(*args)
    ref = ref_autodiff(*(a.numpy() for a in args))
    analytic = jacobian_blocks_bal(*args)
    tol = dict(rtol=1e-5, atol=1e-6) if angle == 1e-8 else dict(rtol=1e-10, atol=1e-10)
    for g, r, a, name in zip(got, ref, analytic, ("r", "Jc", "Jp")):
        assert tuple(g.shape) == np.asarray(r).shape == tuple(a.shape), name
        scale = max(float(a.abs().max()), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, err_msg=name)
    masked = ~p.mask
    assert masked.any() and not got[1][:, :, masked].any() and not got[0][:, masked].any()
