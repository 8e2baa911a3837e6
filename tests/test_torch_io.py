"""The port's problem generators, problem bridge, CLI, f32 accuracy against
the committed golden, and its independence from JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ba.io.bal import make_bal_like_problem as ref_bal_like
from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba_torch.core import (LMConfig, make_problem, problem_from_numpy,
                               problem_to_numpy)
from tpu_ba_torch.io.bal import make_bal_like_problem
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.posegraph import solve_pose_graph
from tpu_ba_torch.solver.lm import solve

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of a thread per core oversubscribes the machine
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")
MODULES = [
    "tpu_ba_torch", "tpu_ba_torch.core", "tpu_ba_torch.residuals.robust",
    "tpu_ba_torch.geometry.rotations", "tpu_ba_torch.geometry.cameras",
    "tpu_ba_torch.residuals.reprojection", "tpu_ba_torch.jacobians.analytic",
    "tpu_ba_torch.io.synthetic", "tpu_ba_torch.io.bal", "tpu_ba_torch.kernels.segsum",
    "tpu_ba_torch.kernels.linearize", "tpu_ba_torch.solver.plans", "tpu_ba_torch.solver.normal",
    "tpu_ba_torch.solver.batched_linalg", "tpu_ba_torch.solver.pcg", "tpu_ba_torch.solver.schur",
    "tpu_ba_torch.solver.lm", "tpu_ba_torch.cli", "tpu_ba_torch.solver.pairs",
    "tpu_ba_torch.solver.tracks", "tpu_ba_torch.solver.slots", "tpu_ba_torch.kernels.pcg_band",
    "tpu_ba_torch.kernels.pairblocks", "tpu_ba_torch.kernels.trackband",
    "tpu_ba_torch.kernels.slotband", "tpu_ba_torch.kernels._lib",
    "tpu_ba_torch.solver.tridiag", "tpu_ba_torch.solver.dense",
    "tpu_ba_torch.checkpoint", "tpu_ba_torch.checkpoint.state", "tpu_ba_torch.io.native",
    "tpu_ba_torch.io.scene", "tpu_ba_torch.bench", "tpu_ba_torch.bench.metrics",
    "tpu_ba_torch.jacobians", "tpu_ba_torch.jacobians.autodiff", "tpu_ba_torch.viz",
    "tpu_ba_torch.geometry", "tpu_ba_torch.geometry.se3", "tpu_ba_torch.residuals",
    "tpu_ba_torch.io", "tpu_ba_torch.io.sequences", "tpu_ba_torch.solver",
    "tpu_ba_torch.posegraph", "tpu_ba_torch.posegraph.solver", "tpu_ba_torch.bench.ate",
    "tpu_ba_torch.sfm", "tpu_ba_torch.sfm.features", "tpu_ba_torch.sfm.matching",
    "tpu_ba_torch.sfm.triangulate", "tpu_ba_torch.sfm.twoview", "tpu_ba_torch.sfm.pnp",
    "tpu_ba_torch.sfm.incremental", "tpu_ba_torch.sfm.posegraph_bridge",
    "tpu_ba_torch.sharding", "tpu_ba_torch.sharding.distributed",
    "tpu_ba_torch.sharding.multihost", "tpu_ba_torch.sharding.launch",
    "tpu_ba_torch.solver.collective", "tpu_ba_torch.bench.cpu_baseline",
    "tpu_ba_torch.bench.harness", "tpu_ba_torch.bench.roofline",
]


def _assert_identical(port, ref):
    for k in FIELDS:
        a, b = getattr(port, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert (port.n_cameras, port.n_points, port.n_obs, port.model) == \
        (ref.n_cameras, ref.n_points, ref.n_obs, ref.model)


def test_bal_like_generator_byte_identical(tmp_path, monkeypatch):
    """Each package generates ladybug-49 from scratch in its own working
    directory: the same bytes, and the same cache file contents."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    ref, ref_gt = ref_bal_like("ladybug-49", dtype=np.float32)
    monkeypatch.chdir(tmp_path / "port")
    port, gt = make_bal_like_problem("ladybug-49", dtype=torch.float32, device="cpu")
    _assert_identical(port, ref)
    assert gt["n_obs"] == ref_gt["n_obs"] == 31843
    name = os.listdir(tmp_path / "ref" / "data" / "cache")
    assert name == os.listdir(tmp_path / "port" / "data" / "cache")
    a = np.load(tmp_path / "ref" / "data" / "cache" / name[0])
    b = np.load(tmp_path / "port" / "data" / "cache" / name[0])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k
    # either package's cache serves the other
    monkeypatch.chdir(tmp_path / "ref")
    _assert_identical(make_bal_like_problem("ladybug-49", dtype=torch.float32,
                                            device="cpu")[0], ref)
    with pytest.raises(ValueError, match="covis"):
        make_bal_like_problem("ladybug-49", covis="grid", device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_generator_byte_identical(dtype):
    ref, _ = ref_synthetic(10, 100, obs_per_point=4, seed=11, dtype=dtype, pad_multiple=128)
    port, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, pad_multiple=128,
                                     device="cpu",
                                     dtype={np.float32: torch.float32,
                                            np.float64: torch.float64}[dtype])
    _assert_identical(port, ref)


def test_problem_bridge_round_trip():
    ref, _ = ref_synthetic(6, 40, obs_per_point=4, seed=3, dtype=np.float64, pad_multiple=64)
    arrays = {k: np.asarray(getattr(ref, k)) for k in FIELDS}
    port = problem_from_numpy(arrays, n_cameras=6, n_points=40, n_obs=ref.n_obs,
                              dtype=torch.float64, device="cpu")
    _assert_identical(port, ref)
    back = problem_to_numpy(port)
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert back["n_obs"] == ref.n_obs and back["model"] == "bal"
    # padding repeats the last index, so cam_idx stays sorted
    p = make_problem(arrays["cameras"], arrays["points"], arrays["obs_2d"][:ref.n_obs],
                     arrays["cam_idx"][:ref.n_obs][::-1], arrays["pt_idx"][:ref.n_obs][::-1],
                     pad_multiple=64, dtype=torch.float64, device="cpu")
    assert np.all(np.diff(p.cam_idx.numpy()) >= 0)
    assert p.cam_idx[-1] == p.cam_idx[ref.n_obs - 1] and p.pt_idx[-1] == p.pt_idx[ref.n_obs - 1]
    with pytest.raises(ValueError):
        problem_from_numpy(dict(arrays, cam_idx=arrays["cam_idx"][::-1]), n_cameras=6,
                           n_points=40, n_obs=ref.n_obs, device="cpu")


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    # torch's own error: AssertionError on a CPU-only build, RuntimeError
    # on a CUDA build with no card
    with pytest.raises((AssertionError, RuntimeError)):
        make_synthetic_problem(4, 10, device="cuda")


def _entry_points():
    z = np.zeros
    return {
        "make_problem": lambda **kw: make_problem(z((2, 9)), z((3, 3)), z((4, 2)), [0, 0, 1, 1],
                                                  [0, 1, 1, 2], **kw),
        "problem_from_numpy": lambda **kw: problem_from_numpy(
            dict(cameras=z((2, 9)), points=z((3, 3)), obs_2d=z((4, 2)), cam_idx=[0, 0, 1, 1],
                 pt_idx=[0, 1, 1, 2], mask=[True] * 4), n_cameras=2, n_points=3, n_obs=4, **kw),
        "make_synthetic_problem": lambda **kw: make_synthetic_problem(4, 10, **kw)[0],
        "make_bal_like_problem": lambda **kw: make_bal_like_problem("ladybug-49", **kw)[0],
        "solve_pose_graph": lambda **kw: solve_pose_graph(
            z((3, 6)), [1, 2], [0, 1], z((2, 6)), max_iters=1, **kw)[0],
    }


def _host_entry_points():
    """Entry points that return numpy: the device shows only in where they run."""
    from tpu_ba_torch.io.sequences import render_blob_sequence
    from tpu_ba_torch.sfm.incremental import SfMConfig, SfMResult, run_incremental_sfm
    from tpu_ba_torch.sfm.posegraph_bridge import refine_sfm_with_pose_graph

    def sfm(**kw):
        frames, gt = render_blob_sequence(n_frames=3, n_points=100, H=120, W=160, fx=140.0,
                                          fy=140.0, seed=1, device="cpu")
        return run_incremental_sfm(frames, gt["K"], SfMConfig(max_corners=128,
                                                              ransac_hypotheses=64, ba_iters=1,
                                                              final_ba_iters=1), **kw)

    def bridge(**kw):
        res = SfMResult(poses=np.zeros((3, 6)), points=np.zeros((1, 3)), track_frame=np.zeros(1),
                        track_point=np.zeros(1), track_xy=np.zeros((1, 2)),
                        registered=np.ones(3, bool), final_cost=0.0, report={})
        return refine_sfm_with_pose_graph(res, max_iters=1, **kw)

    return {
        "render_blob_sequence": lambda **kw: render_blob_sequence(n_frames=1, n_points=5, H=24,
                                                                  W=32, **kw),
        "run_incremental_sfm": sfm,
        "refine_sfm_with_pose_graph": bridge,
    }


@pytest.mark.parametrize("name", sorted(_host_entry_points()))
def test_host_result_entry_points_default_to_the_card(name):
    """Entry points whose results are numpy arrays also run on the card by
    default: without one they raise before any work, ``device="cpu"`` runs."""
    call = _host_entry_points()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    call(device="cpu")


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_default_device_is_the_card_and_raises_without_one(name, tmp_path, monkeypatch):
    """An entry point runs on the CUDA card unless the caller asks for the
    CPU: without a card the default raises a clear error (before any work),
    it does not carry on on the CPU; ``device="cpu"`` works."""
    monkeypatch.chdir(tmp_path)
    call = _entry_points()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
        assert not os.listdir(tmp_path)           # failed before generating anything
    assert call(device="cpu").device.type == "cpu"


def test_cli_default_device_raises_without_a_card():
    from tpu_ba_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["ba", "--problem", "synthetic", "--max-iters", "1"])


@pytest.mark.parametrize("argv", [["sfm", "--frames", "2", "--points", "10"],
                                  ["posegraph", "--nodes", "4"]])
def test_cli_subcommands_default_device_raises_without_a_card(argv):
    from tpu_ba_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(argv)


def test_f32_ladybug49_within_1pct_of_f64_golden(tmp_path, monkeypatch):
    """As tests/test_accuracy.py asserts for tpu_ba: the port's f32 solve
    (schur_pcg_pallas; the kernels' plain versions on the CPU) at the
    golden's config lands within 1% of the f64 golden."""
    with open(os.path.join(REPO, "data", "goldens", "ladybug-49.json")) as fh:
        golden = json.load(fh)
    monkeypatch.chdir(tmp_path)
    problem, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32, device="cpu")
    cfg = LMConfig(max_iters=golden["max_iters"], cg_max_iters=golden["cg_max_iters"],
                   cg_tol=golden["cg_tol"], linear_solver="schur_pcg_pallas", init_lambda=1e-4)
    res = solve(problem, cfg)
    gap = abs(float(res.cost) - golden["final_cost"]) / golden["final_cost"]
    assert gap < 0.01, (float(res.cost), golden["final_cost"], gap)


def test_cli_ba_runs(capsys):
    from tpu_ba_torch.cli import main

    assert main(["ba", "--problem", "synthetic", "--max-iters", "3",
                 "--solver", "schur_pcg_pallas", "--robust", "huber", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iterations"] == 3 and out["final_cost"] < out["initial_cost"]
    assert out["solver"] == "schur_pcg_pallas" and out["device"] == "cpu"
    assert main(["ba", "--problem", "synthetic", "--max-iters", "3", "--solver",
                 "schur_sparse_pallas", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solver"] == "schur_sparse_pallas" and out["final_cost"] < out["initial_cost"]


@pytest.mark.parametrize("solver,precond", [("schur_sparse_pallas", "tridiag"),
                                            ("schur_dense", "jacobi"),
                                            ("schur_dense_pallas", "jacobi"), ("dense", "jacobi")])
def test_cli_ba_runs_every_tier_and_preconditioner(capsys, solver, precond):
    from tpu_ba_torch.cli import main

    assert main(["ba", "--problem", "synthetic", "--max-iters", "3", "--solver", solver,
                 "--precond", precond, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solver"] == solver and out["precond"] == precond
    # f32 at λ₀ = 1e-4: three retries may all break down and be rejected
    assert out["iterations"] == 3 and out["final_cost"] <= out["initial_cost"]
    with pytest.raises(SystemExit):
        main(["ba", "--problem", "synthetic", "--precond", "ilu", "--device", "cpu"])


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by tests/conftest.py)
    every module of the port imports without bringing in JAX, the reference
    package or ``safetensors`` (which the card's machine lacks)."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'tpu_ba', 'safetensors') or m.startswith(('jax.', 'tpu_ba.', 'safetensors.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
