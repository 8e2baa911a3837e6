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
    "tpu_ba_torch.solver.lm", "tpu_ba_torch.cli",
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
    port, gt = make_bal_like_problem("ladybug-49", dtype=torch.float32)
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
    _assert_identical(make_bal_like_problem("ladybug-49", dtype=torch.float32)[0], ref)
    with pytest.raises(NotImplementedError, match="item 7"):
        make_bal_like_problem("ladybug-49", covis="community")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_generator_byte_identical(dtype):
    ref, _ = ref_synthetic(10, 100, obs_per_point=4, seed=11, dtype=dtype, pad_multiple=128)
    port, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, pad_multiple=128,
                                     dtype={np.float32: torch.float32,
                                            np.float64: torch.float64}[dtype])
    _assert_identical(port, ref)


def test_problem_bridge_round_trip():
    ref, _ = ref_synthetic(6, 40, obs_per_point=4, seed=3, dtype=np.float64, pad_multiple=64)
    arrays = {k: np.asarray(getattr(ref, k)) for k in FIELDS}
    port = problem_from_numpy(arrays, n_cameras=6, n_points=40, n_obs=ref.n_obs,
                              dtype=torch.float64)
    _assert_identical(port, ref)
    back = problem_to_numpy(port)
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert back["n_obs"] == ref.n_obs and back["model"] == "bal"
    # padding repeats the last index, so cam_idx stays sorted
    p = make_problem(arrays["cameras"], arrays["points"], arrays["obs_2d"][:ref.n_obs],
                     arrays["cam_idx"][:ref.n_obs][::-1], arrays["pt_idx"][:ref.n_obs][::-1],
                     pad_multiple=64, dtype=torch.float64)
    assert np.all(np.diff(p.cam_idx.numpy()) >= 0)
    assert p.cam_idx[-1] == p.cam_idx[ref.n_obs - 1] and p.pt_idx[-1] == p.pt_idx[ref.n_obs - 1]
    with pytest.raises(ValueError):
        problem_from_numpy(dict(arrays, cam_idx=arrays["cam_idx"][::-1]), n_cameras=6,
                           n_points=40, n_obs=ref.n_obs)


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    # torch's own error: AssertionError on a CPU-only build, RuntimeError
    # on a CUDA build with no card
    with pytest.raises((AssertionError, RuntimeError)):
        make_synthetic_problem(4, 10, device="cuda")


def test_f32_ladybug49_within_1pct_of_f64_golden(tmp_path, monkeypatch):
    """As tests/test_accuracy.py asserts for tpu_ba: the port's f32 solve
    (schur_pcg_pallas; the kernels' plain versions on the CPU) at the
    golden's config lands within 1% of the f64 golden."""
    with open(os.path.join(REPO, "data", "goldens", "ladybug-49.json")) as fh:
        golden = json.load(fh)
    monkeypatch.chdir(tmp_path)
    problem, _ = make_bal_like_problem("ladybug-49", dtype=torch.float32)
    cfg = LMConfig(max_iters=golden["max_iters"], cg_max_iters=golden["cg_max_iters"],
                   cg_tol=golden["cg_tol"], linear_solver="schur_pcg_pallas", init_lambda=1e-4)
    res = solve(problem, cfg)
    gap = abs(float(res.cost) - golden["final_cost"]) / golden["final_cost"]
    assert gap < 0.01, (float(res.cost), golden["final_cost"], gap)


def test_cli_ba_runs(capsys):
    from tpu_ba_torch.cli import main

    assert main(["ba", "--problem", "synthetic", "--max-iters", "3",
                 "--solver", "schur_pcg_pallas", "--robust", "huber"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iterations"] == 3 and out["final_cost"] < out["initial_cost"]
    assert out["solver"] == "schur_pcg_pallas" and out["device"] == "cpu"


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by tests/conftest.py)
    every module of the port imports without bringing in JAX."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu_ba.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
