"""Checkpoint and resume in the port: its safetensors codec against the
``safetensors`` package, checkpoints crossing between ``tpu_ba`` and the
port, chunked and killed-and-resumed solves against the uninterrupted one
(bit for bit), against ``tpu_ba``'s own chunked and resumed solves, and the
NaN guard.

The cross-package solves run on the synthetic ring of ``test_torch_lm.py``
at λ₀ = 10, where the CG counts do not hinge on rounding: iteration and CG
counts are held exactly and the histories and parameters to 1e-8, as there.
"""

import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load as st_load
from safetensors.numpy import save as st_save

from tpu_ba.checkpoint import load_checkpoint as ref_load_checkpoint
from tpu_ba.checkpoint import save_checkpoint as ref_save_checkpoint
from tpu_ba.core import LMConfig as RefLMConfig
from tpu_ba.core import make_problem as ref_make_problem
from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba.solver.lm import solve as ref_solve
from tpu_ba_torch.checkpoint import load_checkpoint, save_checkpoint
from tpu_ba_torch.checkpoint.state import safetensors_arrays, safetensors_bytes
from tpu_ba_torch.core import LMConfig, make_problem, problem_from_numpy
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.solver.lm import solve

torch.set_num_threads(1)

FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")
RESULT_FIELDS = ("cameras", "points", "cost", "initial_cost", "lam", "nu", "warm_dxc", "gnorm0",
                 "iterations", "accepted", "converged", "grad_inf_norm", "cost_history",
                 "lam_history", "cg_history")
CFG = dict(max_iters=8, init_lambda=10.0, linear_solver="schur_pcg")
RNG = np.random.default_rng(3)
ARRAYS = {
    "F32": RNG.standard_normal((5, 9)).astype(np.float32),
    "F64": RNG.standard_normal((7, 3)),
    "I32": RNG.integers(-9, 9, 11).astype(np.int32),
    "0-d": np.asarray(2.5),
}


@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_safetensors_codec_matches_the_package(kind):
    """The port writes the package's bytes, and each reads the other's."""
    # contiguous: the package writes a strided view's buffer, not its values
    tensors = {"cameras": ARRAYS[kind], "points": ARRAYS["F32"][:2, :3].copy(),
               "extra.k": np.arange(4, dtype=np.int64), "extra.b": np.array([True, False])}
    ours = safetensors_bytes(tensors)
    assert ours == st_save(tensors)
    for got in (st_load(ours), safetensors_arrays(st_save(tensors))):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)
    # torch tensors are copied to the host
    assert safetensors_bytes({"x": torch.from_numpy(ARRAYS[kind])}) == st_save({"x": ARRAYS[kind]})
    with pytest.raises(ValueError):
        safetensors_arrays(ours[:-3])
    with pytest.raises(TypeError):
        safetensors_bytes({"x": np.zeros(2, np.float16)})


def _state(rng, dtype):
    return dict(cameras=rng.standard_normal((6, 9)).astype(dtype),
                points=rng.standard_normal((20, 3)).astype(dtype), lam=0.125, iteration=7,
                cost=41.5, extra={"nu": np.asarray(4.0), "gnorm0": np.asarray(3.25),
                                  "warm_dxc": rng.standard_normal((6, 9)).astype(dtype),
                                  "note": "resumable"})


@pytest.mark.parametrize("writer", ["tpu_ba", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    state = _state(np.random.default_rng(5), np.float32)
    save = ref_save_checkpoint if writer == "tpu_ba" else save_checkpoint
    if writer == "port":          # tensors, as the solver passes them
        state = dict(state, cameras=torch.from_numpy(state["cameras"]))
    save(str(tmp_path), **state)
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "state.safetensors"]
    a, b = ref_load_checkpoint(str(tmp_path)), load_checkpoint(str(tmp_path))
    assert a.keys() == b.keys()
    for k in a:
        if k == "extra_tensors":
            assert a[k].keys() == b[k].keys() == {"nu", "gnorm0", "warm_dxc"}
            for e in a[k]:
                assert a[k][e].dtype == b[k][e].dtype
                np.testing.assert_array_equal(a[k][e], b[k][e])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    assert b["extra.note"] == "resumable" and b["format_version"] == 1
    np.testing.assert_array_equal(b["cameras"], np.asarray(state["cameras"]))


def _assert_equal(res, want, fields=RESULT_FIELDS):
    for f in fields:
        assert torch.equal(getattr(res, f), getattr(want, f)), f


@pytest.mark.parametrize("tier", ["schur_pcg_pallas", "schur_sparse_pallas"])
def test_chunked_and_resumed_solves_are_the_uninterrupted_one(tmp_path, tier):
    """Chunks of 3 (boundaries inside runs of rejected retries too), and a
    run killed at 5 and resumed to 12: the uninterrupted solve's bits."""
    p, _ = make_synthetic_problem(10, 100, obs_per_point=4, seed=11, dtype=torch.float64,
                                  device="cpu")
    cfg = dict(max_iters=12, linear_solver=tier)
    full = solve(p, LMConfig(**cfg))
    assert int(full.accepted) < int(full.iterations) == 12       # rejected retries in the run
    ck = str(tmp_path / "ck")
    _assert_equal(solve(p, LMConfig(checkpoint_every=3, checkpoint_path=ck, **cfg)), full)
    assert load_checkpoint(ck)["iteration"] == 12
    killed = solve(p, LMConfig(**dict(cfg, max_iters=5), checkpoint_every=2,
                               checkpoint_path=ck))
    assert int(killed.iterations) == load_checkpoint(ck)["iteration"] == 5
    res = solve(p, LMConfig(**cfg), resume_from=ck)
    _assert_equal(res, full, ("cameras", "points", "cost", "lam", "nu", "warm_dxc", "gnorm0",
                              "iterations", "converged", "grad_inf_norm"))
    for f in ("cost_history", "lam_history", "cg_history"):
        assert torch.equal(getattr(res, f)[5:], getattr(full, f)[5:]), f
    with pytest.raises(ValueError, match="not both"):
        solve(p, LMConfig(**cfg), resume_from=ck, init_state=(1.0, 2.0, 0))


@pytest.fixture(scope="module")
def problems():
    ref, _ = ref_synthetic(10, 100, obs_per_point=4, seed=11, dtype=np.float64)
    port = problem_from_numpy({k: np.asarray(getattr(ref, k)) for k in FIELDS}, n_cameras=10,
                              n_points=100, n_obs=ref.n_obs, dtype=torch.float64, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def ref_full(problems):
    return ref_solve(problems[0], RefLMConfig(**CFG))


KILLED = dict(CFG, max_iters=4, checkpoint_every=2)


@pytest.fixture(scope="module")
def ref_killed(problems, tmp_path_factory):
    """tpu_ba's solve killed at 4 in chunks of 2, and its checkpoint."""
    ck = str(tmp_path_factory.mktemp("tpu_ba") / "ck")
    return ref_solve(problems[0], RefLMConfig(checkpoint_path=ck, **KILLED)), ck


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_run(res, ref, since=0):
    """``res`` (either package's) is ``ref``'s run from iteration ``since``."""
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_array_equal(_np(res.cg_history)[since:], _np(ref.cg_history)[since:])
    for f in ("cost_history", "lam_history"):
        np.testing.assert_allclose(_np(getattr(res, f))[since:], _np(getattr(ref, f))[since:],
                                   rtol=1e-8)
    for f in ("cost", "lam", "nu"):
        np.testing.assert_allclose(float(getattr(res, f)), float(getattr(ref, f)), rtol=1e-8)
    for f in ("cameras", "points"):
        np.testing.assert_allclose(_np(getattr(res, f)), _np(getattr(ref, f)), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("writer", ["tpu_ba", "port"])
def test_chunked_killed_and_resumed_solves_match_the_reference(problems, ref_full, ref_killed,
                                                               tmp_path, writer):
    """The port runs tpu_ba's solve killed at 4 in chunks of 2, dumping
    after each: the two runs agree, and so do their checkpoints. Then both
    packages resume from the checkpoint that ``writer`` wrote and run to 8:
    each lands on tpu_ba's uninterrupted run."""
    ref_p, p = problems
    ref, ref_ck = ref_killed
    port_ck = str(tmp_path / "ck")
    res = solve(p, LMConfig(checkpoint_path=port_ck, **KILLED))
    _assert_same_run(res, ref)
    assert int(res.accepted) == int(ref.accepted)
    a, b = ref_load_checkpoint(ref_ck), load_checkpoint(port_ck)
    assert a["iteration"] == b["iteration"] == 4
    assert a["extra_tensors"].keys() == b["extra_tensors"].keys()
    for k in ("cameras", "points"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-8, atol=1e-10)
    ck = ref_ck if writer == "tpu_ba" else port_ck
    _assert_same_run(solve(p, LMConfig(**CFG), resume_from=ck), ref_full, since=4)
    _assert_same_run(ref_solve(ref_p, RefLMConfig(**CFG), resume_from=ck), ref_full, since=4)


def test_nan_guard_reports_like_the_reference(capfd):
    """The degenerate problem of tests/test_cli_and_aux.py (every point at
    a camera centre): the same printed lines as tpu_ba and a finite cost."""
    cams = np.zeros((2, 9))
    cams[:, 6] = 100.0
    args = (cams, np.zeros((4, 3)), np.ones((4, 2)), np.array([0, 0, 1, 1], np.int32),
            np.array([0, 1, 2, 3], np.int32))
    kw = dict(max_iters=3, linear_solver="schur_pcg", nan_guard=True, cg_max_iters=10,
              cg_tol=1e-3)
    capfd.readouterr()
    ref = ref_solve(ref_make_problem(*args, pad_multiple=8, dtype=np.float64), RefLMConfig(**kw))
    ref_out = capfd.readouterr().out
    res = solve(make_problem(*args, pad_multiple=8, dtype=torch.float64, device="cpu"),
                LMConfig(**kw))
    assert capfd.readouterr().out == ref_out
    assert np.isfinite(float(res.cost))
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-12)
    assert int(res.iterations) == int(ref.iterations)
