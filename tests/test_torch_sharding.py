"""The sharded solve of the port (``tpu_ba_torch.sharding``) against the
reference's (``tpu_ba.sharding``) on the CPU.

The reference runs one process over a 2-device mesh of the forced 8-device
CPU platform (tests/conftest.py); the port runs two processes, one a rank,
joined over gloo with a file store (``sharding.launch.run_ranks``). The ranks
are spawned once for the whole module (``ranks``, ~4 s to start, then the
solves) and import no JAX; the reference and the port's single-device solves
run here. Bounds are the reference's own (tests/test_sharding.py):
``schur_pcg`` cost 1e-6, parameters rtol 1e-4 / atol 1e-6; ``schur_sparse``
with the track layout engaged cost 1e-9, cameras rtol 1e-6 / atol 1e-8;
``schur_sparse_pallas`` (the kernels' plain versions here) in f32 cost 1e-5,
cameras rtol 1e-2 / atol 1e-3."""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from tpu_ba.core import LMConfig as RefLMConfig
from tpu_ba.io.synthetic import make_synthetic_problem as ref_synthetic
from tpu_ba.sharding import make_mesh as ref_make_mesh
from tpu_ba.sharding import scaling_report as ref_scaling_report
from tpu_ba.sharding import shard_problem as ref_shard_problem
from tpu_ba.sharding import solve_sharded as ref_solve_sharded
from tpu_ba.solver import pairs as ref_pairs
from tpu_ba.solver.tracks import shard_stack_track_layout
from tpu_ba_torch.core import LMConfig, problem_from_numpy
from tpu_ba_torch.sharding import init_distributed, scaling_report, shard_problem, solve_sharded
from tpu_ba_torch.sharding.distributed import Mesh
from tpu_ba_torch.sharding.launch import problem_arrays, run_ranks, solve_jobs
from tpu_ba_torch.solver import pairs as port_pairs
from tpu_ba_torch.solver import tracks as port_tracks
from tpu_ba_torch.solver.lm import solve

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")
CPU = torch.device("cpu")


def _ref_problem(n_cams, n_pts, obs_per_point, seed, dtype):
    return ref_synthetic(n_cams, n_pts, obs_per_point=obs_per_point, pixel_noise=0.5, seed=seed,
                         dtype=dtype, pad_multiple=128)[0]


def _port(ref, dtype):
    return problem_from_numpy({k: np.asarray(getattr(ref, k)) for k in FIELDS},
                              n_cameras=ref.cameras.shape[0], n_points=ref.points.shape[0],
                              n_obs=ref.n_obs, dtype=dtype, device="cpu")


def _mesh(rank, world):
    return Mesh(pg=None, rank=rank, world=world, device=CPU, backend="gloo")


# (reference problem args, torch dtype, config): the reference's own cases
CASES = {
    "schur_pcg": ((12, 120, 5, 0, np.float64), torch.float64,
                  dict(max_iters=12, linear_solver="schur_pcg", cg_max_iters=300, cg_tol=1e-12)),
    "schur_sparse_tracks": ((16, 400, 6, 7, np.float64), torch.float64,
                            dict(max_iters=8, linear_solver="schur_sparse", cg_max_iters=300,
                                 cg_tol=1e-12)),
    "schur_sparse_pallas": ((12, 120, 5, 4, np.float32), torch.float32,
                            dict(max_iters=8, linear_solver="schur_sparse_pallas",
                                 cg_max_iters=100, cg_tol=1e-6)),
}
RESUME_CFG = dict(max_iters=8, linear_solver="schur_sparse", cg_max_iters=300, cg_tol=1e-12)


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, (args, dtype, _) in CASES.items():
        ref = _ref_problem(*args)
        out[name] = (ref, _port(ref, dtype))
    return out


@pytest.fixture(scope="module")
def solved(problems, tmp_path_factory):
    """(ranks, references): one spawn of two gloo ranks for every sharded
    solve of this module (the three cases, then the resume case: 8 iterations
    uninterrupted; 4 iterations, written by rank 0; resumed from it to 8),
    run while the reference's sharded solves compile and run here."""
    ck = str(tmp_path_factory.mktemp("sharded") / "ck")
    jobs = [dict(problem=problem_arrays(problems[name][1]), config=cfg)
            for name, (_, _, cfg) in CASES.items()]
    tracks = problem_arrays(problems["schur_sparse_tracks"][1])
    jobs += [dict(problem=tracks, config=RESUME_CFG),
             dict(problem=tracks, config=dict(RESUME_CFG, max_iters=4), save=ck),
             dict(problem=tracks, config=RESUME_CFG, resume_from=ck)]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 2, solve_jobs, (jobs,), device="cpu", threads=1)
        mesh = ref_make_mesh(jax.devices()[:2])
        refs = {}
        for name, (_, _, cfg) in CASES.items():
            ref = problems[name][0]
            res = ref_solve_sharded(ref_shard_problem(ref, mesh), RefLMConfig(**cfg), mesh)
            refs[name] = {k: np.asarray(getattr(res, k))
                          for k in ("cost", "cameras", "points", "iterations")}
        return ranks.result(), refs


@pytest.fixture(scope="module")
def ranks(solved):
    return solved[0]


def _equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in
               ("cameras", "points", "cost", "iterations", "cg_history", "cost_history", "lam"))


@pytest.mark.parametrize("world", [2, 4])
def test_shard_problem_matches_reference(world):
    """Each rank's observation arrays are the reference's sharded arrays cut
    by device, exactly: the padding to world × 128, edge-mode indices, mask."""
    ref = _ref_problem(12, 120, 5, 0, np.float64)
    ref_sh = ref_shard_problem(ref, ref_make_mesh(jax.devices()[:world]))
    port = _port(ref, torch.float64)
    n = np.asarray(ref_sh.obs_2d).shape[0] // world
    assert n % 128 == 0 and n * world > ref.n_obs
    for rank in range(world):
        sh = shard_problem(port, _mesh(rank, world))
        for k in ("obs_2d", "cam_idx", "pt_idx", "mask"):
            want = np.asarray(getattr(ref_sh, k))[rank * n:(rank + 1) * n]
            got = getattr(sh, k).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), (k, rank)
        for k in ("cameras", "points"):
            assert np.array_equal(getattr(sh, k).numpy(), np.asarray(getattr(ref, k)))


@pytest.mark.parametrize("world", [2, 4])
def test_shard_track_layout_and_pair_plan_match_reference(problems, world):
    """Each rank's part of the track layout equals the reference's stacked
    layout at that rank, array for array; its ``key_start`` is the CSR of its
    real columns' keys; its pair arrays are the rank's slice of the global
    seg-sorted pairs, with a K7 schedule over the global k_pad."""
    ref, port = problems["schur_sparse_tracks"]
    kw = dict(symmetric=True, tracks=True, slots=False, pad_multiple=2048)
    ref_plan = ref_pairs.build_pair_plan(ref.cam_idx, ref.pt_idx, ref.n_obs,
                                         ref.cameras.shape[0], ref.points.shape[0], **kw)
    assert ref_plan.track is not None, "the track layout must engage on this problem"
    stacked = shard_stack_track_layout(ref_plan.track, world, with_kernel_plans=False)
    plan = port_pairs.build_pair_plan(port.cam_idx, port.pt_idx, port.n_obs, port.n_cameras,
                                      port.n_points, with_kernel_plans=True, **kw)
    n = plan.n_pairs // world
    for rank in range(world):
        part = port_pairs.shard_pair_plan(plan, world, rank, with_kernel_plans=True)
        tl = part.track
        for k in port_tracks.TRACK_ARRAYS:
            want = np.asarray(getattr(stacked, k))[rank]
            assert np.array_equal(getattr(tl, k).numpy(), want), (k, rank)
        keys = tl.keys.numpy()[:tl.n_tracked]
        assert np.array_equal(tl.key_start.numpy(),
                              np.searchsorted(keys, np.arange(tl.n_out + 1), side="left"))
        for k in port_pairs.SHARD_PAIR_ARRAYS:
            assert np.array_equal(getattr(part, k).numpy(),
                                  getattr(plan, k).numpy()[rank * n:(rank + 1) * n]), k
        seg = part.pair_seg.numpy()[(part.pair_key.numpy() < plan.n_cameras ** 2)]
        assert np.array_equal(part.seg_start.numpy(),
                              np.searchsorted(seg, np.arange(plan.k_pad + 1), side="left"))
        assert part.shard == (rank, world) and part.n_pairs == n
    with pytest.raises(ValueError, match="not divisible"):
        port_pairs.shard_pair_plan(plan, 3, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_reference_and_single_device(problems, solved, case):
    """Two gloo ranks against the reference's solve_sharded on a 2-device
    mesh and against the port's single-device solve, within the reference's
    bounds; every rank's result equal to every other's, bit for bit."""
    ranks, refs = solved
    _, port = problems[case]
    _, dtype, cfg = CASES[case]
    i = list(CASES).index(case)
    r0, r1 = ranks[0][i], ranks[1][i]
    assert _equal(r0, r1)
    single = solve(port, LMConfig(**cfg))
    if case == "schur_pcg":
        tol = dict(cost=1e-6, rtol=1e-4, atol=1e-6, points=True)
    elif case == "schur_sparse_tracks":
        tol = dict(cost=1e-9, rtol=1e-6, atol=1e-8, points=False)
    else:
        tol = dict(cost=1e-5, rtol=1e-2, atol=1e-3, points=False)
    for name, other in (("reference", refs[case]),
                        ("single-device", {k: getattr(single, k).numpy() for k in
                                           ("cost", "cameras", "points", "iterations")})):
        np.testing.assert_allclose(float(r0["cost"]), float(other["cost"]), rtol=tol["cost"],
                                   err_msg=name)
        np.testing.assert_allclose(r0["cameras"], other["cameras"], rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=name)
        if tol["points"]:
            np.testing.assert_allclose(r0["points"], other["points"], rtol=tol["rtol"],
                                       atol=tol["atol"], err_msg=name)
        assert int(r0["iterations"]) == int(other["iterations"]), name
    assert r0["collectives"]["all_reduce"] > 0 and r0["world"] == 2


def test_sparse_sharded_runs_the_kernel_plans_plain_and_gathers_w(ranks):
    """The sparse tiers all-gather W once per linearization and the pallas
    tier's blocks go through the rank's K7 schedule (plain on the CPU: no
    launch); the host-loop tiers read one flag a CG iteration, checked across
    ranks."""
    pcg_job, sparse_job, pallas_job = (ranks[0][i] for i in range(3))
    assert pcg_job["collectives"]["all_gather"] == 0
    for job in (sparse_job, pallas_job):
        assert 0 < job["collectives"]["all_gather"] <= job["iterations"]
    assert all(v == 0 for v in pallas_job["launches"].values())
    assert pcg_job["host_reads"]["cg"] > 0


def test_sharded_resume_equals_uninterrupted(ranks):
    """A sharded solve resumed from a checkpoint written at iteration 4
    equals the uninterrupted sharded solve bit for bit, on both ranks."""
    n = len(CASES)
    for rank in (0, 1):
        full, part, resumed = ranks[rank][n:n + 3]
        assert int(part["iterations"]) == 4
        assert int(resumed["iterations"]) == int(full["iterations"]) == 8
        for k in ("cameras", "points", "cost", "lam", "nu", "warm_dxc"):
            assert np.array_equal(resumed[k], full[k]), (k, rank)


@pytest.mark.parametrize("tier", ["dense", "schur_dense", "schur_dense_pallas"])
def test_sharded_dense_tiers_raise(problems, tier):
    _, port = problems["schur_sparse_tracks"]
    with pytest.raises(ValueError, match="no sharded path"):
        solve_sharded(port, LMConfig(linear_solver=tier, max_iters=2), _mesh(0, 2))


def test_sharded_sparse_solve_refuses_a_whole_plan(problems):
    """Given the whole pair plan under a group of two, the sparse solve
    raises: every rank would add the whole plan's blocks and the all-reduce
    would double them (the reference's warning in _pairplan_specs)."""
    _, port = problems["schur_sparse_tracks"]
    plan = port_pairs.build_pair_plan(port.cam_idx, port.pt_idx, port.n_obs, port.n_cameras,
                                      port.n_points, symmetric=True)
    with pytest.raises(ValueError, match="shard_pair_plan"):
        port_pairs.solve_schur_sparse(None, None, plan, group=_mesh(0, 2), cg_max_iters=1,
                                      cg_tol=1e-3, diag_floor=1e-6, diag_ceil=1e32)


def test_init_distributed_without_coordinator_and_scaling_report(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed("127.0.0.1:1", 1, 0) is False
    walls = {1: 10.0, 2: 6.0, 4: 3.5}
    assert scaling_report(walls) == ref_scaling_report(walls)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_ba_sharded_two_processes(tmp_path):
    """``cli.py ba --sharded`` as two processes on the CPU (one a rank, over
    TCP at 127.0.0.1), f64: rank 0 prints one JSON line, whose digest check
    says both ranks ended with the same bits, and whose final cost equals the
    unsharded command line's to 1e-9; rank 1 prints none. The counterpart of
    tests/test_multiprocess.py, at the command line's CG defaults (50
    iterations at 1e-2), where the two ended 1e-11 apart on the CPU (with CG
    300 at 1e-12 they ended 9e-9 apart: ladybug-49 at λ₀ = 1e-4 amplifies
    the reduction order through the longer CG)."""
    common = [sys.executable, "-m", "tpu_ba_torch.cli", "ba", "--problem", "ladybug-49",
              "--solver", "schur_sparse", "--max-iters", "4", "--dtype", "float64",
              "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(common + ["--sharded", "--coordinator", addr, "--num-processes",
                                        "2", "--process-id", str(i)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    single = subprocess.run(common, cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=240)
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert single.returncode == 0, single.stderr[-3000:]
    lead = [json.loads(line) for line in outs[0][0].splitlines() if line.startswith("{")]
    assert len(lead) == 1 and not outs[1][0].strip()
    want = json.loads(single.stdout.strip().splitlines()[-1])
    got = lead[0]
    assert got["ranks"] == 2 and got["ranks_equal"] is True
    assert got["iterations"] == want["iterations"] == 4
    np.testing.assert_allclose(got["final_cost"], want["final_cost"], rtol=1e-9)


def test_mesh_of_one_without_a_process_group():
    """Without torch.distributed a mesh is a group of one on the named
    device, and a sharded solve there is the single-device solve."""
    from tpu_ba_torch.sharding import make_mesh

    mesh = make_mesh(device="cpu")
    assert (mesh.pg, mesh.rank, mesh.world, mesh.device) == (None, 0, 1, CPU)
    ref = _ref_problem(12, 120, 5, 0, np.float64)
    port = _port(ref, torch.float64)
    cfg = LMConfig(max_iters=4, linear_solver="schur_pcg", cg_max_iters=300, cg_tol=1e-12)
    a, b = solve_sharded(port, cfg, mesh), solve(port, cfg)
    assert torch.equal(a.cameras, b.cameras) and torch.equal(a.cost, b.cost)
