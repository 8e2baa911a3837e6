"""Run a function on several ranks from one process: the sharded solve's
ranks as fresh processes on this machine.

    results = run_ranks(2, solve_jobs, (jobs,), device="cpu")

``run_ranks`` spawns one process per rank (``torch.multiprocessing``), joins
them into one process group over a file store in a temporary directory, and
returns each rank's return value in rank order. The function must be
importable by the spawned processes: a module-level function of a module
whose import does not import JAX (this one, or a script's own ``__main__``).
On the card the kernels are built here first, so the ranks do not run nvcc
together.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

RESULT_FIELDS = ("cameras", "points", "cost", "initial_cost", "lam", "iterations", "accepted",
                 "grad_inf_norm", "converged", "cost_history", "lam_history", "cg_history",
                 "nu", "warm_dxc", "gnorm0")


def _rank_main(rank, world, backend, device, threads, tmp, fn, args):
    import torch.distributed as dist

    from tpu_ba_torch.sharding.distributed import make_mesh
    from tpu_ba_torch.sharding.multihost import COLLECTIVE_TIMEOUT_S

    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(make_mesh(device=device), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, args=(), *, backend: str | None = None, device=None,
              threads: int | None = None) -> list:
    """``fn(mesh, *args)`` on each of ``world`` spawned ranks; their return
    values (picklable) in rank order. ``backend`` defaults to
    ``multihost.pick_backend``'s; ``device`` is each rank's (None: its card);
    ``threads`` sets each rank's torch CPU threads. A rank that raises makes
    this raise, and the other ranks are stopped; a collective that waits
    longer than ``multihost.COLLECTIVE_TIMEOUT_S`` fails."""
    import torch.multiprocessing as mp

    from tpu_ba_torch.sharding.multihost import pick_backend

    if device is None or torch.device(device).type == "cuda":
        from tpu_ba_torch.kernels import _lib

        _lib.load_library()
    backend = backend or pick_backend(world, device)
    with tempfile.TemporaryDirectory(prefix="tpu_ba_ranks_") as tmp:
        mp.spawn(_rank_main, args=(world, backend, device, threads, tmp, fn, args),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def solve_jobs(mesh, jobs: list) -> list:
    """A rank's part of several sharded solves, for ``run_ranks``. A job is a
    dict: ``problem``, the (arrays, meta) of ``problem_arrays``; ``config``,
    LMConfig's fields; optional ``resume_from``, a checkpoint to start from;
    optional ``save``, a directory rank 0 writes the result to as a
    checkpoint before the ranks go on together. Each solve runs with the
    kernels' launch counts, the host reads and the collectives counted from 0
    just before it and read just after. Returns per job the result's fields
    as numpy, those counts, and the solve's seconds (ended by a synchronize
    on the card)."""
    import torch.distributed as dist

    from tpu_ba_torch.core import LMConfig, problem_from_numpy
    from tpu_ba_torch.kernels import _lib
    from tpu_ba_torch.sharding.distributed import solve_sharded
    from tpu_ba_torch.solver import collective, pcg
    from tpu_ba_torch.solver.lm import save_result

    out = []
    for job in jobs:
        arrays, meta = job["problem"]
        problem = problem_from_numpy(
            arrays, n_cameras=meta["n_cameras"], n_points=meta["n_points"], n_obs=meta["n_obs"],
            model=meta["model"], device=mesh.device, dtype=getattr(torch, meta["dtype"]))
        cfg = LMConfig(**job["config"])
        _lib.reset_launches()
        pcg.reset_host_reads()
        collective.reset_counts()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        res = solve_sharded(problem, cfg, mesh, resume_from=job.get("resume_from"))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
        counts = dict(launches=dict(_lib.launches), host_reads=dict(pcg.host_reads),
                      collectives=dict(collective.counts))
        if job.get("save"):
            if mesh.rank == 0:
                save_result(job["save"], res)
            if mesh.pg is not None:
                dist.barrier(group=mesh.pg)
        fields = {k: getattr(res, k).detach().cpu().numpy() for k in RESULT_FIELDS}
        out.append(dict(fields, **counts, seconds=seconds, rank=mesh.rank, world=mesh.world,
                        backend=mesh.backend, device=str(mesh.device)))
    return out


def problem_arrays(problem) -> tuple[dict, dict]:
    """(arrays, meta) of a port BAProblem for ``solve_jobs``."""
    from tpu_ba_torch.core import problem_to_numpy

    d = problem_to_numpy(problem)
    arrays = {k: d.pop(k) for k in ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")}
    d["dtype"] = str(arrays["cameras"].dtype)
    if d["dtype"] not in ("float32", "float64"):
        raise ValueError(f"the problem's dtype {d['dtype']}: float32 or float64")
    return {k: np.ascontiguousarray(v) for k, v in arrays.items()}, d
