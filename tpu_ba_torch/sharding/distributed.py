"""Distributed bundle adjustment over ``torch.distributed``, one process a rank.

Counterpart of ``tpu_ba/sharding/distributed.py``, the reference's
"keyframe-partitioned" distributed BA:

  * **Observations are sharded** by rank. Observations are sorted by camera
    (``core.make_problem``), so equal contiguous shards are contiguous camera
    ranges: each rank owns the observations of a run of cameras.
  * **Camera and point state is replicated**: every rank holds the whole
    parameters and runs the replicated part of the LM loop (CG, accept or
    reject, λ) itself.
  * Communication (``solver/collective.py``): the cost and the
    linearization's U, V, g all-reduced once per linearization and W
    all-gathered once (pair indices are global observation ids); the
    ``schur_sparse*`` tiers all-reduce the compact blocks once per λ-retry
    and run their CG with none; ``schur_pcg*`` all-reduce twice per CG
    iteration.

The reference runs one process over a mesh of devices (``shard_map``); the
port runs one process per rank, each with a device of its own
(``make_mesh``), so nothing is stacked: each rank builds its own plans
(``build_sharded_plans``). The solver body is ``solver.lm.lm_loop`` with
``group`` set.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_ba_torch.core import BAProblem, LMConfig, LMResult, _round_up
from tpu_ba_torch.solver.lm import (SPARSE_TIERS, _memoized, _resume_state, _solve_chunked,
                                    _structure_key, check_config, lm_loop)
from tpu_ba_torch.solver.pairs import build_pair_plan, shard_pair_plan
from tpu_ba_torch.solver.plans import build_plans

OBS_ARRAYS = ("obs_2d", "cam_idx", "pt_idx", "mask")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the sharded solve: its process group (None for a
    group of one), rank, world size, the group's backend and the rank's
    device."""

    pg: object
    rank: int
    world: int
    device: torch.device
    backend: str | None = None


def make_mesh(group=None, device=None) -> Mesh:
    """This process's place in the sharded solve: rank and size of ``group``
    (default: the default process group where ``torch.distributed`` is
    initialized, else a group of one), and its device: ``device`` if given
    (``"cpu"`` for the CPU), else the card ``cuda:{rank % device_count}``,
    made the current device. Without a card and without ``device`` it raises,
    as every entry point of the port does."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        pg = group if group is not None else dist.group.WORLD
        rank, world, backend = dist.get_rank(pg), dist.get_world_size(pg), dist.get_backend(pg)
    else:
        pg, rank, world, backend = None, 0, 1, None
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("tpu_ba_torch runs on a CUDA card by default and "
                               "torch.cuda.is_available() is false; pass device=\"cpu\"")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(pg=pg, rank=rank, world=world, device=dev, backend=backend)


def pad_problem(problem: BAProblem, n_ranks: int) -> BAProblem:
    """The problem with its observation axis padded to a multiple of
    ``n_ranks`` × 128, as the reference's ``shard_problem`` pads it: index
    padding repeats the LAST index (edge mode, so the camera-sorted order and
    every rank's sorted keys hold), observations are zeros and ``mask`` is
    False on the padding."""
    O = problem.obs_2d.shape[0]
    pad = _round_up(O, n_ranks * 128) - O
    if not pad:
        return problem

    def edge(t):
        return torch.cat([t, t[-1:].expand(pad)])

    return dataclasses.replace(
        problem, obs_2d=torch.cat([problem.obs_2d, problem.obs_2d.new_zeros((pad, 2))]),
        cam_idx=edge(problem.cam_idx), pt_idx=edge(problem.pt_idx),
        mask=torch.cat([problem.mask, problem.mask.new_zeros(pad)]))


def _rank_slice(padded: BAProblem, mesh: Mesh) -> BAProblem:
    n = padded.obs_2d.shape[0] // mesh.world
    lo = mesh.rank * n
    return dataclasses.replace(padded, **{k: getattr(padded, k)[lo:lo + n].contiguous()
                                          for k in OBS_ARRAYS})


def _to_device(problem: BAProblem, device) -> BAProblem:
    return dataclasses.replace(problem, **{
        k: getattr(problem, k).to(device) for k in ("cameras", "points") + OBS_ARRAYS})


def shard_problem(problem: BAProblem, mesh: Mesh) -> BAProblem:
    """This rank's shard of ``problem`` on the rank's device: the contiguous
    slice of the padded (``pad_problem``) observation arrays, cameras and
    points replicated; the counts stay the whole problem's."""
    return _rank_slice(pad_problem(_to_device(problem, mesh.device), mesh.world), mesh)


def build_sharded_plans(padded: BAProblem, shard: BAProblem, config: LMConfig, mesh: Mesh):
    """(assembly plans, pair plan) of this rank, each None where the tier
    uses none, memoized per structure, world size and rank (the reference's
    ``build_sharded_plans`` and sharded pair plan, unstacked). The
    ``*_pallas`` tiers, and every tier on the card (as ``build_solver_plans``
    gives them), get ``build_plans`` over the shard's camera-sorted keys:
    CSR starts over all cameras, so K2 writes exact zeros for the cameras
    with no observation in the shard. The sparse tiers get the rank's
    part (``shard_pair_plan``) of a plan built from the whole padded problem
    as the reference builds it: symmetric, tracks on, slots off,
    ``pad_multiple = max(2048, world)``."""
    tier = config.linear_solver
    C, P = padded.cameras.shape[0], padded.points.shape[0]
    where = (mesh.world, mesh.rank)
    plans = pairs = None
    segment_plans = tier.endswith("_pallas") or mesh.device.type == "cuda"
    if segment_plans or tier in SPARSE_TIERS:
        structure = _structure_key(padded)
    if segment_plans:
        plans = _memoized(("assembly-sharded",) + where + structure,
                          lambda: build_plans(shard.cam_idx, shard.pt_idx, C, P))
    if tier in SPARSE_TIERS:
        kernels = tier == "schur_sparse_pallas"

        def build():
            whole = build_pair_plan(padded.cam_idx, padded.pt_idx, padded.n_obs, C, P,
                                    symmetric=True, tracks=True, slots=False,
                                    pad_multiple=max(2048, mesh.world),
                                    with_kernel_plans=kernels)
            return shard_pair_plan(whole, mesh.world, mesh.rank, with_kernel_plans=kernels)

        pairs = _memoized((f"pairs-sharded-{kernels}",) + where + structure, build)
    return plans, pairs


def solve_sharded(problem: BAProblem, config: LMConfig | None = None, mesh: Mesh | None = None,
                  resume_from: str | None = None) -> LMResult:
    """Distributed LM bundle adjustment: call it on every rank of ``mesh``
    (default ``make_mesh()``) with the same whole ``problem`` (the same file
    or seed on every rank). Each rank keeps its shard (``shard_problem``),
    builds its plans and runs ``lm_loop`` with ``group=mesh``; every rank
    returns the same result, bit for bit. ``resume_from`` restores a
    checkpoint's parameters and trust-region state (λ, ν, iteration,
    warm-start step, g₀) as ``solve`` does; ``checkpoint_every`` and
    ``nan_guard`` run it in chunks, rank 0 writing the checkpoints. ``dense``
    and ``schur_dense*`` raise: they have no sharded path."""
    if config is None:
        config = LMConfig()
    if problem.model == "pinhole":
        config = dataclasses.replace(
            config, freeze_camera_cols=tuple(sorted(set(config.freeze_camera_cols) | {6, 7, 8})))
    elif problem.model != "bal":
        raise ValueError(f"solve_sharded() handles the 'bal' and 'pinhole' models; got "
                         f"{problem.model!r}")
    check_config(config)
    if mesh is None:
        mesh = make_mesh()
    problem = _to_device(problem, mesh.device)
    init_state = None
    if resume_from:
        problem, init_state = _resume_state(problem, resume_from)
    padded = pad_problem(problem, mesh.world)
    shard = _rank_slice(padded, mesh)
    plans, pairs = build_sharded_plans(padded, shard, config, mesh)
    chunk = config.checkpoint_every if config.checkpoint_every > 0 else (
        8 if config.nan_guard else 0)
    if chunk > 0:
        return _solve_chunked(shard, config, plans, pairs, init_state, chunk, group=mesh)
    return lm_loop(shard.cameras, shard.points, shard.obs_2d, shard.cam_idx, shard.pt_idx,
                   shard.mask, shard.cameras.shape[0], shard.points.shape[0], config,
                   plans=plans, init_state=init_state, pairs=pairs, group=mesh)
