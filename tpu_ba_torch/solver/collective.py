"""The collectives of the sharded solve, over ``torch.distributed``.

Counterpart of the ``jax.lax.psum`` / ``all_gather`` calls that the
reference's solver makes under ``axis_name``. ``group`` is the mesh of
``tpu_ba_torch.sharding.make_mesh`` (its process group ``pg``, ``rank``,
``world`` size, ``backend`` and ``device``), or None for a solve on one
device; with None or a world of one every function here returns its input.

Every rank runs the replicated part of the LM loop on its own, so the ranks
stay in step only while that part gives the same bits everywhere: the sums
below come back equal on every rank (one reduction, then shared), and
``agree`` holds the host-read flags of the LM and CG loops equal across
ranks, raising where they are not, before a rank could take another branch
and wait for a collective that never comes.
"""

from __future__ import annotations

import torch

# collectives since the last reset, and the bytes each rank contributed
counts = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _active(group) -> bool:
    return group is not None and group.world > 1


def all_reduce(t, group):
    """The sum of ``t`` over the ranks (a contiguous copy, summed in place)."""
    if not _active(group):
        return t
    import torch.distributed as dist

    t = t.contiguous()
    dist.all_reduce(t, group=group.pg)
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def all_reduce_many(tensors, group):
    """The sums of several tensors of one dtype in one collective."""
    if not _active(group):
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [p.reshape(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]),
                                                tensors)]


def all_gather_cols(t, group):
    """Every rank's ``t`` (equal shapes) side by side along the last axis, in
    rank order (``all_gather``, which gloo takes on CUDA tensors too: checked
    with torch 2.11 on an H100)."""
    if not _active(group):
        return t
    import torch.distributed as dist

    counts["all_gather"] += 1
    counts["all_gather_bytes"] += t.numel() * t.element_size()
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t.contiguous(), group=group.pg)
    return torch.cat(parts, dim=-1)


def agree(flags, group) -> list[bool]:
    """``flags`` (a 1-D bool tensor) read to the host, checked equal on every
    rank: their sum over the ranks must be 0 or the world size."""
    if not _active(group):
        return [bool(v) for v in flags.tolist()]
    n_set = all_reduce(flags.to(torch.int32), group).tolist()
    if any(c not in (0, group.world) for c in n_set):
        raise RuntimeError(f"the ranks of the sharded solve disagree on the loop's flags: "
                           f"{n_set} of {group.world} ranks set each; the replicated part "
                           f"of the solve did not give the same bits on every rank")
    return [c == group.world for c in n_set]
