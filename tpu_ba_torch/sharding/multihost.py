"""Process-group set-up of the sharded solve, and its scaling table.

Counterpart of ``tpu_ba/sharding/multihost.py``. One Python process per rank,
each launched with the same code and the same problem (same file, same
seed); ``init_distributed`` joins them into one ``torch.distributed`` process
group, after which ``make_mesh`` gives each its rank and device and
``solve_sharded`` runs unchanged.

Launch example (2 ranks):
    python -m tpu_ba_torch.cli ba --sharded --coordinator host0:9876 \\
        --num-processes 2 --process-id 0 ...
    python -m tpu_ba_torch.cli ba --sharded --coordinator host0:9876 \\
        --num-processes 2 --process-id 1 ...
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch

# how long a collective waits for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 600.0


def pick_backend(num_processes: int, device=None) -> str:
    """NCCL where every rank has a card of its own (this host has a card for
    each of the ranks), gloo on the CPU or where ranks share a card (NCCL
    refuses two ranks on one card)."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type == "cpu") or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, device=None) -> bool:
    """Initialize ``torch.distributed`` from the arguments or the reference's
    environment variables (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID),
    over TCP at ``coordinator`` (host:port), with ``pick_backend``'s backend
    for ranks on ``device`` (None: their cards). Returns True when a process
    group of several processes was initialized, False for a single process."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "-1") or -1)
    if not coordinator or num_processes <= 1:
        return False
    dist.init_process_group(pick_backend(num_processes, device),
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return True


def scaling_report(wall_s_by_world_size: dict[int, float]) -> dict:
    """Scaling-efficiency table against the smallest measured world size."""
    base_n = min(wall_s_by_world_size)
    base_t = wall_s_by_world_size[base_n]
    out = {}
    for n, t in sorted(wall_s_by_world_size.items()):
        ideal = base_t * base_n / n
        out[n] = {"wall_s": t, "speedup": base_t / t, "efficiency": ideal / t}
    return out
