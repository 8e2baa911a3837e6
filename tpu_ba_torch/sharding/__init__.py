"""The sharded solve over ``torch.distributed`` (one process per rank)."""

from tpu_ba_torch.sharding.distributed import (  # noqa: F401
    make_mesh,
    shard_problem,
    solve_sharded,
)
from tpu_ba_torch.sharding.multihost import init_distributed, scaling_report  # noqa: F401
