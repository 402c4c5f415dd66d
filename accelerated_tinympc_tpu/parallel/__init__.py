"""Multi-device/multi-host scaling over device meshes."""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    initialize_distributed,
    make_batch_mesh,
    replicate,
    shard_batch,
    sharded_fused_solve,
    sharded_solve,
    summarize_stats,
)
