"""Solver tiers: scan (ground truth), assoc (long-horizon), condensed (dense
operators), block-condensed, batched (vmap + masked early termination),
instance-ops (per-instance plants). The fused kernel tier lives in
ops/fused_admm.py."""

from . import admm  # noqa: F401
from .admm import admm_iteration, solve  # noqa: F401
from .adaptive_rho import AdaptiveRhoResult, solve_adaptive_rho  # noqa: F401
from .batched_ops import (  # noqa: F401
    AdaptiveRhoBatchedResult,
    InstanceOps,
    OpsState,
    build_instance_ops,
    build_instance_ops_from_plants,
    solve_adaptive_rho_batched,
    solve_adaptive_rho_chunked,
    solve_instance_ops,
)
from .adaptive_scan import solve_adaptive_rho_scan  # noqa: F401
from .assoc_scan import solve_assoc  # noqa: F401
from .block_condensed import (  # noqa: F401
    block_ops_batched,
    block_sweeps,
    solve_block,
    solve_block_batched,
)
from .cascade import cascade_solve  # noqa: F401
from .cones import (  # noqa: F401
    Cone,
    ConeSet,
    cone_slack_update,
    cone_violation,
    make_cone_args,
    project_cone,
    project_cone_masked,
)
from .batched import init_state_batched, solve_batched, batch_stats  # noqa: F401
from .condensed import (  # noqa: F401
    FlatState,
    flatten_problem,
    init_flat_state,
    solve_condensed,
)
