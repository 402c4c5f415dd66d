"""accelerated_tinympc_tpu: a batched convex-MPC engine in JAX.

A from-scratch JAX/XLA/Pallas reimagining of the capabilities of
ucb-bar/Accelerated-TinyMPC (TinyMPC v0.2.0): ADMM box-constrained LQR tracking
with an infinite-horizon Riccati cache — redesigned as batched,
functionally-pure solves (scan sweeps, dense condensed operators, a fused
whole-solve GPU kernel) scaling over device meshes.
"""

from .types import (  # noqa: F401
    SOLVED,
    UNSOLVED,
    Cache,
    Problem,
    Settings,
    State,
    init_state,
    reset_duals,
    set_x0,
)
from .precompute import (  # noqa: F401
    CondensedOperators,
    condensed_operators,
    riccati_cache,
    riccati_cache_jax,
)
from .solver import admm  # noqa: F401
from .solver.admm import solve  # noqa: F401
from . import models  # noqa: F401
from . import api, ops, parallel, utils  # noqa: F401
from .api import TinyMPC, TinyMPCFleet, mpc_rollout, tiny_codegen  # noqa: F401

__version__ = "0.1.0"
