"""Hand-written GPU kernels: the fused whole-solve kernel (Pallas, Triton route)."""

from .fused_admm import (  # noqa: F401
    DEFAULT_BATCH_TILE,
    FusedCarry,
    FusedResult,
    PaddedProblem,
    fused_solve,
    pad_problem,
    ref_vectors,
    unpad_controls,
    unpad_states,
)
