"""Serialization, profiling, and observability utilities."""

from .serialization import (  # noqa: F401
    load_like,
    load_problem_cache,
    save_problem_cache,
    save_pytree,
)
from .profiling import (  # noqa: F401
    PEAKS,
    device_info,
    peaks,
    require_gpu,
    solver_cost,
    time_fn,
    trace,
)
from .compile_cache import enable_compile_cache  # noqa: F401
from .debugging import debug_nans, finite_state, health_report  # noqa: F401
