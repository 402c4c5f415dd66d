"""Adaptive-rho demo (beyond the reference): rescue a badly scaled problem.

The reference bakes rho at build time (codegen.cpp:254-258); a rho four
orders of magnitude off leaves ADMM stalled. solve_adaptive_rho detects the
stall, rebalances rho OSQP-style, recomputes the Riccati cache on device,
and converges.

Run: python examples/adaptive_rho_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver import admm, solve_adaptive_rho


def main() -> None:
    atm.utils.enable_compile_cache()
    problem, _ = random_lti_problem(
        seed=3, nx=8, nu=3, horizon=15, bound=5.0, q_scale=100.0, r_scale=0.1
    )
    problem = problem.replace(
        u_min=jnp.full_like(problem.u_min, -0.3),
        u_max=jnp.full_like(problem.u_max, 0.3),
    )
    bad_rho = 1e-2
    cache = riccati_cache(
        np.asarray(problem.A), np.asarray(problem.B),
        np.asarray(problem.Q), np.asarray(problem.R), bad_rho,
    )
    rng = np.random.default_rng(0)
    st = atm.set_x0(
        atm.init_state(8, 3, 15),
        jnp.asarray(rng.standard_normal(8), jnp.float32),
    )
    settings = atm.Settings(abs_pri_tol=2e-3, abs_dua_tol=2e-3)

    fixed = jax.jit(admm.solve)(
        st, problem, cache, settings.replace(max_iter=1500, check_termination=1)
    )
    print(f"fixed rho={bad_rho}: "
          f"{'solved' if int(fixed.status) == 1 else 'FAILED'} "
          f"after {int(fixed.iter)} iterations")

    res = solve_adaptive_rho(st, problem, cache, settings, max_total_iter=1500)
    print(f"adaptive rho:   {'solved' if res.converged else 'failed'} "
          f"after {res.iterations} iterations; "
          f"rho path {[round(r, 3) for r in res.rho_history]}")


if __name__ == "__main__":
    main()
