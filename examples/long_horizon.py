"""Long-horizon MPC — the XLA tiers side by side (no reference
counterpart: the reference is fixed at NHORIZON=10, reference:
src/tinympc/glob_opts.hpp:7; its horizon sweeps are strictly sequential
loops, src/tinympc/admm.cpp:17,29).

Solves a batch of random stabilizable plants at a horizon of hundreds to
thousands of knots three ways and reports per-solve time on whatever device
JAX uses:

* ``scan``   — `lax.scan` sweeps (`solver/admm.py`), vmapped
* ``assoc``  — O(log N) associative-scan sweeps (`solver/assoc_scan.py`)
* ``block``  — block-condensed sweeps (`solver/block_condensed.py`): dense
  per-block operators under `lax.scan`, ``block``-times fewer sequential
  steps than the scan tier

then runs the block tier in adaptive mode (per-instance early exit) through
``TinyMPC(tier="block")``.

Run: python examples/long_horizon.py [--horizon 1024] [--batch 256]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver.assoc_scan import solve_assoc
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched, solve_batched,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()

    atm.utils.enable_compile_cache()
    print("device:", atm.utils.device_info())
    nx, nu, N = 8, 3, args.horizon
    B = args.batch
    problem, rho = random_lti_problem(seed=0, nx=nx, nu=nu, horizon=N)
    cache = riccati_cache(
        np.asarray(problem.A), np.asarray(problem.B),
        np.asarray(problem.Q), np.asarray(problem.R), rho,
    )
    rng = np.random.default_rng(1)
    x0s = jnp.asarray(rng.standard_normal((B, nx)) * 0.3, jnp.float32)
    settings = atm.Settings(max_iter=args.iters, check_termination=0)

    def timeit(fn, *fargs):
        out = jax.block_until_ready(fn(*fargs))
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(fn(*fargs))
            best = min(best, time.time() - t0)
        return out, best

    st = init_state_batched(B, nx, nu, N)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    f_scan = jax.jit(lambda s: solve_batched(s, problem, cache, settings))
    w, t_scan = timeit(f_scan, st)
    print(f"scan   tier: {t_scan/B*1e6:9.1f} us/solve "
          f"({B/t_scan:8.0f} solves/s)")

    f_assoc = jax.jit(jax.vmap(
        lambda s: solve_assoc(s, problem, cache, settings)))
    a, t_assoc = timeit(f_assoc, st)
    print(f"assoc  tier: {t_assoc/B*1e6:9.1f} us/solve "
          f"({B/t_assoc:8.0f} solves/s)")

    from accelerated_tinympc_tpu.solver.block_condensed import solve_block

    f_block = jax.jit(jax.vmap(
        lambda s: solve_block(s, problem, cache, settings, block=32)))
    b, t_block = timeit(f_block, st)
    err_b = float(jnp.max(jnp.abs(b.u - w.u)))
    print(f"block  tier: {t_block/B*1e6:9.1f} us/solve "
          f"({B/t_block:8.0f} solves/s)  vs-scan err {err_b:.1e}")

    assert err_b < 1e-4 * max(1.0, float(jnp.abs(w.u).max()))

    # Per-instance early termination (reference early exit,
    # admm.cpp:135-144) on the block tier, through the TinyMPC surface.
    m = atm.TinyMPC.from_parts(
        problem, cache, batch=B, tier="block", block=32,
        settings=atm.Settings(max_iter=args.iters, check_termination=5,
                              abs_pri_tol=1e-3, abs_dua_tol=1e-3),
    )
    m.set_x0(x0s)
    info = m.solve()
    it = info["iterations"]
    print(f"block tier (adaptive): iterations mean {it.mean():.1f}, "
          f"max {int(it.max())}, solved {info['solved'].mean():.0%}")


if __name__ == "__main__":
    main()
