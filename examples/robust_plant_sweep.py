"""Robust MPC under model uncertainty — one *distinct plant* per instance.

The reference binds exactly one plant per build (reference:
src/tinympc/tiny_wrapper.hpp:6, codegen.cpp:254-292 bake a single A/B); this
example inverts that with the per-instance-plant fleet: sample hundreds of
perturbed quadrotor models (parameter uncertainty), build every Riccati cache
*on device* (``TinyMPCFleet.setup``: vmapped fixed point + float64 polish),
solve all scenarios' MPC problems in one batched scan-tier dispatch per tick,
and take the consensus control. The closed loop then runs on a "true" plant
the controller never saw exactly.

Run: python examples/robust_plant_sweep.py [--scenarios 256] [--ticks 80]
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
from accelerated_tinympc_tpu.solver.batched import solve_batched


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=80)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--spread", type=float, default=0.03,
                    help="multiplicative plant perturbation scale")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()
    print("device:", atm.utils.device_info())

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    S = args.scenarios
    rng = np.random.default_rng(0)

    # Perturbed plant family: element-wise multiplicative noise on the
    # nominal dynamics (scenario 0 is the nominal plant itself).
    A0 = np.asarray(problem.A, np.float64)
    B0 = np.asarray(problem.B, np.float64)
    mulA = 1.0 + args.spread * rng.standard_normal((S, nx, nx))
    mulB = 1.0 + args.spread * rng.standard_normal((S, nx, nu))
    mulA[0] = 1.0
    mulB[0] = 1.0
    As = jnp.asarray(A0[None] * mulA, jnp.float32)
    Bs = jnp.asarray(B0[None] * mulB, jnp.float32)
    Qs = jnp.broadcast_to(problem.Q, (S, nx))
    Rs = jnp.broadcast_to(problem.R, (S, nu))

    # On-device build: S Riccati caches (vmapped fixed point + f64 polish).
    t0 = time.time()
    fleet = atm.TinyMPCFleet.setup(
        As, Bs, Qs, Rs, rho=float(cache.rho), horizon=N,
        u_min=problem.u_min[0], u_max=problem.u_max[0],
        x_min=problem.x_min[0], x_max=problem.x_max[0],
        settings=atm.Settings(max_iter=args.iters, check_termination=0),
    )
    fleet.set_xref(problem.Xref)
    jax.block_until_ready(fleet.cache.Kinf)
    print(f"{S} on-device cache builds: {time.time() - t0:.2f}s")
    state = fleet._carry

    @jax.jit
    def tick(state, x):
        # All scenarios share the measured state; duals reset per tick as in
        # the reference hover loop (quadrotor_hovering.cpp:88-90).
        st = atm.reset_duals(state)
        st = st.replace(x=st.x.at[:, 0, :].set(jnp.broadcast_to(x, (S, nx))))
        st = solve_batched(st, fleet.problem, fleet.cache, fleet.settings,
                           problem_axes=0, cache_axes=0)
        u = jnp.mean(st.u[:, 0, :], axis=0)       # consensus control
        spread = jnp.max(jnp.abs(st.u[:, 0, :] - u))
        return st, u, spread

    # "True" plant: a fresh perturbation outside the sampled family.
    true_mulA = 1.0 + args.spread * rng.standard_normal((nx, nx))
    true_mulB = 1.0 + args.spread * rng.standard_normal((nx, nu))
    At = jnp.asarray(A0 * true_mulA, jnp.float32)
    Bt = jnp.asarray(B0 * true_mulB, jnp.float32)

    x = jnp.asarray(x0, jnp.float32)
    err0 = float(jnp.linalg.norm(x - problem.Xref[1]))
    errs = []
    t0 = time.time()
    for k in range(args.ticks):
        state, u, spread = tick(state, x)
        x = At @ x + Bt @ u
        errs.append(float(jnp.linalg.norm(x - problem.Xref[1])))
        if k % 5 == 0 or k == args.ticks - 1:
            err = float(jnp.linalg.norm(x - problem.Xref[1]))
            print(f"tick {k:3d}  |x - xref| = {err:.4f}   "
                  f"u0 scenario spread = {float(spread):.4f}")
    wall = time.time() - t0
    err = float(jnp.linalg.norm(x - problem.Xref[1]))
    print(f"\nfinal tracking error on the unseen true plant: {err:.4f}")
    print(f"{args.ticks} ticks x {S} scenarios in {wall:.2f}s "
          f"({args.ticks * S / wall:.0f} scenario-solves/s)")
    # The loop has no integral action, so model mismatch leaves a constant
    # offset from the setpoint; stabilization means the error settles, well
    # below where it started.
    tail = np.asarray(errs[-20:])
    settled = tail.max() - tail.min() < 0.01 * tail.max() + 1e-6
    assert settled and err < 0.5 * err0, \
        "robust loop failed to stabilize the unseen plant"
    print(f"OK (settled offset {err:.4f} from model mismatch; started at "
          f"{err0:.4f})")


if __name__ == "__main__":
    main()
