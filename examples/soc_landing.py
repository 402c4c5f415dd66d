"""Powered-descent MPC with second-order-cone constraints.

A capability beyond the reference (box-only slack projection, reference:
src/tinympc/admm.cpp:45-61): a 3D point-mass lander tracks a touchdown at
the origin under two cones —

* thrust-tilt: ``||T_xy|| <= tan(theta) * T_z`` on the *total* thrust.
  Inputs are hover-relative (``u = T - (0,0,g)`` — the LTI deviation form
  absorbs constant gravity exactly), so this is the shifted cone
  ``||u_xy|| <= tan(theta) * (u_z + g)`` (``Cone.shift``).
* glideslope: ``||p_xy|| <= tan(phi) * (p_z + eps)`` (approach stays in a
  cone over the pad; the tiny apex shift keeps touchdown smooth).

The receding-horizon loop runs fully on device (`lax.scan` over ticks, plant
sim fused in) with cone projections inside the ADMM slack stage
(solver/cones.py).

``--fleet N`` instead solves a dispersion fleet of N landers in one batched
scan-tier dispatch with the SOC projections in every instance's slack stage
— the scenario-MPC shape: one call, every instance's thrust-tilt and
glideslope cones enforced.

``--fleet N --mission`` runs the whole receding-horizon descent of the
fleet as one device program (``mpc_rollout`` over the coned batched solve):
per-tick dual reset, coned adaptive solve, and plant step under one
``lax.scan``.

Run: python examples/soc_landing.py [--ticks 60] [--horizon 15] [--fleet 0]
     [--mission]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver import admm
from accelerated_tinympc_tpu.solver.cones import (
    Cone,
    ConeSet,
    cone_slack_update,
    cone_violation,
)


def landing_problem(horizon: int, dt: float = 0.1):
    I3 = np.eye(3)
    A = np.block([[I3, dt * I3], [0 * I3, I3]])
    B = np.vstack([0.5 * dt * dt * I3, dt * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    R = np.full(3, 1.0)
    problem = atm.Problem(
        A=jnp.asarray(A, jnp.float32),
        B=jnp.asarray(B, jnp.float32),
        Q=jnp.asarray(Q, jnp.float32),
        R=jnp.asarray(R, jnp.float32),
        u_min=jnp.full((horizon - 1, 3), -10.0, jnp.float32),
        u_max=jnp.full((horizon - 1, 3), 10.0, jnp.float32),
        x_min=jnp.full((horizon, 6), -100.0, jnp.float32),
        x_max=jnp.full((horizon, 6), 100.0, jnp.float32),
        Xref=jnp.zeros((horizon, 6), jnp.float32),
        Uref=jnp.zeros((horizon - 1, 3), jnp.float32),
    )
    cache = riccati_cache(A, B, Q, R, rho=1.0)
    return problem, cache


def _fleet_x0s(n: int):
    rng = np.random.default_rng(0)
    base = np.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0])
    return jnp.asarray(
        base[None] + rng.standard_normal((n, 6)) * 0.3, jnp.float32
    )


def fleet_solve(problem, cache, cones, n: int, iters: int) -> None:
    """Dispersion fleet: n perturbed landers, one batched coned solve."""
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )

    settings = atm.Settings(max_iter=iters, check_termination=2,
                            en_input_bound=False, en_state_bound=False)
    st = init_state_batched(n, 6, 3, problem.horizon)
    st = st.replace(x=st.x.at[:, 0, :].set(_fleet_x0s(n)))
    res = jax.jit(lambda s: solve_batched(
        s, problem, cache, settings, project=cone_slack_update(cones)))(st)
    tilt_v = float(cone_violation(res.znew, cones.input_cones[0]))
    solved = float(np.mean(np.asarray(res.status) == atm.SOLVED))
    it = np.asarray(res.iter)
    print(f"fleet {n}: solved {solved:.1%}  iters p50={np.median(it):.0f} "
          f"max={it.max():.0f}  worst slack tilt violation {tilt_v:.2e}")


def fleet_mission(problem, cache, cones, n: int, ticks: int,
                  iters: int) -> None:
    """Whole coned descent mission of an n-lander fleet as one device
    program (mpc_rollout over the coned batched solve)."""
    from accelerated_tinympc_tpu.api import mpc_rollout
    from accelerated_tinympc_tpu.solver.batched import solve_batched

    settings = atm.Settings(max_iter=iters, check_termination=2,
                            en_input_bound=False, en_state_bound=False)
    project = cone_slack_update(cones)
    st, xf, trace = jax.block_until_ready(jax.jit(lambda x: mpc_rollout(
        problem, cache, settings, x, ticks, batched=True,
        solver=lambda s, p: solve_batched(s, p, cache, settings,
                                          project=project),
    ))(_fleet_x0s(n)))
    tilt_v = float(cone_violation(trace.u, cones.input_cones[0]))
    slack_v = float(cone_violation(st.znew, cones.input_cones[0]))
    pos = np.linalg.norm(np.asarray(xf)[:, :3], axis=1)
    it = np.asarray(trace.iters)
    print(f"mission fleet {n} x {ticks} ticks (one program): "
          f"final |pos| p50={np.median(pos):.3f} max={pos.max():.3f}  "
          f"iters/tick p50={np.median(it):.0f}  "
          f"slack tilt violation {slack_v:.2e}  "
          f"applied-u (pre-projection) tilt violation {tilt_v:.2e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--fleet", type=int, default=0,
                    help="solve a fleet of this size in one batched dispatch")
    ap.add_argument("--mission", action="store_true",
                    help="with --fleet: whole receding-horizon descent as "
                         "one device program")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()

    problem, cache = landing_problem(args.horizon)
    g_hover = 3.0  # hover thrust in input units (gravity compensation)
    tilt = Cone(ball=(0, 1), axis=2, mu=1.0, shift=g_hover)  # theta = 45 deg
    glide = Cone(ball=(0, 1), axis=2, mu=2.0, shift=0.1)     # phi ~ 63 deg
    project = cone_slack_update(
        ConeSet(input_cones=(tilt,), state_cones=(glide,))
    )
    settings = atm.Settings(
        max_iter=args.iters, check_termination=1,
        en_input_bound=False, en_state_bound=False,
    )

    if args.fleet:
        cset = ConeSet(input_cones=(tilt,), state_cones=(glide,))
        if args.mission:
            fleet_mission(problem, cache, cset, args.fleet, args.ticks,
                          min(args.iters, 100))
        else:
            fleet_solve(problem, cache, cset, args.fleet, args.iters)
        return

    x0 = jnp.asarray([3.0, -2.0, 6.0, 1.0, 0.5, -1.0], jnp.float32)

    def tick(carry, _):
        state, x = carry
        state = atm.set_x0(atm.reset_duals(state), x)
        state = admm.solve(state, problem, cache, settings, project=project)
        u0 = state.u[0]
        x_next = problem.A @ x + problem.B @ u0
        return (state, x_next), (x, u0, state.iter)

    @jax.jit
    def rollout(x0):
        init = (atm.init_state(6, 3, args.horizon), x0)
        _, (xs, us, iters) = jax.lax.scan(
            tick, init, None, length=args.ticks
        )
        return xs, us, iters

    xs, us, iters = jax.block_until_ready(rollout(x0))
    tilt_v = float(cone_violation(us, tilt))
    glide_v = float(cone_violation(xs[1:], glide))
    print(f"final |pos| = {float(jnp.linalg.norm(xs[-1, :3])):.4f}  "
          f"|vel| = {float(jnp.linalg.norm(xs[-1, 3:])):.4f}")
    print(f"worst thrust-tilt violation over flight: {tilt_v:.2e}")
    print(f"worst glideslope violation (post-x0):    {glide_v:.2e}")
    print(f"ADMM iterations per tick: mean {float(jnp.mean(iters)):.0f} "
          f"max {int(jnp.max(iters))}")
    ok = (
        float(jnp.linalg.norm(xs[-1, :3])) < 0.2
        and tilt_v < 5e-3 and glide_v < 5e-2
    )
    print("LANDED inside both cones" if ok else "CHECK FAILED")


if __name__ == "__main__":
    main()
