"""On-device receding-horizon MPC rollout.

The reference's MPC loop is host-side: per tick it sets ``x.col(0)``, zeroes
duals, calls ``tiny_solve``, applies ``u.col(0)`` and steps the plant
(reference: examples/quadrotor_hovering.cpp:90-114, quadrotor_tracking.cpp:
93-117). At batched solve rates the host loop's dispatch overhead would
dominate, so here the *entire* K-tick loop runs as one ``lax.scan`` on device: dual
reset, solve (warm-started across ticks exactly like the reference's
persistent workspace), plant simulation, and the tracking variant's sliding
reference window (``dynamic_slice`` over the full trajectory — reference:
quadrotor_tracking.cpp:101).

Works single-instance or batched (scenario MPC: one plant, thousands of
perturbed instances) — state/x0 just carry a leading batch axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..solver import admm
from ..solver.batched import solve_batched
from ..types import Cache, Problem, Settings, State, init_state, reset_duals


class MPCTrace(NamedTuple):
    """Per-tick outputs of a rollout. ``x`` is the *plant* state at each tick
    (pre-solve measurement), ``u`` the applied first-knot control, matching
    what the reference examples print (quadrotor_hovering.cpp:92,110)."""

    x: jax.Array        # (T, [batch,] nx)
    u: jax.Array        # (T, [batch,] nu)
    iters: jax.Array    # (T, [batch]) int32
    status: jax.Array   # (T, [batch]) int32


def default_plant(problem: Problem) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """Nominal LTI plant x+ = A x + B u (reference:
    examples/quadrotor_hovering.cpp:110)."""

    def step(x, u):
        hi = jax.lax.Precision.HIGHEST
        return (
            jnp.matmul(x, problem.A.T, precision=hi)
            + jnp.matmul(u, problem.B.T, precision=hi)
        )

    return step


def mpc_rollout(
    problem: Problem,
    cache: Cache,
    settings: Settings,
    x0: jax.Array,
    n_ticks: int,
    *,
    Xref_total: jax.Array | None = None,
    state: State | None = None,
    plant: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    batched: bool = False,
    solver: Callable[[State, Problem], State] | None = None,
) -> tuple[State, jax.Array, MPCTrace]:
    """Run ``n_ticks`` of receding-horizon MPC fully on device.

    With ``Xref_total`` (shape ``(T >= n_ticks + N, nx)``) the horizon window
    slides each tick (tracking mode); otherwise ``problem.Xref`` is constant
    (hovering mode). Returns (final solver state, final plant state, trace).
    ``solver`` overrides the per-tick solve (``(state, problem) -> state``,
    scan-tier semantics) — e.g. the block-condensed long-horizon sweeps.

    Jit this whole call (it is pure); per-tick semantics match the reference
    loop exactly: duals reset, slacks/gains warm-started, *pre-projection*
    first-knot u applied to the plant.
    """
    N = problem.horizon
    nx, nu = problem.nx, problem.nu
    plant_step = plant or default_plant(problem)
    solver = solver or (
        (lambda s, p: solve_batched(s, p, cache, settings))
        if batched
        else (lambda s, p: admm.solve(s, p, cache, settings))
    )
    if state is None:
        state = init_state(nx, nu, N, problem.A.dtype)
        if batched:
            state = jax.tree.map(
                lambda a: jnp.broadcast_to(a, x0.shape[:-1] + a.shape), state
            )

    def tick(carry, k):
        st, x = carry
        prob = problem
        if Xref_total is not None:
            window = jax.lax.dynamic_slice_in_dim(Xref_total, k, N, axis=0)
            prob = prob.replace(Xref=window)
        st = reset_duals(st)
        st = st.replace(x=st.x.at[..., 0, :].set(x))
        st = solver(st, prob)
        u0 = st.u[..., 0, :]
        x_next = plant_step(x, u0)
        return (st, x_next), MPCTrace(x=x, u=u0, iters=st.iter, status=st.status)

    (state, x_final), trace = jax.lax.scan(
        tick, (state, x0), jnp.arange(n_ticks)
    )
    return state, x_final, trace


def tracking_error(trace: MPCTrace, Xref_total: jax.Array) -> jax.Array:
    """Per-tick L2 tracking error vs the reference trajectory — the metric the
    reference examples print each tick (quadrotor_tracking.cpp:95)."""
    T = trace.x.shape[0]
    ref = Xref_total[:T]
    if trace.x.ndim == 3:  # batched
        ref = ref[:, None, :]
    return jnp.linalg.norm(trace.x - ref, axis=-1)


def fused_mpc_rollout(
    pp,
    x0: jax.Array,
    n_ticks: int,
    *,
    problem: Problem,
    max_iter: int = 100,
    carry=None,
    interpret: bool = False,
    Xref_total: jax.Array | None = None,
    Pinf: jax.Array | None = None,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    alpha: float = 1.0,
):
    """Receding-horizon rollout on the fused kernel tier: ``n_ticks`` of
    (dual reset -> fused solve -> apply pre-projection u0 -> plant step)
    under one ``lax.scan`` — the scenario-MPC path for one shared plant.

    ``pp`` is a :class:`..ops.fused_admm.PaddedProblem`; ``x0`` is ``(B, nx)``.
    With ``Xref_total`` (and the cache's ``Pinf``) the horizon window slides
    each tick on device (tracking mode — the reference-dependent kernel
    operands are recomputed with :func:`..ops.fused_admm.ref_vectors`).
    Returns ``(x_final, u0_trace (n_ticks, B, nu), carry)`` with warm-start
    carries matching the reference tick protocol (duals reset, slacks kept —
    reference: examples/quadrotor_hovering.cpp:99-104).

    ``check_termination > 0`` runs each tick's solve in the adaptive
    freezing mode (checks every that many iterations at the given
    tolerances — the reference's own per-tick early exit,
    examples/quadrotor_hovering.cpp:73-78 + admm.cpp:135-144): warm-started
    ticks converge in a few iterations and each program's loop exits once
    all of its rows have converged.
    """
    from ..ops.fused_admm import (
        FusedCarry, fused_solve, ref_vectors, unpad_controls,
    )

    if carry is None:
        carry = FusedCarry.zeros(x0.shape[0], pp)
    if Xref_total is not None and Pinf is None:
        raise ValueError("tracking mode needs the cache Pinf for ref_vectors")
    N = problem.horizon
    plant_step = default_plant(problem)

    def tick(c, k):
        x, cy = c
        refs = {}
        if Xref_total is not None:
            window = jax.lax.dynamic_slice_in_dim(Xref_total, k, N, axis=0)
            xref_q, pterm_c = ref_vectors(pp, problem.Q, Pinf, window)
            refs = {"xref_q": xref_q, "pterm_c": pterm_c}
        res = fused_solve(
            x, cy.reset_duals(), pp, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            interpret=interpret, alpha=alpha, **refs,
        )
        u0 = unpad_controls(res, pp)
        return (plant_step(x, u0), res.carry), u0

    (x_final, carry), us = jax.lax.scan(
        tick, (x0, carry), jnp.arange(n_ticks)
    )
    return x_final, us, carry


def fleet_mpc_rollout(
    problem_b: Problem,
    cache_b: Cache,
    settings: Settings,
    x0s: jax.Array,
    n_ticks: int,
    *,
    state: State | None = None,
) -> tuple[State, jax.Array, MPCTrace]:
    """Receding-horizon rollout for a fleet with one plant per instance,
    fully on device: ``n_ticks`` of (dual reset -> scan-tier solve with
    per-instance plants -> apply u0 -> per-instance plant step) under one
    ``lax.scan`` — the scenario-MPC loop for one-distinct-plant-per-instance
    batches (the configuration the reference's one-problem-per-process
    design rules out, reference: src/tinympc/tiny_wrapper.hpp:6; tick
    protocol per examples/quadrotor_hovering.cpp:99-104).

    ``problem_b``/``cache_b`` are batch-leading pytrees (``TinyMPCFleet``'s
    ``problem``/``cache``); ``x0s (B, nx)``. ``settings.check_termination >
    0`` gives each tick the per-instance early exit. Returns
    ``(final state, x_final, trace)`` like :func:`mpc_rollout`.
    """
    hi = jax.lax.Precision.HIGHEST

    def plant(x, u):
        return (jnp.einsum("bij,bj->bi", problem_b.A, x, precision=hi)
                + jnp.einsum("bij,bj->bi", problem_b.B, u, precision=hi))

    def solver(s, p):
        return solve_batched(s, p, cache_b, settings,
                             problem_axes=0, cache_axes=0)

    return mpc_rollout(
        problem_b, cache_b, settings, x0s, n_ticks, state=state,
        plant=plant, batched=True, solver=solver,
    )
