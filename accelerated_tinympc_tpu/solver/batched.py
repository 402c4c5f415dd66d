"""Batched ADMM solves with per-instance early termination.

The reference binds one solver to one problem per process (global
``tiny_data_solver`` — reference: src/tinympc/tiny_wrapper.hpp:6); the scaling
story here is the opposite: a leading batch axis over thousands of problem
instances in every kernel (SURVEY.md §2 "Parallelism strategies").

Early termination under a batch is the subtle part (SURVEY.md §7 "hard parts"):
per-instance convergence diverges, and naive ``vmap`` of a ``while_loop`` keeps
*advancing* already-converged instances, destroying the reference's exact
semantics (an instance's result must be identical to its single solve —
reference: src/tinympc/admm.cpp:135-144 exits without the trailing slack-save +
backward pass). We therefore run one shared loop and *freeze* converged
instances with a tree-wide select, looping until every instance converged or hit
``max_iter``.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..types import SOLVED, UNSOLVED, Cache, Problem, Settings, State, init_state
from .admm import admm_iteration

# in_axes trees for shared-vs-batched problem/cache.
SHARED = None
BATCHED = 0


def init_state_batched(
    batch: int, nx: int, nu: int, horizon: int, dtype: Any = jnp.float32
) -> State:
    """Cold-start batched state: batch axis leading on every leaf."""
    single = init_state(nx, nu, horizon, dtype)
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), single
    )


def _freeze(done: jax.Array, frozen: State, live: State) -> State:
    """Tree-wide select: keep ``frozen`` leaves where ``done`` (per-instance)."""

    def sel(a, b):
        mask = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
        return jnp.where(mask, a, b)

    return jax.tree.map(sel, frozen, live)


def solve_batched(
    state: State,
    problem: Problem,
    cache: Cache,
    settings: Settings,
    *,
    problem_axes=SHARED,
    cache_axes=SHARED,
    project=None,
    forward=None,
    backward=None,
) -> State:
    """Solve a batch of instances; each instance's trajectory through the ADMM
    loop is identical to its standalone :func:`..solver.admm.solve`.

    ``problem_axes``/``cache_axes`` select shared (``None``) or per-instance
    (``0``) problem data — shared is the "10k perturbed scenarios, one plant"
    configuration; batched is the random-plant sweep. ``project`` overrides
    the slack projection per :func:`..solver.admm.admm_iteration` (the
    second-order-cone extension, :mod:`.cones`).

    With ``check_termination == 0`` this is a fixed-iteration ``fori_loop``
    over the whole batch (deterministic benchmarking mode).
    """
    iterate = jax.vmap(
        lambda s, p, c: admm_iteration(
            s, p, c, settings, project=project,
            forward=forward, backward=backward,
        ),
        in_axes=(0, problem_axes, cache_axes),
    )

    batch = state.iter.shape[0]
    state = state.replace(
        status=jnp.full((batch,), UNSOLVED, state.status.dtype),
        iter=jnp.zeros((batch,), state.iter.dtype),
    )

    if settings.check_termination <= 0:
        return jax.lax.fori_loop(
            0,
            settings.max_iter,
            lambda _, s: iterate(s, problem, cache),
            state,
        )

    def body(s: State) -> State:
        done = s.status == SOLVED
        return _freeze(done, s, iterate(s, problem, cache))

    def cond(s: State) -> jax.Array:
        return jnp.any((s.iter < settings.max_iter) & (s.status != SOLVED))

    return jax.lax.while_loop(cond, body, state)


def batch_stats(state: State, settings: Settings) -> dict[str, jax.Array]:
    """Structured per-batch solve metrics (the observability the reference
    lacks — SURVEY.md §5 metrics; residual/iter fields per reference
    src/tinympc/types.hpp:76-81)."""
    converged = state.status == SOLVED
    return {
        "converged_fraction": jnp.mean(converged.astype(jnp.float32)),
        "iterations_mean": jnp.mean(state.iter.astype(jnp.float32)),
        "iterations_max": jnp.max(state.iter),
        "primal_residual_state_max": jnp.max(state.primal_residual_state),
        "primal_residual_input_max": jnp.max(state.primal_residual_input),
        "dual_residual_state_max": jnp.max(state.dual_residual_state),
        "dual_residual_input_max": jnp.max(state.dual_residual_input),
    }
